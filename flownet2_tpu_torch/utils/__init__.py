"""Device resolution and run tooling: timers, metric logging, progress,
TensorBoard event files."""

from .device import resolve_device  # noqa: F401
from .tensorboard import SummaryWriter  # noqa: F401
from .tools import (  # noqa: F401
    IteratorTimer,
    MetricLogger,
    TimerBlock,
    format_dictionary_of_losses,
    gpumemusage,
    progress,
)
