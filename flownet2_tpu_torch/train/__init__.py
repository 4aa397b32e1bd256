"""Training: optimizers by name, the LR schedule and the train/eval steps."""

from .optim import LRSchedule, get_optimizer  # noqa: F401
from .state import StepFactory  # noqa: F401
