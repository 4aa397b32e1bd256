"""Training: optimizers by name, the LR schedule, the train/eval steps and
the epoch loop."""

from .optim import (OPTIMIZERS, LRSchedule, get_optimizer,  # noqa: F401
                    optimizer_param_defaults)
from .state import StepFactory  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
