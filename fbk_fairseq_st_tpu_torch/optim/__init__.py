from .lr_schedulers import LR_SCHEDULERS, InverseSquareRootSchedule, LRScheduler, build_lr_scheduler
from .optimizers import OPTIMIZERS, build_optimizer, set_lr

__all__ = ["LR_SCHEDULERS", "OPTIMIZERS", "InverseSquareRootSchedule", "LRScheduler", "build_lr_scheduler",
           "build_optimizer", "set_lr"]
