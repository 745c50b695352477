from .lr_schedulers import InverseSquareRootSchedule, build_lr_scheduler
from .optimizers import build_optimizer, set_lr

__all__ = ["InverseSquareRootSchedule", "build_lr_scheduler", "build_optimizer", "set_lr"]
