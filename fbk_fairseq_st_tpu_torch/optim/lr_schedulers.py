"""Learning-rate schedulers.

The port's copy of ``fbk_fairseq_st_tpu/optim/lr_schedulers.py`` (reference
fairseq/optim/lr_scheduler/), plain Python on the host:
``step_update(num_updates) -> lr`` before every update and ``step(epoch,
val_loss) -> lr`` at each epoch's end; ``state_dict`` / ``load_state_dict``
carry ``best`` and ``lr`` (and ReduceLROnPlateau's bad-epoch count) through
a checkpoint. The trainer hands the lr to the optimiser as a host float,
so no change of it waits for the card. The schedulers keep their state
on themselves and leave ``args`` as it was parsed.
"""

from __future__ import annotations

import math
from typing import List, Optional


class LRScheduler:
    def __init__(self, args):
        self.args = args
        self.best: Optional[float] = None

    @classmethod
    def add_args(cls, parser) -> None:
        pass

    @classmethod
    def build_lr_scheduler(cls, args) -> "LRScheduler":
        return cls(args)

    def state_dict(self):
        return {"best": self.best, "lr": getattr(self, "lr", None)}

    def load_state_dict(self, state_dict):
        self.best = state_dict.get("best")
        if state_dict.get("lr") is not None:
            self.lr = state_dict["lr"]

    def step(self, epoch: int, val_loss: Optional[float] = None) -> float:
        if val_loss is not None:
            if self.best is None:
                self.best = val_loss
            else:
                self.best = min(self.best, val_loss)
        return self.lr

    def step_update(self, num_updates: int) -> float:
        return self.lr


def _lr_list(args) -> List[float]:
    lr = args.lr
    if isinstance(lr, (int, float)):
        return [float(lr)]
    return [float(x) for x in lr]


class FixedSchedule(LRScheduler):
    """fairseq/optim/lr_scheduler/fixed_schedule.py: per-epoch lr list,
    optional forced annealing by lr_shrink, linear warmup factor."""

    def __init__(self, args):
        super().__init__(args)
        self.lrs = _lr_list(args)
        self.lr = self.lrs[0]
        self.warmup_factor = 1.0
        if getattr(args, "warmup_updates", 0) > 0:
            self.warmup_factor = 1.0 / args.warmup_updates

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--force-anneal", "--fa", type=int, metavar="N",
                            help="force annealing at specified epoch")
        parser.add_argument("--lr-shrink", default=0.1, type=float, metavar="LS",
                            help="shrink factor for annealing, lr_new = (lr * lr_shrink)")
        parser.add_argument("--warmup-updates", default=0, type=int, metavar="N",
                            help="warmup the learning rate linearly for the first N updates")

    def get_next_lr(self, epoch: int) -> float:
        force_anneal = getattr(self.args, "force_anneal", None)
        if force_anneal is None or epoch < force_anneal:
            next_lr = self.lrs[min(epoch, len(self.lrs) - 1)]
        else:
            next_lr = self.lrs[-1] * self.args.lr_shrink ** (epoch + 1 - force_anneal)
        return next_lr

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        self.lr = self.get_next_lr(epoch)
        return self.warmup_factor * self.lr

    def step_update(self, num_updates):
        warmup = getattr(self.args, "warmup_updates", 0)
        if warmup > 0 and num_updates < warmup:
            self.warmup_factor = (num_updates + 1) / float(warmup)
        else:
            self.warmup_factor = 1.0
        return self.warmup_factor * self.lr


class InverseSquareRootSchedule(LRScheduler):
    """Linear warmup from ``warmup_init_lr`` to ``lr`` over
    ``warmup_updates``, then ``lr * sqrt(warmup_updates / num_updates)``
    (fairseq/optim/lr_scheduler/inverse_square_root_schedule.py, the
    schedule of every FBK ST recipe). A negative ``warmup_init_lr`` means 0
    when there is warmup (the first update's lr is 0 and changes no weight)
    and ``lr`` otherwise."""

    def __init__(self, args):
        super().__init__(args)
        lrs = _lr_list(args)
        if len(lrs) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with inverse_sqrt."
                " Consider --lr-scheduler=fixed instead."
            )
        warmup_end_lr = lrs[0]
        self.warmup_updates = getattr(args, "warmup_updates", 4000)
        self.warmup_init_lr = getattr(args, "warmup_init_lr", -1)
        if self.warmup_init_lr < 0:
            self.warmup_init_lr = 0 if self.warmup_updates > 0 else warmup_end_lr
        self.lr_step = (warmup_end_lr - self.warmup_init_lr) / self.warmup_updates
        self.decay_factor = warmup_end_lr * self.warmup_updates ** 0.5
        self.lr = self.warmup_init_lr

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--warmup-updates", default=4000, type=int, metavar="N",
                            help="warmup the learning rate linearly for the first N updates")
        parser.add_argument("--warmup-init-lr", default=-1, type=float, metavar="LR",
                            help="initial learning rate during warmup phase; default is args.lr")

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.lr

    def step_update(self, num_updates):
        if num_updates < self.warmup_updates:
            self.lr = self.warmup_init_lr + num_updates * self.lr_step
        else:
            self.lr = self.decay_factor * num_updates ** -0.5
        return self.lr


class CosineSchedule(LRScheduler):
    """fairseq/optim/lr_scheduler/cosine_lr_scheduler.py (SGDR)."""

    def __init__(self, args):
        super().__init__(args)
        lrs = _lr_list(args)
        warmup_end_lr = args.max_lr
        self.warmup_init_lr = args.warmup_init_lr if args.warmup_init_lr >= 0 else lrs[0]
        self.min_lr = lrs[0]
        self.max_lr = args.max_lr
        assert self.max_lr > self.min_lr, "max_lr must be more than lr"
        self.t_mult = args.t_mult
        self.period = args.lr_period_updates
        if self.period <= 0:
            # the reference's check is `max_update >= 0`, which lets the
            # default 0 through into a division by zero at step time;
            # the intent is clearly a positive period
            assert args.max_update > 0, (
                "Either --max-update or --lr-period-updates must be set"
            )
            self.period = args.max_update - args.warmup_updates
        if args.warmup_updates > 0:
            self.lr_step = (warmup_end_lr - self.warmup_init_lr) / args.warmup_updates
        else:
            self.lr_step = 1.0
        self.warmup_updates = args.warmup_updates
        self.lr_shrink = args.lr_shrink
        self.lr = self.warmup_init_lr

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--warmup-updates", default=0, type=int, metavar="N")
        parser.add_argument("--warmup-init-lr", default=-1, type=float, metavar="LR")
        parser.add_argument("--max-lr", type=float, metavar="LR",
                            help="max learning rate, must be more than args.lr")
        parser.add_argument("--t-mult", default=1, type=float, metavar="LR",
                            help="factor to grow the length of each period")
        parser.add_argument("--lr-period-updates", default=-1, type=float, metavar="LR",
                            help="initial number of updates per period")
        parser.add_argument("--lr-shrink", default=0.1, type=float, metavar="LS",
                            help="shrink factor for annealing")

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.lr

    def step_update(self, num_updates):
        if num_updates < self.warmup_updates:
            self.lr = self.warmup_init_lr + num_updates * self.lr_step
        else:
            curr_updates = num_updates - self.warmup_updates
            if self.t_mult != 1:
                i = math.floor(
                    math.log(
                        1 - curr_updates / self.period * (1 - self.t_mult), self.t_mult
                    )
                )
                t_i = self.t_mult ** i * self.period
                t_curr = (
                    curr_updates
                    - (1 - self.t_mult ** i) / (1 - self.t_mult) * self.period
                )
            else:
                i = math.floor(curr_updates / self.period)
                t_i = self.period
                t_curr = curr_updates - (self.period * i)
            lr_shrink = self.lr_shrink ** i
            min_lr = self.min_lr * lr_shrink
            max_lr = self.max_lr * lr_shrink
            self.lr = min_lr + 0.5 * (max_lr - min_lr) * (
                1 + math.cos(math.pi * t_curr / t_i)
            )
        return self.lr


class PolynomialDecaySchedule(LRScheduler):
    """fairseq/optim/lr_scheduler/polynomial_decay_schedule.py."""

    def __init__(self, args):
        super().__init__(args)
        lrs = _lr_list(args)
        self.peak_lr = lrs[0]
        if args.warmup_updates > 0:
            self.warmup_factor = 1.0 / args.warmup_updates
        else:
            self.warmup_factor = 1.0
        self.end_learning_rate = args.end_learning_rate
        self.total_num_update = args.total_num_update
        self.power = args.power
        self.lr = self.warmup_factor * self.peak_lr

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--force-anneal", "--fa", type=int, metavar="N")
        parser.add_argument("--warmup-updates", default=0, type=int, metavar="N")
        parser.add_argument("--end-learning-rate", default=0.0, type=float)
        parser.add_argument("--power", default=1.0, type=float)
        parser.add_argument("--total-num-update", default=1000000, type=int)

    def get_next_lr(self, epoch):
        force_anneal = getattr(self.args, "force_anneal", None)
        lrs = _lr_list(self.args)
        if force_anneal is None or epoch < force_anneal:
            next_lr = lrs[min(epoch, len(lrs) - 1)]
        else:
            next_lr = self.lr
        return next_lr

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        self.peak_lr = self.get_next_lr(epoch)
        return self.warmup_factor * self.peak_lr

    def step_update(self, num_updates):
        if (
            self.args.warmup_updates > 0
            and num_updates <= self.args.warmup_updates
        ):
            self.warmup_factor = num_updates / float(self.args.warmup_updates)
            lr = self.warmup_factor * self.peak_lr
        elif num_updates >= self.total_num_update:
            lr = self.end_learning_rate
        else:
            warmup = self.args.warmup_updates
            lr_range = self.peak_lr - self.end_learning_rate
            pct_remaining = 1 - (num_updates - warmup) / (
                self.total_num_update - warmup
            )
            lr = lr_range * pct_remaining ** self.power + self.end_learning_rate
        self.lr = lr
        return self.lr


class ReduceLROnPlateau(LRScheduler):
    """fairseq/optim/lr_scheduler/reduce_lr_on_plateau.py."""

    def __init__(self, args):
        super().__init__(args)
        self.lr = _lr_list(args)[0]
        self.patience = getattr(args, "lr_patience", 0)
        self.shrink = args.lr_shrink
        self.threshold = getattr(args, "lr_threshold", 1e-4)
        self.num_bad_epochs = 0
        warmup = getattr(args, "warmup_updates", 0)
        self.warmup_updates = warmup
        if warmup > 0 and args.warmup_init_lr >= 0:
            self.warmup_init_lr = args.warmup_init_lr
            self.lr_step = (self.lr - args.warmup_init_lr) / warmup
        else:
            self.warmup_init_lr = self.lr
            self.lr_step = 0.0

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--lr-shrink", default=0.1, type=float, metavar="LS",
                            help="shrink factor for annealing")
        parser.add_argument("--lr-threshold", default=1e-4, type=float, metavar="LT")
        parser.add_argument("--lr-patience", default=0, type=int)
        parser.add_argument("--warmup-updates", default=0, type=int, metavar="N")
        parser.add_argument("--warmup-init-lr", default=-1, type=float, metavar="LR")

    def state_dict(self):
        return {
            "best": self.best,
            "lr": self.lr,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self.num_bad_epochs = state_dict.get("num_bad_epochs", 0)

    def step(self, epoch, val_loss=None):
        if val_loss is not None:
            if self.best is None or val_loss < self.best - self.threshold:
                self.best = val_loss if self.best is None else min(self.best, val_loss)
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
                if self.num_bad_epochs > self.patience:
                    self.lr = self.lr * self.shrink
                    self.num_bad_epochs = 0
        return self.lr

    def step_update(self, num_updates):
        if self.warmup_updates > 0 and num_updates <= self.warmup_updates:
            return self.warmup_init_lr + num_updates * self.lr_step
        return self.lr


class TriStageLRSchedule(LRScheduler):
    """fairseq/optim/lr_scheduler/tri_stage_lr_scheduler.py: warmup -> hold
    -> exponential decay -> floor."""

    def __init__(self, args):
        super().__init__(args)
        lrs = _lr_list(args)
        if len(lrs) > 1:
            raise ValueError("Cannot use a fixed learning rate schedule with tri-stage lr.")
        self.peak_lr = lrs[0]
        self.init_lr = args.init_lr_scale * lrs[0]
        self.final_lr = args.final_lr_scale * lrs[0]
        self.warmup_steps = args.warmup_steps
        self.hold_steps = args.hold_steps
        self.decay_steps = args.decay_steps
        self.warmup_rate = (
            (self.peak_lr - self.init_lr) / self.warmup_steps
            if self.warmup_steps
            else 0.0
        )
        self.decay_factor = -math.log(args.final_lr_scale) / args.decay_steps
        self.lr = self.init_lr

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--warmup-steps", default=4000, type=int, metavar="N")
        parser.add_argument("--hold-steps", default=20000, type=int, metavar="N")
        parser.add_argument("--decay-steps", default=60000, type=int, metavar="N")
        parser.add_argument("--init-lr-scale", default=0.01, type=float)
        parser.add_argument("--final-lr-scale", default=0.01, type=float)

    def _decide_stage(self, update_step):
        if update_step < self.warmup_steps:
            return 0, update_step
        offset = self.warmup_steps
        if update_step < offset + self.hold_steps:
            return 1, update_step - offset
        offset += self.hold_steps
        if update_step <= offset + self.decay_steps:
            return 2, update_step - offset
        offset += self.decay_steps
        return 3, update_step - offset

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.lr

    def step_update(self, num_updates):
        stage, steps_in_stage = self._decide_stage(num_updates)
        if stage == 0:
            self.lr = self.init_lr + self.warmup_rate * steps_in_stage
        elif stage == 1:
            self.lr = self.peak_lr
        elif stage == 2:
            self.lr = self.peak_lr * math.exp(-self.decay_factor * steps_in_stage)
        else:
            self.lr = self.final_lr
        return self.lr


class TriangularSchedule(LRScheduler):
    """fairseq/optim/lr_scheduler/triangular_lr_scheduler.py (CLR)."""

    def __init__(self, args):
        super().__init__(args)
        lrs = _lr_list(args)
        self.min_lr = lrs[0]
        self.max_lr = args.max_lr
        assert self.max_lr > self.min_lr, "max_lr must be more than lr"
        self.stepsize = args.lr_period_updates // 2
        self.lr_shrink = args.lr_shrink
        self.shrink_min = args.shrink_min
        self.lr = self.min_lr

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--max-lr", required=True, type=float, metavar="LR")
        parser.add_argument("--lr-period-updates", default=5000, type=float, metavar="LR")
        parser.add_argument("--lr-shrink", default=0.1, type=float, metavar="LS")
        parser.add_argument("--shrink-min", action="store_true")

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.lr

    def step_update(self, num_updates):
        cycle = math.floor(num_updates / (2 * self.stepsize))
        lr_shrink = self.lr_shrink ** cycle
        max_lr = self.max_lr * lr_shrink
        if self.shrink_min:
            min_lr = self.min_lr * lr_shrink
        else:
            min_lr = self.min_lr
        x = abs(num_updates / self.stepsize - 2 * (cycle + 1) + 1)
        self.lr = min_lr + (max_lr - min_lr) * max(0, (1 - x))
        return self.lr

LR_SCHEDULERS = {
    "fixed": FixedSchedule,
    "inverse_sqrt": InverseSquareRootSchedule,
    "cosine": CosineSchedule,
    "polynomial_decay": PolynomialDecaySchedule,
    "reduce_lr_on_plateau": ReduceLROnPlateau,
    "tri_stage": TriStageLRSchedule,
    "triangular": TriangularSchedule,
}


def build_lr_scheduler(args) -> LRScheduler:
    name = getattr(args, "lr_scheduler", "inverse_sqrt")
    if name not in LR_SCHEDULERS:
        raise NotImplementedError(f"--lr-scheduler {name} is not a scheduler of the JAX package")
    return LR_SCHEDULERS[name](args)
