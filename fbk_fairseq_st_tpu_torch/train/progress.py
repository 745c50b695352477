"""Progress bars: json / simple / tqdm / none, and TensorBoard scalars.

The port's own copy of ``fbk_fairseq_st_tpu/train/progress.py`` (reference
fairseq/logging/progress_bar.py), with the same lines. ``--tensorboard-logdir``
writes through ``torch.utils.tensorboard`` and raises when that writer
is not installed (no other format stands in for it).
"""

from __future__ import annotations

import json
import logging
import os
import sys
from numbers import Number
from typing import Optional

logger = logging.getLogger(__name__)


def progress_bar(
    iterator,
    log_format: Optional[str] = None,
    log_interval: int = 100,
    epoch: Optional[int] = None,
    prefix: Optional[str] = None,
    tensorboard_logdir: Optional[str] = None,
    default_log_format: str = "simple",
):
    if log_format is None:
        log_format = default_log_format
    if log_format == "tqdm" and not sys.stderr.isatty():
        log_format = "simple"

    if log_format == "json":
        bar = JsonProgressBar(iterator, epoch, prefix, log_interval)
    elif log_format == "none":
        bar = NoopProgressBar(iterator, epoch, prefix)
    elif log_format == "simple":
        bar = SimpleProgressBar(iterator, epoch, prefix, log_interval)
    elif log_format == "tqdm":
        bar = TqdmProgressBar(iterator, epoch, prefix)
    else:
        raise ValueError(f"Unknown log format: {log_format}")

    if tensorboard_logdir:
        bar = TensorboardProgressBarWrapper(bar, tensorboard_logdir)
    return bar


def format_stat(stat):
    if isinstance(stat, Number):
        if isinstance(stat, float):
            return round(stat, 3)
        return stat
    if hasattr(stat, "item"):
        return format_stat(stat.item())
    return stat


class BaseProgressBar:
    def __init__(self, iterable, epoch=None, prefix=None):
        self.iterable = iterable
        self.n = getattr(iterable, "n", 0)
        self.epoch = epoch
        self.prefix = ""
        if epoch is not None:
            self.prefix += f"epoch {epoch:03d}"
        if prefix is not None:
            self.prefix += (" | " if self.prefix else "") + prefix

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        raise NotImplementedError

    def log(self, stats, tag=None, step=None):
        raise NotImplementedError

    def print(self, stats, tag=None, step=None):
        raise NotImplementedError

    def _str_commas(self, stats):
        return ", ".join(f"{k}={v}" for k, v in stats.items())

    def _str_pipes(self, stats):
        return " | ".join(f"{k} {v}" for k, v in stats.items())

    def _format_stats(self, stats):
        return {k: str(format_stat(v)) for k, v in stats.items()}


class JsonProgressBar(BaseProgressBar):
    """Log output in JSON format (reference progress_bar.py:162)."""

    def __init__(self, iterable, epoch=None, prefix=None, log_interval=1000):
        super().__init__(iterable, epoch, prefix)
        self.log_interval = log_interval
        self.i = None
        self.size = None

    def __iter__(self):
        self.size = len(self.iterable)
        for i, obj in enumerate(self.iterable, start=self.n):
            self.i = i
            yield obj

    def log(self, stats, tag=None, step=None):
        step = step or self.i or 0
        if step > 0 and self.log_interval is not None and step % self.log_interval == 0:
            update = (
                self.epoch - 1 + (self.i + 1) / float(self.size)
                if self.epoch is not None
                else None
            )
            stats = self._format_stats(stats, epoch=self.epoch, update=update)
            logger.info(json.dumps(stats))

    def print(self, stats, tag=None, step=None):
        self.stats = stats
        if tag is not None:
            stats = {tag + "_" + k: v for k, v in stats.items()}
        stats = self._format_stats(stats, epoch=self.epoch)
        logger.info(json.dumps(stats))

    def _format_stats(self, stats, epoch=None, update=None):
        postfix = dict()
        if epoch is not None:
            postfix["epoch"] = epoch
        if update is not None:
            postfix["update"] = round(update, 3)
        for key in stats.keys():
            postfix[key] = format_stat(stats[key])
        return postfix


class NoopProgressBar(BaseProgressBar):
    def __iter__(self):
        for obj in self.iterable:
            yield obj

    def log(self, stats, tag=None, step=None):
        pass

    def print(self, stats, tag=None, step=None):
        pass


class SimpleProgressBar(BaseProgressBar):
    def __init__(self, iterable, epoch=None, prefix=None, log_interval=1000):
        super().__init__(iterable, epoch, prefix)
        self.log_interval = log_interval
        self.i = None
        self.size = None

    def __iter__(self):
        self.size = len(self.iterable)
        for i, obj in enumerate(self.iterable, start=self.n):
            self.i = i
            yield obj

    def log(self, stats, tag=None, step=None):
        step = step or self.i or 0
        if step > 0 and self.log_interval is not None and step % self.log_interval == 0:
            stats = self._format_stats(stats)
            postfix = self._str_commas(stats)
            logger.info(
                f"{self.prefix}: {self.i + 1:5d} / {self.size:d} {postfix}"
            )

    def print(self, stats, tag=None, step=None):
        postfix = self._str_pipes(self._format_stats(stats))
        logger.info(f"{self.prefix} | {postfix}")


class TqdmProgressBar(BaseProgressBar):
    def __init__(self, iterable, epoch=None, prefix=None):
        super().__init__(iterable, epoch, prefix)
        from tqdm import tqdm

        self.tqdm = tqdm(iterable, self.prefix, leave=False)

    def __iter__(self):
        return iter(self.tqdm)

    def log(self, stats, tag=None, step=None):
        self.tqdm.set_postfix(self._format_stats(stats), refresh=False)

    def print(self, stats, tag=None, step=None):
        postfix = self._str_pipes(self._format_stats(stats))
        self.tqdm.write(f"{self.tqdm.desc} | {postfix}")


class TensorboardProgressBarWrapper(BaseProgressBar):
    """Write the scalars to a TensorBoard directory per tag (reference
    progress_bar.py TensorboardProgressBarWrapper)."""

    def __init__(self, wrapped_bar, tensorboard_logdir):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise RuntimeError("--tensorboard-logdir needs torch.utils.tensorboard and the tensorboard "
                               "package, which are not installed") from e
        self.SummaryWriter = SummaryWriter
        self.wrapped_bar = wrapped_bar
        self.tensorboard_logdir = tensorboard_logdir
        self._writers = {}

    def _writer(self, key):
        if key not in self._writers:
            self._writers[key] = self.SummaryWriter(os.path.join(self.tensorboard_logdir, key))
        return self._writers[key]

    def __len__(self):
        return len(self.wrapped_bar)

    def __iter__(self):
        return iter(self.wrapped_bar)

    def log(self, stats, tag=None, step=None):
        self._log_to_tensorboard(stats, tag, step)
        self.wrapped_bar.log(stats, tag=tag, step=step)

    def print(self, stats, tag=None, step=None):
        self._log_to_tensorboard(stats, tag, step)
        self.wrapped_bar.print(stats, tag=tag, step=step)

    def _log_to_tensorboard(self, stats, tag=None, step=None):
        writer = self._writer(tag or "")
        if step is None:
            step = stats.get("num_updates", -1)
        for key in stats.keys() - {"num_updates"}:
            v = stats[key]
            if isinstance(v, Number):
                writer.add_scalar(key, v, step)
            elif hasattr(v, "item"):
                writer.add_scalar(key, v.item(), step)
