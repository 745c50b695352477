"""Global metrics API: a stack of named aggregation scopes.

The port's own copy of ``fbk_fairseq_st_tpu/train/metrics.py`` (reference
fairseq/logging/metrics.py): every ``log_*`` call goes to every active
aggregator; ``"default"`` is always active; ``aggregate`` scopes nest and
are reference-counted, and ``new_root=True`` suspends the surrounding ones
while it is open. The aggregators' state goes into checkpoints.
"""

from __future__ import annotations

import contextlib
import uuid
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from .meters import (
    AverageMeter,
    MetersDict,
    StopwatchMeter,
    SumMeter,
    TimeMeter,
)


class _Runtime:
    """All aggregators ever named + the currently-recording subset."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.by_name: "OrderedDict[str, MetersDict]" = OrderedDict()
        self.recording: "OrderedDict[str, MetersDict]" = OrderedDict()
        self.depth: Dict[str, int] = {}
        self._open("default", MetersDict(), register=True)

    def obtain(self, name: Optional[str]):
        """Resolve (name, aggregator) for an ``aggregate`` scope."""
        if name is None:
            # anonymous scope: fresh unregistered aggregator, unique key
            return str(uuid.uuid4()), MetersDict()
        if name == "default":
            raise AssertionError("'default' may not be opened explicitly")
        if name not in self.by_name:
            self.by_name[name] = MetersDict()
        return name, self.by_name[name]

    def _open(self, name: str, agg: MetersDict, register: bool) -> None:
        if register:
            self.by_name[name] = agg
        self.recording[name] = agg
        self.depth[name] = self.depth.get(name, 0) + 1

    def push(self, name: str, agg: MetersDict, new_root: bool):
        """Activate a scope; returns the state to restore on pop."""
        saved = None
        if new_root:
            saved = (self.recording, self.depth)
            self.recording = OrderedDict()
            self.depth = {}
        self._open(name, agg, register=False)
        return saved

    def pop(self, name: str, saved) -> None:
        self.depth[name] -= 1
        if self.depth[name] == 0:
            self.recording.pop(name, None)
        if saved is not None:
            self.recording, self.depth = saved


_rt = _Runtime()


def reset() -> None:
    """Drop every aggregator and re-create the default scope."""
    _rt.clear()


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Record metrics under ``name`` (or an anonymous scope) while active."""
    key, agg = _rt.obtain(name)
    saved = _rt.push(key, agg, new_root)
    try:
        yield agg
    finally:
        _rt.pop(key, saved)


def get_active_aggregators() -> List[MetersDict]:
    return list(_rt.recording.values())


def _fanout(key: str, make, update=None) -> None:
    """Apply to every active aggregator: create the meter on first sight,
    then update it."""
    for agg in _rt.recording.values():
        fresh = key not in agg
        if fresh:
            make(agg)
        if update is not None:
            update(agg, fresh)


def log_scalar(
    key: str,
    value: float,
    weight: float = 1,
    priority: int = 10,
    round: Optional[int] = None,
) -> None:
    _fanout(
        key,
        lambda agg: agg.add_meter(key, AverageMeter(round=round), priority),
        lambda agg, _: agg[key].update(value, weight),
    )


def log_scalar_sum(
    key: str, value: float, priority: int = 10, round: Optional[int] = None
) -> None:
    _fanout(
        key,
        lambda agg: agg.add_meter(key, SumMeter(round=round), priority),
        lambda agg, _: agg[key].update(value),
    )


def log_derived(key: str, fn: Callable, priority: int = 20) -> None:
    _fanout(
        key,
        lambda agg: agg.add_meter(key, MetersDict._DerivedMeter(fn), priority),
    )


def log_speed(
    key: str, value: float, priority: int = 30, round: Optional[int] = None
) -> None:
    def _make(agg):
        agg.add_meter(key, TimeMeter(round=round), priority)

    def _update(agg, fresh):
        # the first observation only starts the clock
        agg[key].reset() if fresh else agg[key].update(value)

    _fanout(key, _make, _update)


def log_start_time(
    key: str, priority: int = 40, round: Optional[int] = None
) -> None:
    _fanout(
        key,
        lambda agg: agg.add_meter(key, StopwatchMeter(round=round), priority),
        lambda agg, _: agg[key].start(),
    )


def log_stop_time(key: str, weight: float = 0.0, prehook=None) -> None:
    for agg in _rt.recording.values():
        if key in agg:
            if prehook is not None:
                prehook()
            agg[key].stop(weight)


def reset_meter(name: str, key: str) -> None:
    meter = get_meter(name, key)
    if meter is not None:
        meter.reset()


def reset_meters(name: str) -> None:
    agg = _rt.by_name.get(name)
    if agg is not None:
        agg.reset()


def get_meter(name: str, key: str):
    agg = _rt.by_name.get(name)
    return agg.get(key) if agg is not None else None


def get_meters(name: str):
    return _rt.by_name.get(name)


def get_smoothed_value(name: str, key: str) -> float:
    return _rt.by_name[name].get_smoothed_value(key)


def get_smoothed_values(name: str) -> Dict[str, float]:
    return _rt.by_name[name].get_smoothed_values()


def state_dict():
    return OrderedDict(
        (name, agg.state_dict()) for name, agg in _rt.by_name.items()
    )


def load_state_dict(payload) -> None:
    for name, agg_state in payload.items():
        agg = MetersDict()
        agg.load_state_dict(agg_state)
        _rt.by_name[name] = agg
        if name in _rt.recording:
            _rt.recording[name] = agg
