"""Runtime meters feeding the metrics aggregator stack.

The port's own copy of ``fbk_fairseq_st_tpu/train/meters.py`` (reference
fairseq/logging/meters.py): the same meters, rounding and ``state_dict``
layout, so a meter's state in a checkpoint of either package loads in the
other. Rounding happens once, in ``Meter.smoothed_value``; ``MetersDict``
orders its entries by (priority, insertion) when read.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple


def _as_python_scalar(value):
    """Unwrap 0-d numpy arrays and tensors so meters never keep a device buffer."""
    item = getattr(value, "item", None)
    return item() if callable(item) else value


def safe_round(value, ndigits: Optional[int]):
    value = _as_python_scalar(value)
    if ndigits is not None and isinstance(value, float):
        return round(value, ndigits)
    return value


class Meter:
    """Base meter: subclasses implement ``_raw_value`` and ``reset``.

    ``smoothed_value`` is the single rendering point — it unwraps array
    scalars and applies the meter's rounding.
    """

    round: Optional[int] = None

    def reset(self) -> None:
        raise NotImplementedError

    def _raw_value(self):
        raise NotImplementedError

    @property
    def smoothed_value(self):
        return safe_round(self._raw_value(), self.round)

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


class AverageMeter(Meter):
    """Weighted running mean; reports the latest value until weight arrives."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self) -> None:
        self.val = None
        self.sum = 0
        self.count = 0

    def update(self, val, n=1) -> None:
        if val is None:
            return
        self.val = val
        if n > 0:
            self.sum = self.sum + val * n
            self.count = self.count + n

    @property
    def avg(self):
        if self.count > 0:
            return self.sum / self.count
        return self.val

    def _raw_value(self):
        return self.avg

    def state_dict(self) -> dict:
        return {
            "val": self.val,
            "sum": self.sum,
            "count": self.count,
            "round": self.round,
        }

    def load_state_dict(self, state: dict) -> None:
        self.val = state["val"]
        self.sum = state["sum"]
        self.count = state["count"]
        self.round = state.get("round")


class SumMeter(Meter):
    """Plain accumulator."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self) -> None:
        self.sum = 0

    def update(self, val) -> None:
        if val is not None:
            self.sum = self.sum + val

    def _raw_value(self):
        return self.sum

    def state_dict(self) -> dict:
        return {"sum": self.sum, "round": self.round}

    def load_state_dict(self, state: dict) -> None:
        self.sum = state["sum"]
        self.round = state.get("round")


class TimeMeter(Meter):
    """Rate meter: events per second of wall time since the last reset.

    ``init`` carries elapsed seconds across a checkpoint resume, so the rate
    stays continuous over restarts.
    """

    def __init__(self, init: float = 0, n: int = 0, round: Optional[int] = None):
        self.round = round
        self.reset(init=init, n=n)

    def reset(self, init: float = 0, n: int = 0) -> None:
        self.init = init
        self.n = n
        self._mark = time.perf_counter()

    def update(self, new_n=1) -> None:
        self.n = self.n + new_n

    @property
    def elapsed_time(self) -> float:
        return self.init + (time.perf_counter() - self._mark)

    @property
    def avg(self):
        return self.n / self.elapsed_time

    def _raw_value(self):
        return self.avg

    def state_dict(self) -> dict:
        return {"init": self.elapsed_time, "n": self.n, "round": self.round}

    def load_state_dict(self, state: dict) -> None:
        if "start" in state:
            # legacy payloads recorded a wall-clock start instead of a span
            self.reset(init=state["init"])
        else:
            self.reset(init=state["init"], n=state["n"])
            self.round = state.get("round")


class StopwatchMeter(Meter):
    """Accumulates start()/stop(n) spans; reports seconds-per-event.

    While a span is open and nothing has accumulated, renders the live
    elapsed time (matches the reference's "wall" meter behavior).
    """

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.sum = 0
        self.n = 0
        self.start_time: Optional[float] = None

    def start(self) -> None:
        self.start_time = time.perf_counter()

    def stop(self, n=1) -> None:
        if self.start_time is None:
            return
        self.sum = self.sum + (time.perf_counter() - self.start_time)
        self.n = self.n + n

    def reset(self) -> None:
        self.sum = 0
        self.n = 0
        self.start()

    @property
    def avg(self):
        return self.sum / self.n if self.n > 0 else self.sum

    @property
    def elapsed_time(self) -> float:
        if self.start_time is None:
            return 0.0
        return time.perf_counter() - self.start_time

    def _raw_value(self):
        return self.avg if self.sum > 0 else self.elapsed_time

    def state_dict(self) -> dict:
        return {"sum": self.sum, "n": self.n, "round": self.round}

    def load_state_dict(self, state: dict) -> None:
        self.sum = state["sum"]
        self.n = state["n"]
        self.start_time = None
        self.round = state.get("round")


class _DerivedMeter(Meter):
    """Computed-at-read meter (e.g. ppl from loss); never serialized."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def reset(self) -> None:
        pass


class MetersDict:
    """Mapping of name -> Meter rendered in (priority, insertion) order.

    Unlike a sorted container, entries live in a plain dict and the render
    order is computed on demand from a (priority, sequence) table — meters
    are written every step but rendered rarely, so sorting belongs on the
    read path.
    """

    _DerivedMeter = _DerivedMeter  # metrics.log_derived instantiates this

    def __init__(self):
        self._meters: Dict[str, Meter] = {}
        self._rank: Dict[str, Tuple[int, int]] = {}
        self._seq = 0

    # -- mapping protocol (write path) ------------------------------------
    def __contains__(self, key: str) -> bool:
        return key in self._meters

    def __getitem__(self, key: str) -> Meter:
        return self._meters[key]

    def get(self, key: str, default=None):
        return self._meters.get(key, default)

    def __len__(self) -> int:
        return len(self._meters)

    def add_meter(self, key: str, meter: Meter, priority: int) -> None:
        if key in self._meters:
            raise AssertionError(f"meter {key!r} already registered")
        self._meters[key] = meter
        self._rank[key] = (priority, self._seq)
        self._seq += 1

    # -- read path ---------------------------------------------------------
    def _ordered_keys(self) -> List[str]:
        return sorted(self._meters, key=self._rank.__getitem__)

    def __iter__(self) -> Iterator[str]:
        return iter(self._ordered_keys())

    def keys(self):
        return self._ordered_keys()

    def values(self):
        return [self._meters[k] for k in self._ordered_keys()]

    def items(self):
        return [(k, self._meters[k]) for k in self._ordered_keys()]

    def get_smoothed_value(self, key: str):
        meter = self._meters[key]
        if isinstance(meter, _DerivedMeter):
            return meter.fn(self)
        return meter.smoothed_value

    def get_smoothed_values(self) -> Dict[str, float]:
        return {
            k: self.get_smoothed_value(k)
            for k in self._ordered_keys()
            if not k.startswith("_")
        }

    def reset(self) -> None:
        for meter in self._meters.values():
            meter.reset()

    # -- checkpoint serialization (format shared with the reference) -------
    def state_dict(self) -> list:
        return [
            (self._rank[k][0], k, type(m).__name__, m.state_dict())
            for k, m in self.items()
            if not isinstance(m, _DerivedMeter)
        ]

    def load_state_dict(self, payload: list) -> None:
        self._meters.clear()
        self._rank.clear()
        self._seq = 0
        for priority, key, cls_name, meter_state in payload:
            meter = _METER_CLASSES[cls_name]()
            meter.load_state_dict(meter_state)
            self.add_meter(key, meter, priority)


_METER_CLASSES = {
    cls.__name__: cls
    for cls in (AverageMeter, SumMeter, TimeMeter, StopwatchMeter)
}
