"""Spans, per-stage counters, JSON logs, and profiler hooks.

The span recorder: ``span(name, **counts)`` marks one piece of the
program's work.  While the module's sink is ``None`` (the default) it
returns the shared no-op ``OFF``: no clock is read and nothing is kept.
While the sink is a list, each span appends one record to it when it
closes::

    {"name", "id", "parent", "call", "tid", "start_ns", "end_ns", "counts"}

``parent`` is the id of the span open around it on the same thread (None
at the top), ``call`` the id of the outermost one, so every span of one
call shares it; the times are ``time.time_ns()``, the clock of
``torch.profiler``'s host events.  No span calls ``record_function`` or
synchronises the device: a span that ends at an implicit sync (a ``.cpu()``,
a pageable copy) holds the wait.  ``timed`` is a span that reads the clock
whether or not the sink is on, for the intervals the program reports
itself; ``Stages`` turns back-to-back clock reads into both the
``time.<stage>_s`` counters and the stage spans.

``StageLogger``: every CLI stage records wall time, named counters and
optional throughput into one JSON document per run, and is a ``timed``
span.  With ``profile_dir`` (or env AFT_PROFILE_DIR) the run is traced by
``torch.profiler`` (host and, on a GPU, device activity), the sink is on,
and the spans join the profiler's Chrome trace as host events (``"ph":
"X"``) when the logger is dumped or the process exits.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

# where spans go: None (off) or a list (benchmark readers, StageLogger)
_sink: Optional[list] = None
_local = threading.local()
_ids = itertools.count(1)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
        _local.tid = threading.get_native_id()
    return s


class _Off:
    """The handle of every span while the sink is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


OFF = _Off()


class Span:
    """One span: open from ``open`` (or ``with``) to ``close``.  With
    ``sink`` None it only reads the clock (``timed``)."""

    __slots__ = ("name", "counts", "sink", "rec", "start_ns", "end_ns")

    def __init__(self, name: Optional[str], counts: dict, sink):
        self.name, self.counts, self.sink = name, counts, sink
        self.rec = None
        self.start_ns = self.end_ns = 0

    def open(self, t_ns: Optional[int] = None) -> "Span":
        self.start_ns = time.time_ns() if t_ns is None else t_ns
        if self.sink is not None:
            stack = _stack()
            up = stack[-1].rec if stack else None
            sid = next(_ids)
            self.rec = {"name": self.name, "id": sid,
                        "parent": up["id"] if up else None,
                        "call": up["call"] if up else sid,
                        "tid": _local.tid, "start_ns": self.start_ns,
                        "end_ns": None, "counts": self.counts}
            stack.append(self)
        return self

    def close(self, t_ns: Optional[int] = None) -> None:
        self.end_ns = time.time_ns() if t_ns is None else t_ns
        if self.rec is None:
            return
        stack = _stack()
        # spans left open inside this one (a stage sequence cut by an
        # exception) close unrecorded with it
        while stack and stack.pop() is not self:
            pass
        self.rec["name"] = self.name
        self.rec["end_ns"] = self.end_ns
        self.sink.append(self.rec)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def add(self, **counts) -> None:
        """Add ``counts`` to the span's (summing a count given twice)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()
        return False


def span(name: str, **counts):
    """A span named ``name`` with ``counts``; ``OFF`` while the sink is off."""
    sink = _sink
    if sink is None:
        return OFF
    return Span(name, counts, sink)


def timed(name: str, **counts) -> Span:
    """A span that reads the clock with the sink off too (``seconds``)."""
    return Span(name, counts, _sink)


def count(name: str, **counts) -> None:
    """Add ``counts`` to the innermost open span if it is named ``name``
    (a callee's counts for its caller's span; nothing otherwise)."""
    if _sink is None:
        return
    stack = _stack()
    if stack and stack[-1].name == name:
        stack[-1].add(**counts)


class Stages:
    """Back-to-back stage intervals on one clock: each ``mark(stage)`` ends
    the interval since the previous mark (or since the sequence began),
    writes its seconds to ``counters["time.<stage>_s"]`` and, with the sink
    on, records it as the span ``stage``, the parent of the spans opened
    inside it."""

    def __init__(self, counters: Dict[str, float]):
        self.counters = counters
        self.last_ns = time.time_ns()
        self._open = self._next()

    def _next(self) -> Optional[Span]:
        if _sink is None:
            return None
        return Span(None, {}, _sink).open(self.last_ns)

    def mark(self, stage: str, last: bool = False) -> None:
        now = time.time_ns()
        self.counters[f"time.{stage}_s"] = round((now - self.last_ns) / 1e9,
                                                 4)
        self.last_ns = now
        if self._open is not None:
            self._open.name = stage
            self._open.close(now)
        self._open = None if last else self._next()


def chrome_events(records: list, base_ns: int = 0) -> list:
    """Span records as Chrome trace host events (µs after ``base_ns``)."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "aft_span", "name": r["name"], "pid": pid,
             "tid": r["tid"], "ts": (r["start_ns"] - base_ns) / 1e3,
             "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
             "args": {"id": r["id"], "parent": r["parent"],
                      "call": r["call"], **r["counts"]}}
            for r in records]


class StageLogger:
    def __init__(self, name: str, profile_dir: Optional[str] = None):
        global _sink
        self.name = name
        self.stats: Dict[str, float] = {}
        self._t0 = time.time()
        self.profile_dir = profile_dir or os.environ.get("AFT_PROFILE_DIR")
        self._prof = None
        self.spans: list = []
        if self.profile_dir:
            import atexit
            import torch
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(self.profile_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            _sink = self.spans
            # flush the trace even when the run raises before dump()
            atexit.register(self._stop_trace)

    def _stop_trace(self):
        global _sink
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            if _sink is self.spans:
                _sink = None
            path = os.path.join(self.profile_dir,
                                f"{self.name}_{os.getpid()}.trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                trace = json.load(fh)
            trace["traceEvents"].extend(chrome_events(
                self.spans, trace.get("baseTimeNanoseconds", 0)))
            with open(path, "w") as fh:
                json.dump(trace, fh)
            self.stats["profile_dir"] = self.profile_dir

    @contextlib.contextmanager
    def stage(self, name: str, items: Optional[int] = None,
              unit: str = "reads"):
        """Time one stage; with ``items``, also record items/s throughput.

        The stage is the span ``<logger>.<stage>``, the parent of the
        program's spans inside it.
        """
        sp = timed(f"{self.name}.{name}")
        try:
            with sp:
                yield self
        finally:
            dt = sp.seconds
            self.stats[f"time.{name}_s"] = round(dt, 3)
            line = f"[{self.name}] {name}: {dt:.2f}s"
            if items is not None and dt > 0:
                rate = items / dt
                self.stats[f"rate.{name}_{unit}_per_s"] = round(rate, 1)
                line += f" ({rate:,.0f} {unit}/s)"
            print(line)

    def set(self, **kwargs):
        for k, v in kwargs.items():
            self.stats[k] = v

    def dump(self, path: str):
        self.stats["time.total_s"] = round(time.time() - self._t0, 3)
        self._stop_trace()
        with open(path, "w") as fh:
            json.dump({"run": self.name, "stats": self.stats}, fh, indent=1,
                      default=str)
