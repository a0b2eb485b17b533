"""Structured per-stage counters, JSON logs, and profiler hooks.

Every pipeline stage records wall time, named counters and optional
throughput into one JSON document per run.  With ``profile_dir`` (or env
AFT_PROFILE_DIR) the run is traced by ``torch.profiler`` (host and, on a
GPU, device activity), each stage a named ``record_function`` range, and the
trace is written there as a Chrome trace when the logger is dumped or the
process exits.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional


class StageLogger:
    def __init__(self, name: str, profile_dir: Optional[str] = None):
        self.name = name
        self.stats: Dict[str, float] = {}
        self._t0 = time.time()
        self.profile_dir = profile_dir or os.environ.get("AFT_PROFILE_DIR")
        self._prof = None
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
            # flush the trace even when the run raises before dump()
            atexit.register(self._stop_trace)

    def _stop_trace(self):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            path = os.path.join(self.profile_dir,
                                f"{self.name}_{os.getpid()}.trace.json")
            prof.export_chrome_trace(path)
            self.stats["profile_dir"] = self.profile_dir

    @contextlib.contextmanager
    def stage(self, name: str, items: Optional[int] = None,
              unit: str = "reads"):
        """Time one stage; with ``items``, also record items/s throughput.

        Under an active profiler trace the stage body is a named
        ``record_function`` range, so device work groups per pipeline stage.
        """
        ctx = contextlib.nullcontext()
        if self._prof is not None:
            from torch.profiler import record_function
            ctx = record_function(f"{self.name}.{name}")
        t = time.time()
        try:
            with ctx:
                yield self
        finally:
            dt = time.time() - t
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
