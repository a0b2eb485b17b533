"""Reading a ``torch.profiler`` trace of the measured window.

The busy time is the union of the device's kernel and copy intervals, as
chip_smoke.py's ``profiled`` takes it; the idle share is the rest of the
window.  The benchmark's own spans (``torch.profiler.record_function``
around the calls into each layer, capture.py) say what the host was doing
in each idle gap.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

SPAN = "fusionbench."        # prefix of the benchmark's own spans
WINDOW = SPAN + "window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by operation name
    kernel_n: Dict[str, int]
    idle_by_span: Dict[str, float]      # idle seconds by innermost span

    def device_s(self, *fragments: str) -> float:
        """Device seconds of the operations whose name holds a fragment."""
        return sum(v for k, v in self.kernel_s.items()
                   if any(f in k for f in fragments))

    def count(self, *fragments: str) -> int:
        """Intervals recorded of the operations whose name holds a
        fragment."""
        return sum(v for k, v in self.kernel_n.items()
                   if any(f in k for f in fragments))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:96], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every recorded event.  Reads
    the profiler's raw events where this torch has them (much faster than
    ``prof.events()`` over a long window)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
        out = []
        for e in raw:
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), e.device_type() == cuda, s, s + d))
        return out
    except AttributeError:
        return [(e.name, e.device_type == cuda, e.time_range.start * 1000,
                 e.time_range.end * 1000) for e in prof.events()]


def read(prof) -> Trace:
    """The window's device busy time, per-operation device time and the
    idle time by the benchmark span around it."""
    ev = _events(prof)
    win = [(s, t) for n, dev, s, t in ev if n == WINDOW and not dev]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0]
    spans, dev = [], []
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    for n, is_dev, s, t in ev:
        if n.startswith(SPAN):
            # record_function also leaves a device-side copy of each span:
            # neither is device work
            if not is_dev and n != WINDOW:
                spans.append((s, t, n[len(SPAN):]))
            continue
        if not is_dev or t <= w0 or s >= w1:
            continue
        s, t = max(s, w0), min(t, w1)
        dev.append((s, t))
        kernel_s[n] = kernel_s.get(n, 0.0) + (t - s) / 1e9
        kernel_n[n] = kernel_n.get(n, 0) + 1
    busy, gaps, end = 0, [], w0
    for s, t in sorted(dev):
        if s > end:
            gaps.append((end, s))
        busy += max(0, t - max(s, end))
        end = max(end, t)
    if end < w1:
        gaps.append((end, w1))
    idle = _idle_by_span(gaps, spans)
    return Trace((w1 - w0) / 1e9, busy / 1e9, kernel_s, kernel_n, idle)


def _idle_by_span(gaps: List[tuple], spans: List[tuple]) -> Dict[str, float]:
    """Idle seconds by the innermost span around each gap's midpoint
    ("outside" where none is); spans are laid longest first, so an inner
    span overwrites the one around it."""
    if not gaps:
        return {}
    g = np.asarray(gaps, dtype=np.float64)
    mid, length = g.mean(1), (g[:, 1] - g[:, 0]) / 1e9
    label = np.full(len(g), -1)
    names = sorted({n for _, _, n in spans})
    code = {n: i for i, n in enumerate(names)}
    for s, t, n in sorted(spans, key=lambda x: -(x[1] - x[0])):
        label[(mid >= s) & (mid < t)] = code[n]
    out: Dict[str, float] = {}
    for i in np.unique(label):
        n = names[i] if i >= 0 else "outside"
        out[n] = float(length[label == i].sum())
    return out
