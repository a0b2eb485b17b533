"""The program's own spans (anchored_fusion_tpu_torch/utils/log.py) as the
span metrics read them.

Each reader's ``install(cap)`` points the program's span sink at
``cap.data["spans"]`` through ``cap.patch``, so ``uninstall`` turns it off
again and the harness's ``clear`` after the warm-up call leaves the
window's spans alone.  A record is a dict: ``name``, ``id``, ``parent``,
``call``, ``start_ns``, ``end_ns`` (``time.time_ns()``) and ``counts``.
A program without the recorder keeps no spans, and every reader then
returns None.
"""

from __future__ import annotations

from typing import Dict, List

KEY = "spans"
# spans that only group others: their time counts as their children's
GROUPS = ("cell",)


def install(cap) -> None:
    from anchored_fusion_tpu_torch.utils import log
    if not hasattr(log, "_sink"):
        return
    spans = cap.data.setdefault(KEY, [])
    cap.patch(log, "_sink", lambda orig: spans)


def records(ctx) -> List[dict]:
    """The window's span records (empty without the recorder)."""
    cap = ctx.get("cap")
    return (cap.data.get(KEY) or []) if cap is not None else []


def seconds(recs: List[dict], *names: str) -> float:
    """Summed duration of the spans named ``names``."""
    return sum(r["end_ns"] - r["start_ns"] for r in recs
               if r["name"] in names) / 1e9


def total(recs: List[dict], name: str, key: str) -> int:
    """Summed count ``key`` of the spans named ``name``."""
    return sum(r["counts"].get(key, 0) for r in recs if r["name"] == name)


def per_mpair(ctx, *names: str):
    """Summed seconds of the spans ``names`` per million pairs of the
    window, or None without spans or pairs."""
    recs = records(ctx)
    if not recs or not ctx["pairs"]:
        return None
    return seconds(recs, *names) / (ctx["pairs"] / 1e6)


def _union_ns(intervals: List[tuple]) -> int:
    out, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            out += t - s
            end = t
        elif t > end:
            out += t - end
            end = t
    return out


def uncovered_ns(rec: dict, children: Dict[int, List[dict]]) -> int:
    """The part of ``rec``'s interval that no span below it covers, a
    span of GROUPS being replaced by its own children."""
    def leaves(r):
        for c in children.get(r["id"], []):
            if c["name"] in GROUPS:
                yield from leaves(c)
            else:
                yield c["start_ns"], c["end_ns"]
    return rec["end_ns"] - rec["start_ns"] - _union_ns(list(leaves(rec)))


def children_of(recs: List[dict]) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {}
    for r in recs:
        out.setdefault(r["parent"], []).append(r)
    return out
