"""The span metrics' readers (metrics/span.*.py, spans.py) on hand-made
span lists with known values, and their hook on the program's sink."""

import numpy as np
import pytest

from fusionbench import capture, registry, spans

MS = 1_000_000      # ns


def rec(name, sid, parent, start_ms, end_ms, **counts):
    return {"name": name, "id": sid, "parent": parent, "call": 1,
            "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "counts": counts}


class Cap:
    def __init__(self, recs):
        self.data = {spans.KEY: recs}


def read(metric, recs, pairs=2_000_000):
    return registry.reader(metric).read({"cap": Cap(recs), "pairs": pairs,
                                         "counters": [], "trace": None})


def test_sums_per_million_pairs():
    recs = [rec("orient", 2, 1, 0, 300, rows=100, used=1),
            rec("orient", 3, 1, 400, 900, rows=100, used=3),
            rec("anchor.h2d", 4, 1, 0, 20, rows=10, bytes=1280),
            rec("anchor.h2d", 5, 1, 20, 50, rows=10, bytes=1280),
            rec("anchor.d2h", 6, 1, 50, 150, rows=20),
            rec("genome.align_multi", 7, 1, 900, 1100, reads=4, chunks=1),
            rec("call", 1, None, 0, 2000, pairs=2_000_000)]
    # 0.3 + 0.5 s over 2 Mpairs
    assert read("span.orient_s_per_mpair", recs) == pytest.approx(0.4)
    assert read("span.anchor_copy_s_per_mpair", recs) == pytest.approx(
        0.15 / 2)
    assert read("span.align_multi_s_per_mpair", recs) == pytest.approx(0.1)
    no_multi = [r for r in recs if r["name"] != "genome.align_multi"]
    assert read("span.align_multi_s_per_mpair", no_multi) == 0.0


def test_used_share_is_used_rows_over_oriented_rows():
    recs = [rec("orient", 2, 1, 0, 1, rows=1000, reversed=500, used=5),
            rec("orient", 3, 1, 1, 2, rows=3000, reversed=1500, used=15),
            rec("orient", 4, 1, 2, 3, rows=1000, reversed=0)]
    assert read("span.orient_used_share", recs) == pytest.approx(
        100.0 * 20 / 5000)


def test_uncovered_share_is_self_time_with_overlapping_children():
    # call 0..100: children 10..40 and 30..50 overlap (covered 10..50), a
    # cell 60..90 counts as its stages 60..70 and 75..90; uncovered:
    # 0..10, 50..60, 70..75, 90..100 = 35 of 100
    recs = [rec("call", 1, None, 0, 100),
            rec("anchor_align", 2, 1, 10, 40),
            rec("orient", 3, 2, 12, 38),
            rec("report", 4, 1, 30, 50),
            rec("cell", 5, 1, 60, 90),
            rec("rescue", 6, 5, 60, 70),
            rec("report", 7, 5, 75, 90),
            # a second call, wholly covered
            rec("call", 8, None, 200, 300),
            rec("anchor_align", 9, 8, 200, 300)]
    kids = spans.children_of(recs)
    assert spans.uncovered_ns(recs[0], kids) == 35 * MS
    assert read("span.uncovered_share", recs) == pytest.approx(
        100.0 * 35 / 200)


def test_cell_p95_over_200_cells():
    recs = [rec("call", 1, None, 0, 10 ** 6)]
    ms = np.random.default_rng(3).uniform(10, 90, 200)
    t = 0.0
    for i, d in enumerate(ms):
        recs.append(rec("cell", i + 2, 1, t, t + d, pairs=10_000))
        t += d + 1
    got = read("span.cell_host_ms_p95", recs)
    assert got == pytest.approx(np.percentile(ms, 95), rel=1e-6)
    assert sorted(ms)[189] <= got <= sorted(ms)[190]


@pytest.mark.parametrize("metric", [m for m in registry.names("metrics")
                                    if m.startswith("span.")])
def test_without_spans_every_reader_reads_nothing(metric):
    assert read(metric, []) is None
    assert registry.reader(metric).read(
        {"cap": None, "pairs": 0, "counters": [], "trace": None}) is None


def test_install_then_uninstall_leaves_the_sink_off():
    from anchored_fusion_tpu_torch.utils import log
    assert log._sink is None
    cap = capture.Capture(pipe=None, trace=True)
    for m in registry.names("metrics"):
        mod = registry.reader(m)
        if m.startswith("span."):
            mod.install(cap)
    assert log._sink is cap.data[spans.KEY]
    with log.span("orient", rows=3):
        pass
    assert [r["name"] for r in cap.data[spans.KEY]] == ["orient"]
    cap.clear()
    assert cap.data[spans.KEY] == [] and log._sink is cap.data[spans.KEY]
    cap.uninstall()
    assert log._sink is None
    assert log.span("orient") is log.OFF


def test_install_on_a_program_without_the_recorder_does_nothing(
        monkeypatch):
    from anchored_fusion_tpu_torch.utils import log
    monkeypatch.delattr(log, "_sink")
    cap = capture.Capture(pipe=None, trace=True)
    spans.install(cap)
    assert not hasattr(log, "_sink") and spans.KEY not in cap.data
    cap.uninstall()
