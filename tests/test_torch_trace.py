"""The port's span recorder (anchored_fusion_tpu_torch/utils/log.py): off
it keeps nothing and reads no clock; on, nested spans carry their parent,
call and counts on the clock of torch.profiler's host events; and on the
pipeline's own calls the stage spans are the ``time.*_s`` counters' own
intervals, with the counters' keys unchanged."""

import numpy as np
import pytest
import torch

from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.bench.simulate import (
    coverage_to_pairs, fuse_transcripts, make_synthetic_genome,
    simulate_pairs)
from anchored_fusion_tpu_torch.config import PipelineConfig
from anchored_fusion_tpu_torch.io.fasta import Reference
from anchored_fusion_tpu_torch.io.fastq import ReadBatch
from anchored_fusion_tpu_torch.ops.encode import encode_ascii
from anchored_fusion_tpu_torch.pipeline import FusionPipeline
from anchored_fusion_tpu_torch.utils import log

STAGES = ("mate_rescue", "homolog", "rescue", "blocks", "consensus",
          "anchored_split", "candidate_join", "report")
COUNTER_KEYS = {
    "reads", "anchor_mapped", "time.anchor_align_s", "half_mapped_pairs",
    "time.mate_rescue_s", "homo_genes", "time.homolog_s", "clipped_reads",
    "clipped_kept", "time.rescue_s", "spanning_blocks", "blocks",
    "time.blocks_s", "split_reads", "breakpoint_clusters",
    "time.consensus_s", "candidate_regions", "good_breakpoints",
    "time.anchored_split_s", "candidates", "time.candidate_join_s",
    "emitted", "time.report_s", "wall_s"}
MS = 1e6        # ns


@pytest.fixture
def sink(monkeypatch):
    spans = []
    monkeypatch.setattr(log, "_sink", spans)
    return spans


class FakeClock:
    """``time`` for log.py: time_ns steps by 10 ns a read."""

    def __init__(self):
        self.t = 0

    def time_ns(self):
        self.t += 10
        return self.t


class NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"the clock was read (time.{name})")


def self_ns(rec, spans):
    """Duration of ``rec`` less the union of its children's intervals."""
    kids = sorted((s["start_ns"], s["end_ns"]) for s in spans
                  if s["parent"] == rec["id"])
    covered, end = 0, rec["start_ns"]
    for s, t in kids:
        covered += max(0, t - max(s, end))
        end = max(end, t)
    return rec["end_ns"] - rec["start_ns"] - covered


def test_span_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    assert log._sink is None
    monkeypatch.setattr(log, "time", NoClock())
    with log.span("a", rows=3) as sp:
        sp.add(rows=1)
        with log.span("b") as inner:
            log.count("b", chunks=2)
    assert sp is log.OFF and inner is log.OFF
    assert log.span("c") is log.OFF
    assert getattr(log._local, "stack", []) == []


def test_nested_spans_parents_calls_counts_and_self_time(sink, monkeypatch):
    monkeypatch.setattr(log, "time", FakeClock())
    with log.span("call", pairs=5) as top:
        with log.span("a", rows=2) as a:
            a.add(rows=3, used=1)
            with log.span("b"):
                log.count("b", chunks=4)
                log.count("a", chunks=9)        # not innermost: ignored
        with log.span("c"):
            pass
    with log.span("call", pairs=1):
        pass
    by = {}
    for r in sink:
        by.setdefault(r["name"], []).append(r)
    call, a, b, c = by["call"][0], by["a"][0], by["b"][0], by["c"][0]
    assert [r["name"] for r in sink] == ["b", "a", "c", "call", "call"]
    assert call["parent"] is None and call["call"] == call["id"]
    assert a["parent"] == call["id"] and c["parent"] == call["id"]
    assert b["parent"] == a["id"]
    assert {r["call"] for r in (a, b, c)} == {call["id"]}
    assert by["call"][1]["call"] == by["call"][1]["id"] != call["id"]
    assert call["counts"] == {"pairs": 5}
    assert a["counts"] == {"rows": 5, "used": 1}
    assert b["counts"] == {"chunks": 4}
    # each read steps the clock 10 ns: call 0..80 holds a 10..50, c 60..70
    assert (call["start_ns"], call["end_ns"]) == (10, 80)
    assert (a["start_ns"], a["end_ns"]) == (20, 50)
    assert (c["start_ns"], c["end_ns"]) == (60, 70)
    assert self_ns(call, sink) == 70 - 30 - 10
    assert self_ns(a, sink) == 30 - 10
    assert top.seconds == 70e-9
    assert log._local.stack == []


def test_stages_share_clock_reads_with_counters(sink, monkeypatch):
    monkeypatch.setattr(log, "time", FakeClock())
    counters = {}
    with log.span("cell"):
        mark = log.Stages(counters).mark
        with log.span("orient"):
            pass
        mark("one")
        mark("two", last=True)
    one, two = (r for r in sink if r["name"] in ("one", "two"))
    orient, = (r for r in sink if r["name"] == "orient")
    cell, = (r for r in sink if r["name"] == "cell")
    assert orient["parent"] == one["id"]
    assert one["parent"] == two["parent"] == cell["id"]
    assert one["end_ns"] == two["start_ns"]
    for r, key in ((one, "time.one_s"), (two, "time.two_s")):
        assert counters[key] == round((r["end_ns"] - r["start_ns"]) / 1e9, 4)
    assert log._local.stack == []


def test_span_cut_by_an_exception_leaves_the_stack_clean(sink):
    with pytest.raises(ValueError):
        with log.span("cell"):
            log.Stages({})          # a stage sequence left open
            raise ValueError("cell failed")
    assert [r["name"] for r in sink] == ["cell"]
    assert log._local.stack == []


def test_spans_share_the_profiler_clock(sink):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with log.span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    try:
        evs = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.name() == "outer"]
    except AttributeError:
        evs = [(e.time_range.start * 1000, e.time_range.end * 1000)
               for e in prof.events() if e.name == "outer"]
    s, t = evs[0]
    inner, = sink
    assert s - 5 * MS <= inner["start_ns"] <= inner["end_ns"] <= t + 5 * MS


def test_orient_counts_the_rows_passed(sink):
    from anchored_fusion_tpu_torch.align.aligner import orient_reads
    seqs = np.random.default_rng(0).integers(0, 4, (7, 12)).astype(np.int8)
    strands = np.array([0, 1, 1, 0, 1, 0, 0], np.int8)
    orient_reads(seqs, strands, rows=np.array([4, 1]))
    orient_reads(seqs[:3], strands[:3])
    assert [r["counts"] for r in sink] == [
        {"rows": 2, "reversed": 2, "used": 2}, {"rows": 3, "reversed": 2}]


@pytest.fixture(scope="module")
def world():
    """The engineered fusion of tests/test_pipeline_synthetic.py."""
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               exons_per_gene=(3, 5), exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:2]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    g = sg.genome
    pipe = FusionPipeline(
        Reference(list(g.names), g.starts.copy(), g.lengths.copy(),
                  g.seq.copy()),
        ExonIndex(sg.gtf_dic, inject_loci=False), sg.gene_rows(),
        PipelineConfig(filter_false_positive=False), device="cpu")
    return pipe, anchor.name, encode_ascii(tx_a), tx_a, fusion


def _batch(tx, n, seed):
    names, r1, r2 = simulate_pairs(np.random.default_rng(seed), tx, n,
                                   name_prefix=f"S{seed}")
    seq = np.stack([np.stack([encode_ascii(x, length=128),
                              encode_ascii(y, length=128)])
                    for x, y in zip(r1, r2)])
    return ReadBatch(names, seq, np.full((len(names), 2), 101, np.int32))


def _check_stage_spans(result, spans, parent):
    """The stage spans under ``parent`` are the counters' intervals."""
    mine = {r["name"]: r for r in spans if r["parent"] == parent["id"]}
    for st in STAGES:
        r = mine[st]
        assert abs((r["end_ns"] - r["start_ns"]) / 1e9
                   - result.counters[f"time.{st}_s"]) <= 1e-3, st
    return mine


def test_call_gene_stage_spans_equal_their_counters(world, sink, tmp_path):
    pipe, name, anchor_codes, tx_a, fusion = world
    reads = _batch(fusion, coverage_to_pairs(len(fusion), 40), 12)
    res = pipe.call_gene(name, anchor_codes, reads,
                         out_prefix=str(tmp_path / "s"))
    assert set(res.counters) == COUNTER_KEYS
    call, = (r for r in sink if r["name"] == "call")
    assert call["counts"] == {"pairs": reads.n_pairs}
    mine = _check_stage_spans(res, sink, call)
    al = mine["anchor_align"]
    assert al["counts"] == {"reads": 2 * reads.n_pairs}
    assert abs((al["end_ns"] - al["start_ns"]) / 1e9
               - res.counters["time.anchor_align_s"]) <= 1e-3
    # the copies and the refine inside the anchored stage
    inside = {r["name"] for r in sink if r["parent"] == al["id"]}
    assert {"anchor.h2d", "anchor.d2h", "anchor.refine"} <= inside
    h2d = [r for r in sink if r["name"] == "anchor.h2d"
           and r["parent"] == al["id"]]
    assert sum(r["counts"]["rows"] for r in h2d) == 2 * reads.n_pairs
    assert sum(r["counts"]["bytes"] for r in h2d) == reads.seq.nbytes
    refine, = (r for r in sink if r["name"] == "anchor.refine"
               and r["parent"] == al["id"])
    # each orientation orients the rows its caller reads, and those alone:
    # the refined rows, then stage 4's clipped ones
    orient, = (r for r in sink if r["name"] == "orient"
               and r["parent"] == refine["id"])
    assert orient["counts"]["rows"] == orient["counts"]["used"]
    assert orient["counts"]["used"] == refine["counts"]["rows_refined"]
    o4, = (r for r in sink if r["name"] == "orient"
           and r["parent"] == mine["rescue"]["id"])
    assert o4["counts"]["rows"] == o4["counts"]["used"]
    assert o4["counts"]["used"] == res.counters["clipped_reads"] > 0
    am, = (r for r in sink if r["name"] == "genome.align_multi")
    assert am["parent"] == mine["rescue"]["id"]
    assert am["counts"]["reads"] == res.counters["clipped_reads"]
    assert am["counts"]["chunks"] >= 1
    assert {r["call"] for r in sink} == {call["id"]}


def test_call_gene_cells_stage_spans_equal_their_counters(world, sink,
                                                          tmp_path):
    pipe, name, anchor_codes, tx_a, fusion = world
    cells = {"c0": _batch(fusion, 150, 1), "c1": _batch(tx_a, 80, 2),
             "c2": _batch(fusion, 120, 3)}
    out = pipe.call_gene_cells(
        name, anchor_codes, cells,
        out_prefix_for=lambda c: str(tmp_path / c))
    call, = (r for r in sink if r["name"] == "call")
    assert call["counts"] == {"pairs": 350}
    al, = (r for r in sink if r["name"] == "anchor_align")
    assert al["parent"] == call["id"]
    cell_spans = [r for r in sink if r["name"] == "cell"]
    assert [r["counts"]["pairs"] for r in cell_spans] == [150, 80, 120]
    assert all(r["parent"] == call["id"] for r in cell_spans)
    for c, span_ in zip(cells, cell_spans):
        assert set(out[c].counters) == COUNTER_KEYS
        _check_stage_spans(out[c], sink, span_)
    # the cells share the one anchored pass, each its share of it
    shares = sum(r.counters["time.anchor_align_s"] for r in out.values())
    assert abs((al["end_ns"] - al["start_ns"]) / 1e9 - shares) <= 1e-3
    assert self_ns(call, sink) <= 0.05 * (call["end_ns"] - call["start_ns"])


def test_counters_keys_do_not_depend_on_the_sink(world, monkeypatch):
    pipe, name, anchor_codes, tx_a, fusion = world
    reads = _batch(tx_a, 60, 5)
    off = pipe.call_gene(name, anchor_codes, reads)
    monkeypatch.setattr(log, "_sink", [])
    on = pipe.call_gene(name, anchor_codes, reads)
    assert set(off.counters) == set(on.counters) == COUNTER_KEYS
    assert off.rows == on.rows
