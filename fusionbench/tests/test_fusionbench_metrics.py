"""The metric arithmetic: roofline counts, the trace's busy and idle time,
the stage readers, the reference's scores and the comparison, on hand-made
inputs with known values."""

import numpy as np
import pytest
import torch

from fusionbench import judge, reference, registry, roofline
from fusionbench import trace as tracing


def codes(s):
    return np.array(["ACGTN".index(c) for c in s], np.int8)


def test_seed_block_bound_counts_the_product_and_its_bytes():
    # 65,536 rows x 128 positions against 6,927 diagonals: the operations
    # decide; 2 * M * Rs * 4 * D at 1,979 TOP/s
    M, R, D = 65536, 128, 6927
    t = roofline.seed_block_bound_s(M, R, R, D)
    assert t == pytest.approx(2 * M * R * 4 * D / 1979e12)
    # a tiny launch is bound by its bytes: codes, one-hots, 2 int32 a block
    t = roofline.seed_block_bound_s(2, 4, 4, 100)
    assert t == pytest.approx((2 * 4 + 4 * 100 + 2 * 2 * 1 * 4) / 3.35e12)
    t = roofline.seed_block_bound_s(2, 4, 4, 300, k=8)
    assert t == pytest.approx((2 * 4 + 4 * 300 + 2 * 3 * 8 * 4) / 3.35e12)


def test_seed_vote_work_counts_hits_from_the_table():
    # k = 2: 16 keys; bucket "AC" (key 1) holds 3 slots, "CG" (key 6) 20
    k = 2
    sizes = np.zeros(16, np.int64)
    sizes[1], sizes[6] = 3, 20
    table = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                             .astype(np.int32))
    flat = torch.from_numpy(np.stack([codes("ACGT"), codes("ANGT")]))
    offs = torch.arange(3, dtype=torch.int32)
    w = roofline.seed_vote_work(flat, table, table[:1], offs, k, k, 1, 8,
                                4, True)
    # row 0: AC (3 hits), CG (8 of 20, H = 8), GT (0); row 1: only GT valid
    assert w["hits"] == 11
    assert w["bytes"] == 2 * 4 + 3 * 4 + 8 * 4 + 4 * 11 + 2 * 4 * 4 * 2
    assert w["comparisons"] == pytest.approx(11 * np.log2(11) + 0 * 1)
    assert roofline.seed_vote_bound_s(w) == pytest.approx(
        max(w["bytes"] / 3.35e12, w["comparisons"] / (132 * 64 * 1.98e9)))


def test_seed_vote_work_with_a_shorter_bucket_key_counts_key_matches():
    # k = 2 bucketed by the first base (kb = 1): bucket A holds the sorted
    # keys AC, AC, AG; bucket C holds CG
    keys_sorted = torch.tensor([1, 1, 2, 6], dtype=torch.int32)
    table = torch.tensor([0, 3, 4, 4, 4], dtype=torch.int32)
    flat = torch.from_numpy(codes("ACGT")[None])
    offs = torch.arange(3, dtype=torch.int32)
    w = roofline.seed_vote_work(flat, table, keys_sorted, offs, 2, 1, 1, 8,
                                4, False)
    # AC: 3 slots, 2 hits; CG: 1 slot, 1 hit; GT: none
    assert w["hits"] == 3
    assert w["bytes"] == 4 + 3 * 4 + 8 * 3 + 4 * 3 + 4 * 4 + 4 * 4
    assert w["comparisons"] == pytest.approx(3 * np.log2(3))


def test_share_is_none_without_device_time_and_counts_recorded_launches():
    assert roofline.share([1.0], 0.0, 0) is None
    assert roofline.share([], 1.0, 3) is None
    assert roofline.share([0.5, 0.5], 4.0, 2) == 25.0
    assert roofline.share([0.5, 0.5], 4.0, 5) == 25.0      # two kernels
    # the profiler kept one interval of two launches: half the bound
    assert roofline.share([0.5, 0.5], 1.0, 1) == 50.0


def fake_trace(monkeypatch, events):
    monkeypatch.setattr(tracing, "_events", lambda prof: events)
    return tracing.read(None)


def test_trace_busy_is_the_union_and_gaps_go_to_the_inner_span(
        monkeypatch):
    ms = 1_000_000
    ev = [("fusionbench.window", False, 0, 100 * ms),
          ("fusionbench.align_to_reference", False, 0, 60 * ms),
          ("fusionbench.oriented_sequences", False, 60 * ms, 100 * ms),
          ("fusionbench.genome.align", False, 66 * ms, 80 * ms),
          ("fusionbench.genome.align", True, 66 * ms, 80 * ms),
          ("seed_block_max_kernel<1>", True, 10 * ms, 20 * ms),
          ("Memcpy HtoD", True, 15 * ms, 30 * ms),
          ("Memcpy DtoH", True, 65 * ms, 66 * ms),
          ("seed_vote_warp_kernel<true>", True, 72 * ms, 74 * ms),
          ("cpu op", False, 1 * ms, 2 * ms),
          ("after", True, 120 * ms, 130 * ms)]
    tr = fake_trace(monkeypatch, ev)
    assert tr.window_s == pytest.approx(0.1)
    # busy [10, 30] + [65, 66] + [72, 74]; gaps by their midpoints
    assert tr.busy_s == pytest.approx(0.023)
    assert tr.device_s("seed_block_max_kernel") == pytest.approx(0.01)
    assert tr.device_s("Memcpy") == pytest.approx(0.016)
    assert tr.count("seed_block_max_kernel", "seed_vote") == 2
    assert tr.idle_by_span["align_to_reference"] == pytest.approx(0.045)
    assert tr.idle_by_span["genome.align"] == pytest.approx(0.006)
    assert tr.idle_by_span["oriented_sequences"] == pytest.approx(0.026)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "Memcpy HtoD"
    assert len(bd["idle_gaps"]) == 3
    read = registry.reader("device.idle_share").read
    assert read({"trace": tr}) == pytest.approx(77.0)


def test_stage_readers_sum_counters_per_million_pairs():
    ctx = {"pairs": 500_000,
           "counters": [{"time.anchor_align_s": 1.0, "time.rescue_s": 0.5,
                         "time.mate_rescue_s": 0.25, "time.homolog_s": 9.0,
                         "time.blocks_s": 0.1, "time.report_s": 0.2},
                        {"time.anchor_align_s": 2.0, "time.rescue_s": 0.5,
                         "time.mate_rescue_s": 0.25, "time.homolog_s": 9.0,
                         "time.consensus_s": 0.2, "reads": 7}]}
    got = {m: registry.reader(m).read(ctx) for m in registry.names("metrics")
           if m.startswith("stage.")}
    assert got == pytest.approx({"stage.anchor_align_s_per_mpair": 6.0,
                                 "stage.rescue_s_per_mpair": 2.0,
                                 "stage.mate_rescue_s_per_mpair": 1.0,
                                 "stage.calling_s_per_mpair": 1.0})
    assert registry.reader("stage.rescue_s_per_mpair").read(
        {"pairs": 0, "counters": []}) is None


@pytest.mark.parametrize("read,ref,want", [
    ("ACGTACGTAC", "TTACGTACGTACTT", 10),          # exact
    ("ACGTTCGTAC", "TTACGTACGTACTT", 5),           # one mismatch: 9 - 4
    ("AAAAACCCCCGGGGGTTTTT", "AAAAACCCCCTTGGGGGTTTTT", 12),  # 2-base gap
    ("ACGT", "TTTT", 1),
    ("NNNN", "ACGT", 0),
])
def test_reference_scores_known_alignments(read, ref, want):
    r = torch.from_numpy(codes(read)[None])
    f = torch.from_numpy(codes(ref)[None])
    assert int(reference.sw_best(r, f)[0]) == want


def test_reference_takes_the_better_strand_and_saturates():
    ref = torch.from_numpy(codes("GGGGACGTTTGCAGGGG")[None])
    rc = reference.revcomp(codes("ACGTTTGCA")[None])
    assert reference.both_strands_best(rc, ref, "cpu")[0] == 9
    assert reference.both_strands_best(rc, ref, "cpu", clamp=(-8, 7))[0] == 7


def test_windows_pad_past_the_sequence():
    w = reference.windows(codes("ACGTACGT"), np.array([0, 5]),
                          np.array([1, 7]), 2)
    assert w.tolist() == [[5, 5, 0, 1, 2, 3, 5], [3, 0, 1, 2, 3, 5, 5]]


def test_decide_needs_every_number_within_its_limit():
    ok, checks = judge.decide({"a": 0.0, "b": 3.0}, {"a": 0, "b": 4})
    assert ok and checks["b"] == {"value": 3.0, "limit": 4}
    assert not judge.decide({"a": 1.0}, {"a": 0})[0]
    assert not judge.decide({"a": 0.0}, {"a": 0, "b": 1})[0]
    assert not judge.decide({"a": None}, {"a": 0})[0]


def test_shortfall_reads_the_widest_gap_and_the_share_of_due_reads():
    best = np.array([101, 101, 40, 29, 60])
    score = np.array([101, 96, 36, 0, 57])
    # due: best >= 30 (the fourth is not); short by more than 4: one (5;
    # the third falls short by 4, the margin)
    assert judge._shortfall(best, score) == (5.0, 0.25)
    assert judge._shortfall(best, best // 2) == (51.0, 1.0)
    assert judge._shortfall(np.array([10]), np.array([0])) == (0.0, 0.0)


def test_records_from_arrays_and_from_a_stand_in():
    from types import SimpleNamespace
    res = SimpleNamespace(score=np.array([5, 6, 7]),
                          mapped=np.array([1, 0, 1], np.int8),
                          ref_start=np.array([0, 1, 2]),
                          ref_end=np.array([9, 9, 9]))
    rec = judge._at(res, np.array([0, 2, 5]))
    assert rec["score"].tolist() == [5, 7, 0]       # past the end: none
    assert rec["mapped"].tolist() == [True, True, False]

    class StandIn:
        def at(self, idx):
            return {"score": idx * 10}
    assert judge._at(StandIn(), np.array([1, 2]))["score"].tolist() == [
        10, 20]


def test_fusion_numbers_on_hand_made_rows():
    from types import SimpleNamespace
    world = SimpleNamespace(anchor="A", partner="B", chrom="chrS",
                            break5=100)

    def row(bp, fusion="A--B", chrom="chrS"):
        return {"fusion": fusion, "anchor_breakpoint": bp,
                "partner_chrom": chrom}
    bulk = [[(True, [row(103)])], [(True, [row(100), row(7, "A--C")])]]
    got = judge.fusion_numbers(world, bulk)
    assert got == {"fusion_missed": 0.0, "fusion_bp_err": 3.0,
                   "false_calls": 1.0}
    got = judge.fusion_numbers(world, [[(True, [row(100, chrom="chrX")])]])
    assert got["fusion_missed"] == 1.0 and got["fusion_bp_err"] == 0.0
    # a plate: cells 0 and 2 carry the fusion; one of them is missed, a
    # clean cell reports a row; over two calls, 1 of 4 fusion cells missed
    plate = [(True, [row(100)]), (False, [row(90)]), (True, []),
             (False, [])]
    whole = [(True, [row(100)]), (False, []), (True, [row(101)]),
             (False, [])]
    got = judge.fusion_numbers(world, [plate, whole])
    assert got == {"fusion_missed": 0.25, "fusion_bp_err": 1.0,
                   "false_calls": 1.0}
    entry = registry.entry("plate")
    sample = SimpleNamespace(cell_offsets=np.array([0, 5, 10, 15]),
                             fusion_cells=np.array([0, 2]))
    assert entry.units(sample, {"cell000": [row(100)]}) == [
        (True, [row(100)]), (False, []), (True, [])]
    assert entry.units(sample, None) == [(True, []), (False, []),
                                         (True, [])]
