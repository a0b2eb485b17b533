"""A run of the harness past its look for a card (on the CPU, at a tiny
size), with the timed path sound and then broken underneath: ``correct``
comes out true once, and false for each fault the cells can have — an
answer altered where it is produced, records scored short, half of the
batch left out, the calling dropped in half of a plate's cells, a fusion
call moved — and for the control, which runs through the same harness and
the same comparison."""

import dataclasses

import numpy as np
import pytest

from fusionbench import harness


def run(root, cell="tiny.bulk"):
    return harness.run(cell, 2 ** 31 + 99, 0.5, False, "cpu", root=root)


@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.plate"])
def test_sound_run_is_correct(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "pairs_per_s",
                                   "peak_device_gib"}


def test_traced_run_reports_the_per_layer_metrics(tiny_root):
    out = harness.run("tiny.bulk", 5, 0.5, True, "cpu", root=tiny_root)
    assert out["correct"], out["checks"]
    # no card: no device time, so no roofline and no idle share
    assert set(out["metrics"]) == {"stage.anchor_align_s_per_mpair",
                                   "stage.rescue_s_per_mpair",
                                   "stage.mate_rescue_s_per_mpair",
                                   "stage.calling_s_per_mpair"}
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def _scores_up(fn):
    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        return dataclasses.replace(res, score=np.where(
            res.mapped, res.score + 1, res.score).astype(res.score.dtype))
    return wrapped


def test_an_anchored_record_altered_where_made_fails(tiny_root, monkeypatch):
    from anchored_fusion_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "align_to_reference",
                        _scores_up(pipeline.align_to_reference))
    out = run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["anchor_overclaim"]["value"] == 1


def test_a_genome_record_altered_where_made_fails(tiny_root, monkeypatch):
    from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
    monkeypatch.setattr(GenomeAlignerXL, "align",
                        _scores_up(GenomeAlignerXL.align))
    out = run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["xl_overclaim"]["value"] == 1


def _scores_halved(fn):
    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        return dataclasses.replace(res, score=(res.score // 2).astype(
            res.score.dtype))
    return wrapped


def test_anchored_records_scored_short_fail(tiny_root, monkeypatch):
    # every record half its score: not a read dropped, the widest gap stays
    # under its limit, the share of short records does not
    from anchored_fusion_tpu_torch import pipeline
    monkeypatch.setattr(pipeline, "align_to_reference",
                        _scores_halved(pipeline.align_to_reference))
    out = run(tiny_root)
    assert not out["correct"]
    c = out["checks"]
    assert c["anchor_gap"]["value"] <= c["anchor_gap"]["limit"]
    assert c["anchor_short_share"]["value"] > 0.9


def test_half_the_batch_left_out_fails(tiny_root, monkeypatch):
    from anchored_fusion_tpu_torch.io.fastq import ReadBatch
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    orig = FusionPipeline.call_gene

    def half(self, gene, codes, reads, *a, **kw):
        n = reads.n_pairs // 2
        return orig(self, gene, codes, ReadBatch(
            reads.names[:n], reads.seq[:n], reads.length[:n]), *a, **kw)
    monkeypatch.setattr(FusionPipeline, "call_gene", half)
    out = run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["anchor_gap"]["value"] >= 30


def test_half_the_cells_left_out_fails(tiny_root, monkeypatch):
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    orig = FusionPipeline.call_gene_cells

    def half(self, gene, codes, cells, *a, **kw):
        keep = dict(list(cells.items())[:len(cells) // 2])
        return orig(self, gene, codes, keep, *a, **kw)
    monkeypatch.setattr(FusionPipeline, "call_gene_cells", half)
    out = run(tiny_root, "tiny.plate")
    assert not out["correct"]
    assert out["checks"]["fusion_missed"]["value"] == 0.5
    assert out["checks"]["anchor_gap"]["value"] >= 30


def test_calling_dropped_in_half_the_cells_fails_by_fusion_missed_alone(
        tiny_root, monkeypatch):
    # the batched anchored pass and every cell's records stay whole; the
    # first half of each plate's cells report no rows
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline
    orig = FusionPipeline._call_stages

    def dropped(self, gene, codes, reads, res, prefix, *a, **kw):
        r = orig(self, gene, codes, reads, res, prefix, *a, **kw)
        if prefix.endswith(("cell000", "cell001")):
            r = dataclasses.replace(r, rows=[])
        return r
    monkeypatch.setattr(FusionPipeline, "_call_stages", dropped)
    out = run(tiny_root, "tiny.plate")
    assert not out["correct"]
    bad = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert bad == {"fusion_missed"}
    assert out["checks"]["fusion_missed"]["value"] == 0.5


def test_a_fusion_call_moved_fails(tiny_root, monkeypatch):
    from anchored_fusion_tpu_torch import pipeline
    write = pipeline.write_final_fusion

    def moved(*a, **kw):
        rows = write(*a, **kw)
        for r in rows:
            r["anchor_breakpoint"] = int(r["anchor_breakpoint"]) + 10
        return rows
    monkeypatch.setattr(pipeline, "write_final_fusion", moved)
    out = run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["fusion_bp_err"]["value"] == 10


def control(root, cell, seed, device="cpu"):
    return harness.run(cell, seed, 0.0, False, device, root=root,
                       control=True)


@pytest.mark.parametrize("cell", ["tiny.bulk", "tiny.plate"])
def test_the_control_comes_out_not_correct(tiny_root, cell):
    for seed in (3, 4, 5):
        got = control(tiny_root, cell, seed)
        c = got["checks"]
        assert not got["correct"] and got["attempted"] == 2 - (
            cell == "tiny.plate")
        for n in ("anchor_gap", "anchor_short_share", "xl_gap",
                  "xl_short_share", "fusion_missed"):
            assert c[n]["value"] > c[n]["limit"], n
        assert c["anchor_short_share"]["value"] == 1.0
        assert c["fusion_missed"]["value"] == 1.0


@pytest.mark.cuda
def test_sound_run_and_control_on_the_card(tiny_root, card):
    out = harness.run("tiny.bulk", 17, 0.5, True, card, root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert not control(tiny_root, "tiny.bulk", 17, card)["correct"]
