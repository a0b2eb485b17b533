"""The port's single-cell path against the JAX package's on the same seeded
inputs (``device="cpu"``): ``FusionPipeline.call_gene_cells`` (rows,
non-time counters, ``homo_genes`` and prediction files), with cells of two
row widths in one padded batch and with failing cells, ``discover_pairs``,
and the single-cell CLI with the filter off (byte-identical per-cell and
aggregate files) and on with a shared JAX-trained model (scores within
2e-4, tests/test_models.py's tolerance).
"""

import csv
import filecmp
import io
import json
import os

import numpy as np
import pytest
import torch

from anchored_fusion_tpu.annotate.exon_index import ExonIndex as JExonIndex
from anchored_fusion_tpu.bench.simulate import (
    make_synthetic_genome, fuse_transcripts, simulate_pairs, write_fastq_pair,
    write_gtf, write_fasta)
from anchored_fusion_tpu.config import (
    FilterModelConfig as JFilterModelConfig, PipelineConfig as JPipelineConfig)
from anchored_fusion_tpu.io.fastq import ReadBatch as JReadBatch
from anchored_fusion_tpu.ops.encode import encode_ascii
from anchored_fusion_tpu.pipeline import FusionPipeline as JFusionPipeline
from anchored_fusion_tpu_torch.annotate.exon_index import (
    ExonIndex as TExonIndex)
from anchored_fusion_tpu_torch.config import (
    FilterModelConfig, PipelineConfig as TPipelineConfig)
from anchored_fusion_tpu_torch.io.fasta import Reference as TReference
from anchored_fusion_tpu_torch.io.fastq import ReadBatch as TReadBatch
from anchored_fusion_tpu_torch.pipeline import FusionPipeline as TFusionPipeline

SMALL = dict(block_dim=32, embed_dim=32, class_dim=32, transformer_dim=16,
             transformer_ff=32, batch_size=32, learning_rate=1e-3,
             num_epochs=1)


@pytest.fixture(scope="module")
def synth():
    """The world of tests/test_pipeline_synthetic.py."""
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               exons_per_gene=(3, 5), exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:2]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    return sg, anchor, partner, tx_a, fusion, break5


def _cell(tx, n, seed, width=128):
    """``n`` pairs of 101 bp from ``tx`` in ``width``-wide rows."""
    names, r1, r2 = simulate_pairs(np.random.default_rng(seed), tx, n,
                                   name_prefix=f"C{seed}")
    seq = np.stack([
        np.stack([encode_ascii(x, length=width), encode_ascii(y, length=width)])
        for x, y in zip(r1, r2)])
    return names, seq, np.full((len(names), 2), 101, np.int32)


def _junk():
    """A cell whose stages raise: its length array has the wrong shape."""
    return (["x"], np.full((1, 2, 128), 4, np.int8),
            np.full((1, 3), 101, np.int32))


def _pipes(sg):
    j = JFusionPipeline(sg.genome, JExonIndex(sg.gtf_dic, inject_loci=False),
                        sg.gene_rows(),
                        JPipelineConfig(filter_false_positive=False))
    g = sg.genome
    t = TFusionPipeline(TReference(list(g.names), g.starts.copy(),
                                   g.lengths.copy(), g.seq.copy()),
                        TExonIndex(sg.gtf_dic, inject_loci=False),
                        sg.gene_rows(),
                        TPipelineConfig(filter_false_positive=False),
                        device="cpu")
    return j, t


def _timeless(c):
    return {k: v for k, v in c.items()
            if k != "wall_s" and not k.startswith("time.")}


def _cells_both(sg, anchor, cells, tmp_path, prefixes=None):
    """call_gene_cells in both packages on the same cells (name -> arrays);
    returns (jax results, port results, jax failures, port failures)."""
    jpipe, tpipe = _pipes(sg)
    anchor_codes = encode_ascii(anchor.transcript(sg.genome))
    out = []
    for tag, pipe, rb in (("jax", jpipe, JReadBatch), ("torch", tpipe,
                                                       TReadBatch)):
        fails = []
        prefix = (prefixes or {}).get

        def prefix_for(c, tag=tag, prefix=prefix):
            return prefix(c) or str(tmp_path / f"{tag}_{c}")
        res = pipe.call_gene_cells(
            anchor.name, anchor_codes, {c: rb(*a) for c, a in cells.items()},
            out_prefix_for=prefix_for, failures=fails)
        out.append((res, fails))
    (want, jf), (got, tf) = out
    assert list(got) == list(want)
    for cell in want:
        assert got[cell].rows == want[cell].rows, cell
        assert got[cell].homo_genes == want[cell].homo_genes, cell
        assert _timeless(got[cell].counters) == _timeless(want[cell].counters)
        assert "time.anchor_align_s" in got[cell].counters
        if prefixes is None or cell not in prefixes:
            for suffix in ("_predictions.txt", "_predictions_abridged.txt"):
                assert filecmp.cmp(str(tmp_path / f"jax_{cell}{suffix}"),
                                   str(tmp_path / f"torch_{cell}{suffix}"),
                                   shallow=False), (cell, suffix)
    return want, got, jf, tf


@pytest.mark.parametrize("widths", [(128, 128, 128), (128, 160, 160)],
                         ids=["one_width", "two_widths"])
def test_call_gene_cells_matches_jax(synth, tmp_path, widths):
    """The fixture of tests/test_pipeline_synthetic.py's
    test_call_gene_cells_matches_serial, and the same cells with two of
    them in 160-wide rows: the batch is padded to the widest cell, and the
    port must equal JAX's batched result."""
    sg, anchor, partner, tx_a, fusion, break5 = synth
    cells = {"cellA": _cell(fusion, 60, 1, widths[0]),
             "cellB": _cell(fusion, 60, 2, widths[1]),
             "cellC": _cell(fusion, 40, 3, widths[2]),
             "cellW": _cell(tx_a, 50, 4, widths[0])}
    want, got, _, _ = _cells_both(sg, anchor, cells, tmp_path)
    assert list(got) == ["cellA", "cellB", "cellC", "cellW"]
    called = {c for c, r in got.items()
              if any(x["fusion"] == f"{anchor.name}--{partner.name}"
                     and x["anchor_breakpoint"] == break5 for x in r.rows)}
    assert "cellW" not in called and called
    # each cell's share of the one batch's time, by rows
    t = [got[c].counters["time.anchor_align_s"] for c in got]
    assert t[0] == pytest.approx(t[1], abs=1e-3)


def test_call_gene_cells_failure_isolation(synth, tmp_path, monkeypatch):
    """A cell that fails before the homolog stage and one that fails after
    it (its report cannot be written) are recorded; the good cells equal
    JAX's.  The homolog mask is computed by the first cell that reaches the
    stage and again after that cell failed, then reused."""
    import anchored_fusion_tpu.pipeline as jpipeline
    import anchored_fusion_tpu_torch.pipeline as tpipeline
    sg, anchor, partner, tx_a, fusion, break5 = synth
    calls = {"jax": 0, "torch": 0}
    for tag, mod in (("jax", jpipeline), ("torch", tpipeline)):
        real = mod.find_homolog_genes

        def counted(*a, tag=tag, real=real, **kw):
            calls[tag] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, "find_homolog_genes", counted)
    missing = str(tmp_path / "missing" / "late")
    cells = {"junk": _junk(), "late": _cell(fusion, 40, 5),
             "cellA": _cell(fusion, 60, 1), "cellB": _cell(tx_a, 30, 2)}
    want, got, jf, tf = _cells_both(sg, anchor, cells, tmp_path,
                                    prefixes={"late": missing})
    assert list(got) == ["cellA", "cellB"]
    strip = lambda fs: [(f["gene"], f["error"], f["attempts"]) for f in fs]  # noqa: E731
    assert strip(tf) == strip(jf)
    assert [f["gene"] for f in tf] == [f"{anchor.name}:junk",
                                       f"{anchor.name}:late"]
    assert all("Traceback" in f["traceback"] for f in tf)
    assert calls == {"jax": 2, "torch": 2}
    # without ``failures`` the first error propagates
    _, tpipe = _pipes(sg)
    with pytest.raises(ValueError):
        tpipe.call_gene_cells(anchor.name, encode_ascii(tx_a),
                              {"junk": TReadBatch(*_junk())})
    assert tpipe.call_gene_cells(anchor.name, encode_ascii(tx_a), {}) == {}


def test_discover_pairs_matches_jax(tmp_path):
    """The suffix set of tests/test_cli_singlecell.py, plus every suffix."""
    from anchored_fusion_tpu.cli.sc import discover_pairs as j_discover
    from anchored_fusion_tpu_torch.cli.sc import discover_pairs
    for f in ["a_1.fastq", "a_2.fastq", "b_1.fq.gz", "b_2.fq.gz",
              "c_1.fastq.gz", "lonely_1.fastq", "d_2.fastq", "e_1.fq",
              "e_2.fq", "f_1.fastq.gz", "f_2.fastq.gz", "g_1.txt", "g_2.txt",
              "h_1.fastq", "h_2.fq"]:
        (tmp_path / f).write_text("")
    got = discover_pairs(str(tmp_path))
    assert got == j_discover(str(tmp_path))
    assert [p[0] for p in got] == ["a", "b", "e", "f"]


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def sc_inputs(tmp_path_factory):
    """The cohort of tests/test_cli_singlecell.py (cellA with the fusion,
    cellB wild type) plus cellC with the fusion at lower depth, as
    .fastq.gz files."""
    d = tmp_path_factory.mktemp("sc")
    rng = np.random.default_rng(11)
    sg = make_synthetic_genome(rng, n_genes=6, exons_per_gene=(3, 5),
                               exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    tx_a, tx_p = anchor.transcript(sg.genome), partner.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:2]) - 100
    fusion = fuse_transcripts(tx_a, tx_p, break5, 60)
    cells = d / "cells"
    cells.mkdir()
    for cell, tx, n, pre in (("cellA", fusion, 220, "F"),
                             ("cellB", tx_a, 150, "W"),
                             ("cellC", fusion, 120, "G")):
        nm, r1, r2 = simulate_pairs(rng, tx, n, name_prefix=pre)
        write_fastq_pair(str(cells / f"{cell}_1.fastq.gz"),
                         str(cells / f"{cell}_2.fastq.gz"), nm, r1, r2)
    write_gtf(sg, str(d / "ann.gtf"))
    write_fasta({sg.genome.names[0]: sg.genome.fetch_str(
        "chr1", 1, sg.genome.total_length)}, str(d / "genome.fa"))
    write_fasta({f"NM_000001.1 {anchor.name}": tx_a}, str(d / "anchor.fasta"))
    (d / "names.txt").write_text(anchor.name + "\n")
    argv = ["--file_anchored_cds", str(d / "anchor.fasta"),
            "--gene_names", str(d / "names.txt"),
            "--fastq_dir", str(cells),
            "--file_ref_seq", str(d / "genome.fa"),
            "--file_ref_ann", str(d / "ann.gtf")]
    return argv, anchor, partner, break5


def _run_sc_both(sc_inputs, tmp_path, monkeypatch, extra):
    from anchored_fusion_tpu.cli import sc as jsc
    from anchored_fusion_tpu_torch.cli import sc

    monkeypatch.setenv("AFT_COMP_CACHE", "")
    argv, anchor, _, _ = sc_inputs
    out = {}
    for tag, main in (("jax", jsc.main),
                      ("port", lambda a: sc.main(a, device="cpu"))):
        folder = tmp_path / tag
        rc = main(argv + ["--out_folder", str(folder)] + extra)
        gene_dir = folder / anchor.name
        files = {}
        for p in sorted(gene_dir.rglob("*_predictions*.txt")):
            files[str(p.relative_to(gene_dir))] = p.read_text()
        out[tag] = (rc, files, folder)
    return out


def test_sc_cli_filter_off_byte_identical(sc_inputs, tmp_path, monkeypatch):
    _, anchor, partner, break5 = sc_inputs
    out = _run_sc_both(sc_inputs, tmp_path, monkeypatch,
                       ["--not_filter_false_positive"])
    (jrc, jfiles, _), (rc, files, folder) = out["jax"], out["port"]
    assert rc == jrc == 0
    name = f"{anchor.name}_fusion"
    assert sorted(files) == sorted(jfiles) == sorted(
        [f"{name}_gene_cell_predictions.txt",
         f"{name}_gene_cell_predictions_abridged.txt"]
        + [f"work_dir/{c}/{name}_predictions{s}.txt"
           for c in ("cellA", "cellB", "cellC") for s in ("", "_abridged")])
    assert files == jfiles
    rows = [r.split("\t") for r in
            files[f"{name}_gene_cell_predictions_abridged.txt"].splitlines()]
    hit = [r for r in rows[1:] if r[0] == f"{anchor.name}--{partner.name}"
           and r[2] == f"{anchor.name}:{break5}"]
    assert hit and hit[0][7] == "2" and hit[0][8] == "cellA;cellC"
    stats = json.loads((folder / "run_stats.json").read_text())["stats"]
    assert stats["kernel_launches"] == {"sw_align_fused": 0, "sw_end": 0}
    assert f"time.call:{anchor.name}_s" in stats
    assert not any(k.startswith("failures.") for k in stats)


def _tsv(text):
    return list(csv.reader(io.StringIO(text), delimiter="\t"))


def test_sc_cli_filter_on_shared_model(sc_inputs, tmp_path, monkeypatch):
    """The filter on with a JAX-trained model loaded by both CLIs: the
    aggregate files byte-identical, per-cell scores within 2e-4."""
    from anchored_fusion_tpu.cli import sc as jsc
    from anchored_fusion_tpu.models.train import train_filter_model as j_train
    from anchored_fusion_tpu_torch.cli import sc

    rng = np.random.default_rng(6)
    rows = []
    for _ in range(80):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 201))
        rows.append(s[:100] + "H" + s[101:])
    model = str(tmp_path / "shared.msgpack")
    j_train(rows[:40], rows[40:], JFilterModelConfig(**SMALL), model,
            verbose=False)
    monkeypatch.setattr(jsc, "PipelineConfig", lambda **kw: JPipelineConfig(
        filter_model=JFilterModelConfig(**SMALL), **kw))
    monkeypatch.setattr(sc, "PipelineConfig", lambda **kw: TPipelineConfig(
        filter_model=FilterModelConfig(**SMALL), **kw))
    out = _run_sc_both(sc_inputs, tmp_path, monkeypatch,
                       ["--not_train_filter_model", "--model_file", model])
    (jrc, jfiles, _), (rc, files, _) = out["jax"], out["port"]
    assert rc == jrc == 0 and sorted(files) == sorted(jfiles)
    scored = 0
    for path, text in files.items():
        got, want = _tsv(text), _tsv(jfiles[path])
        if "gene_cell" in path:
            assert text == jfiles[path], path
            continue
        assert len(got) == len(want) and got[0] == want[0]
        col = got[0].index("Natural_score")
        for g, w in zip(got[1:], want[1:]):
            assert g[:col] + g[col + 1:] == w[:col] + w[col + 1:]
            assert abs(float(g[col]) - float(w[col])) <= 2e-4
            scored += 1
    assert scored


def test_sc_cli_refuses_what_is_not_ported(sc_inputs, tmp_path):
    from anchored_fusion_tpu_torch.cli import sc

    argv, _, _, _ = sc_inputs
    base = argv + ["--out_folder", str(tmp_path / "out"),
                   "--not_filter_false_positive"]
    # the cluster flags reach the runtime, which here sees no coordinator
    from anchored_fusion_tpu_torch.parallel import distributed
    calls = []
    init = distributed.initialize
    distributed.initialize = lambda *a, **kw: calls.append((a, kw)) or init(
        *a, **kw)
    try:
        assert sc.main(argv + ["--out_folder", str(tmp_path / "cluster"),
                               "--not_filter_false_positive",
                               "--num_procs", "2"], device="cpu") == 0
    finally:
        distributed.initialize = init
    assert calls == [((None, 2, None), {"device": "cpu"})]
    empty = tmp_path / "empty"
    empty.mkdir()
    cut = argv[:argv.index("--fastq_dir") + 1] + [str(empty)] + \
        argv[argv.index("--fastq_dir") + 2:]
    assert sc.main(cut + ["--out_folder", str(tmp_path / "o2")],
                   device="cpu") == 1
    if not torch.cuda.is_available():
        # no device named and no CUDA: stop at once, write nothing
        assert sc.main(base) == sc.EXIT_NO_DEVICE
        assert sc.main(base + ["--gpu_number", "1"]) == sc.EXIT_NO_DEVICE
        assert not os.path.exists(tmp_path / "out")
