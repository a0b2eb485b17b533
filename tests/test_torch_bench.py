"""The port's bench harnesses and last library leftovers against the JAX
package's, on the CPU: ``diag_match_counts``, ``encode_dna_native``, the
downsampler, the positive-asset generator, the negative-mining cohort and
harness, the surrogate genome and the real-data depth ladder.

The surrogate and ``real_depth`` run on a generated sample in wgsim's form,
made by ``chip_smoke.wgsim_sample`` (the sample of chip_smoke.py's bench
phase, at ~1,500 pairs instead of 11,258): the reference tool's bundled
sample is not shipped.
"""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anchored_fusion_tpu.bench import downsample as jdown
from anchored_fusion_tpu.bench import make_positive_assets as jpos
from anchored_fusion_tpu.bench import negative_scale as jneg
from anchored_fusion_tpu.bench import real_depth as jrd
from anchored_fusion_tpu.bench import surrogate as jsur
from anchored_fusion_tpu_torch.bench import downsample as tdown
from anchored_fusion_tpu_torch.bench import make_positive_assets as tpos
from anchored_fusion_tpu_torch.bench import negative_scale as tneg
from anchored_fusion_tpu_torch.bench import real_depth as trd
from anchored_fusion_tpu_torch.bench import surrogate as tsur

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_PAIRS = 1_500


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads in this process while the module runs: the
    tests share the host with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------- leftovers


def test_diag_match_counts_matches_jax():
    from anchored_fusion_tpu.ops import diagonal as jdiag
    from anchored_fusion_tpu_torch.ops import diagonal as tdiag
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 5, 700).astype(np.int8)          # N included
    reads = np.full((9, 64), 5, np.int8)
    for i in range(9):
        lo = int(rng.integers(0, 640))
        n = int(rng.integers(20, 65))
        reads[i, :n] = ref[lo:lo + n]
    reads[3, 5] = 4
    reads[4] = rng.integers(0, 4, 64)
    want = np.asarray(jdiag.diag_match_counts(jnp.asarray(reads),
                                              jnp.asarray(ref)))
    got = tdiag.diag_match_counts(torch.from_numpy(reads), ref)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.arange(-3, 800, dtype=np.int32)
    np.testing.assert_array_equal(
        tdiag.diag_index_to_ref_offset(torch.from_numpy(idx), 64).numpy(),
        np.asarray(jdiag.diag_index_to_ref_offset(jnp.asarray(idx), 64)))


def test_encode_dna_native_matches_jax():
    from anchored_fusion_tpu.io import native as jnat
    from anchored_fusion_tpu_torch.io import native as tnat
    data = b"ACGTacgtNnRYKMSWBDHVryk-.*ACGTTGCA\x00\xff" * 7
    want = jnat.encode_dna_native(data)
    got = tnat.encode_dna_native(data)
    assert want is not None and got is not None
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert len(tnat.encode_dna_native(b"")) == 0


def test_downsample_matches_jax(tmp_path):
    from anchored_fusion_tpu_torch.bench.simulate import write_fastq_pair
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    rng = np.random.default_rng(12)
    names = [f"p{i}" for i in range(301)]
    r1 = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(n)))
          for n in rng.integers(60, 101, 301)]
    r2 = ["".join("ACGTN"[c] for c in rng.integers(0, 5, 101))
          for _ in names]
    p1, p2 = str(tmp_path / "s_1.fastq.gz"), str(tmp_path / "s_2.fastq.gz")
    write_fastq_pair(p1, p2, names, r1, r2)
    rb = read_fastq_pair(p1, p2)
    for frac, seed in ((0.5, 1), (0.3, 7)):
        want = jdown.downsample_batch(rb, frac, seed)
        got = tdown.downsample_batch(rb, frac, seed)
        assert got.names == want.names
        np.testing.assert_array_equal(got.seq, want.seq)
        np.testing.assert_array_equal(got.length, want.length)
    want = jdown.halving_ladder(p1, p2, str(tmp_path / "j"), steps=3, seed=4)
    got = tdown.halving_ladder(p1, p2, str(tmp_path / "t"), steps=3, seed=4)
    assert [n for _, _, n in got] == [n for _, _, n in want] == [150, 75, 38]
    for (a1, a2, _), (b1, b2, _) in zip(got, want):
        ta, tb = read_fastq_pair(a1, a2), read_fastq_pair(b1, b2)
        assert ta.names == tb.names
        np.testing.assert_array_equal(ta.seq, tb.seq)
        np.testing.assert_array_equal(ta.length, tb.length)


def test_positive_assets_reproduce_the_shipped_file(tmp_path, capsys):
    out = tmp_path / "positive_samples.txt"
    tpos.main(["--out", str(out)])
    with open(os.path.join(REPO, "data", "positive_samples.txt"), "rb") as fh:
        assert out.read_bytes() == fh.read()
    assert "3381" in capsys.readouterr().out
    assert tpos.generate_rows(50, 1) == jpos.generate_rows(50, 1)


# ---------------------------------------------------------------- mining


def test_build_cohort_matches_jax():
    from anchored_fusion_tpu.bench.simulate import make_synthetic_genome
    sg = make_synthetic_genome(np.random.default_rng(2), n_genes=12,
                               exons_per_gene=(3, 6), exon_len=(200, 400))
    want = jneg.build_cohort(np.random.default_rng(5), sg, 3000, 0.05)
    got = tneg.build_cohort(np.random.default_rng(5), sg, 3000, 0.05)
    assert got[1] == want[1] == 150
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])


def test_negative_scale_matches_jax(capsys):
    argv = ["--reads", "20000", "--genes", "40", "--chunk", "8192"]
    assert jneg.main(argv) == 0
    want = _json_line(capsys)
    assert tneg.main(argv + ["--device", "cpu"]) == 0
    got = _json_line(capsys)
    assert set(got) == set(want)
    for key in ("n_reads", "n_chimeric", "genome_mbp", "genes",
                "chunk_reads", "pair_depth", "max_rows", "rows_mined",
                "yield_per_chimeric"):
        assert got[key] == want[key], key
    assert got["rows_mined"] == 307 and got["n_chimeric"] == 400


def test_bench_harnesses_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    from anchored_fusion_tpu_torch.bench import depth_sweep
    for main, argv in ((tneg.main, ["--reads", "1000"]),
                       (depth_sweep.main, ["--json-only"]),
                       (trd.main, ["--json-only"])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)


# ---------------------------------------------------------------- surrogate


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("wgsim"))
    return _chip_smoke().wgsim_sample(d, seed=21, n_pairs=SAMPLE_PAIRS)


def _genome_equal(got, want):
    assert list(got.genome.names) == list(want.genome.names)
    for f in ("starts", "lengths", "seq"):
        np.testing.assert_array_equal(getattr(got.genome, f),
                                      getattr(want.genome, f))
    assert ({n: dataclasses.asdict(g) for n, g in got.genes.items()}
            == {n: dataclasses.asdict(g) for n, g in want.genes.items()})
    assert got.gtf_dic == want.gtf_dic
    assert got.gene_rows() == want.gene_rows()


def test_surrogate_matches_jax(sample, tmp_path, capsys):
    from anchored_fusion_tpu.io.fastq import read_fastq_pair
    from anchored_fusion_tpu.io.fasta import read_fasta
    p = sample["paths"]
    reads = read_fastq_pair(p["fastq1"], p["fastq2"])
    assert reads.n_pairs == SAMPLE_PAIRS
    for name in reads.names[:50] + ["not_a_wgsim_read", "a_1_2_x_y_zz/1"]:
        assert tsur.parse_wgsim_name(name) == jsur.parse_wgsim_name(name)
    assert jsur.parse_wgsim_name(reads.names[0])[0] == "FUS000001.1"

    want = jsur.reconstruct_transcripts(reads)
    got = tsur.reconstruct_transcripts(reads)
    assert list(got) == list(want) and len(got) == 6
    for src in want:
        assert got[src].dtype == want[src].dtype
        np.testing.assert_array_equal(got[src], want[src])
    anchor = read_fasta(p["anchor"]).seq
    for src, cons in want.items():
        assert tsur.locate_junction(cons, anchor) == \
            jsur.locate_junction(cons, anchor)
    assert jsur.locate_junction(want["FUS000001.1"], anchor) == (3235, 3235)

    _genome_equal(tsur.build_surrogate_genome(anchor, got, seed=3),
                  jsur.build_surrogate_genome(anchor, want, seed=3))
    tsg, treads, tanc = tsur.surrogate_from_sample(p["fastq1"], p["fastq2"],
                                                   p["anchor"])
    jsg, jreads, janc = jsur.surrogate_from_sample(p["fastq1"], p["fastq2"],
                                                   p["anchor"])
    _genome_equal(tsg, jsg)
    assert treads.names == jreads.names
    np.testing.assert_array_equal(treads.seq, jreads.seq)
    np.testing.assert_array_equal(tanc.seq, janc.seq)

    outs = {}
    for tag, main in (("jax", jsur.main), ("port", tsur.main)):
        prefix = str(tmp_path / tag)
        assert main(["--fastq1", p["fastq1"], "--fastq2", p["fastq2"],
                     "--anchor", p["anchor"], "--out_prefix", prefix]) == 0
        outs[tag] = [open(prefix + ext).read()
                     for ext in ("_genome.fa", ".gtf")]
        outs[tag].append(capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert "ABL1" in outs["port"][1] and "BCR" in outs["port"][1]


def test_real_depth_matches_jax(sample, monkeypatch, capsys):
    import anchored_fusion_tpu.bench.surrogate as jsur_mod
    p = sample["paths"]
    real = jsur_mod.surrogate_from_sample
    # JAX's harness reads the bundled sample's fixed paths; point them here
    monkeypatch.setattr(jsur_mod, "surrogate_from_sample",
                        lambda *a, **k: real(p["fastq1"], p["fastq2"],
                                             p["anchor"]))
    assert jrd.main(["--steps", "1", "--json-only"]) == 0
    want = _json_line(capsys)
    assert trd.main(["--steps", "1", "--fastq1", p["fastq1"], "--fastq2",
                     p["fastq2"], "--anchor", p["anchor"], "--device", "cpu",
                     "--json-only"]) == 0
    got = _json_line(capsys)
    assert got == want
    assert got["ladder"][0]["detected"]
