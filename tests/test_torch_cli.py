"""The port's CLI and its filter plumbing against the JAX package's, on the
same seeded inputs (``device="cpu"``): filter input rows, negative mining,
the native FASTQ codec, ``setup_filter`` from the shipped assets, and the
bulk CLI with the filter off (byte-identical prediction files) and on with a
shared JAX-trained model (scores within 2e-4, tests/test_models.py's
tolerance; every other column byte-identical).
"""

import csv
import io
import os
import types

import numpy as np
import pytest
import torch

from anchored_fusion_tpu.align.genome import GenomeAligner as JGenomeAligner
from anchored_fusion_tpu.annotate.exon_index import ExonIndex as JExonIndex
from anchored_fusion_tpu.bench.simulate import (
    make_synthetic_genome, fuse_transcripts, simulate_pairs, coverage_to_pairs,
    write_fastq_pair, write_fasta, write_gtf)
from anchored_fusion_tpu.call.candidates import Candidate as JCandidate
from anchored_fusion_tpu.config import (
    FilterModelConfig as JFilterModelConfig, PipelineConfig as JPipelineConfig)
from anchored_fusion_tpu.models import negative as jneg
from anchored_fusion_tpu.models.test_reads import (
    build_test_rows as j_rows, attach_scores as j_attach)
from anchored_fusion_tpu.ops.encode import encode_ascii
from anchored_fusion_tpu_torch.align.genome import GenomeAligner
from anchored_fusion_tpu_torch.annotate.exon_index import ExonIndex
from anchored_fusion_tpu_torch.call.candidates import Candidate
from anchored_fusion_tpu_torch.config import FilterModelConfig, PipelineConfig
from anchored_fusion_tpu_torch.io.fasta import Reference
from anchored_fusion_tpu_torch.models import negative as tneg
from anchored_fusion_tpu_torch.models.test_reads import (
    build_test_rows, attach_scores)

SMALL = dict(block_dim=32, embed_dim=32, class_dim=32, transformer_dim=16,
             transformer_ff=32, batch_size=32, learning_rate=1e-3,
             num_epochs=1)


def _port_genome(g):
    return Reference(list(g.names), g.starts.copy(), g.lengths.copy(),
                     g.seq.copy())


def _chimeras(sg, pairs, reps, start=0):
    """Reads of 50 bp of one gene's first exon then 51 bp of another's."""
    reads = []
    for na, nb in pairs:
        a = sg.genome.fetch_str("chr1", *sg.genes[na].exons[0])
        b = sg.genome.fetch_str("chr1", *sg.genes[nb].exons[0])
        for i in range(start, start + reps):
            reads.append(encode_ascii(a[10 + i:60 + i] + b[20 + i:71 + i],
                                      length=128))
    return reads


# ---------------------------------------------------------------- worlds


@pytest.fixture(scope="module")
def q_world():
    """The world of tests/test_training_data.py."""
    sg = make_synthetic_genome(np.random.default_rng(21), n_genes=6,
                               gene_prefix="Q")
    return sg, JExonIndex(sg.gtf_dic, inject_loci=False), \
        ExonIndex(sg.gtf_dic, inject_loci=False)


@pytest.fixture(scope="module")
def w_world():
    """The world of tests/test_filter_assets.py (loci >= 10 kb apart)."""
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               gene_prefix="W", intergenic=(3000, 5000))
    return sg, JExonIndex(sg.gtf_dic, inject_loci=False), \
        ExonIndex(sg.gtf_dic, inject_loci=False)


def _mine_both(sg, jidx, tidx, seqs, genes, **kw):
    want = jneg.mine_negative_junctions(
        JGenomeAligner(sg.genome), sg.genome, jidx, seqs, genes, **kw)
    tg = _port_genome(sg.genome)
    got = tneg.mine_negative_junctions(
        GenomeAligner(tg, device="cpu"), tg, tidx, seqs, genes, **kw)
    return want, got


def test_mine_negatives_equal_on_training_data_world(q_world):
    sg, jidx, tidx = q_world
    a = sg.genome.fetch_str("chr1", *sg.genes["Q1"].exons[0])
    reads = _chimeras(sg, [("Q1", "Q4")], 6)
    reads += [encode_ascii(a[i:101 + i], length=128) for i in range(6)]
    seqs = np.stack(reads)
    want, got = _mine_both(sg, jidx, tidx, seqs, ["Q0"],
                           min_locus_distance=1000)
    assert got == want and len(got) == 1
    assert got[0].split("\t")[1] == "Q1->Q4"
    # a target gene drops the pair in both
    want, got = _mine_both(sg, jidx, tidx, seqs[:1], ["Q1"],
                           min_locus_distance=1000)
    assert got == want == []


def test_mine_negatives_equal_on_filter_assets_world(w_world):
    """Several gene pairs, background reads and chunked streaming: the same
    rows in the same order."""
    sg, jidx, tidx = w_world
    pairs = (("W1", "W4"), ("W2", "W5"), ("W3", "W5"), ("W4", "W2"),
             ("W5", "W1"), ("W3", "W1"))
    reads = _chimeras(sg, pairs, 3) + _chimeras(sg, pairs[::-1], 3, start=5)
    rng = np.random.default_rng(4)
    g = sg.genome.seq
    for s in rng.integers(0, len(g) - 101, 1200):
        reads.append(np.concatenate([g[s:s + 101],
                                     np.full(27, 5, np.int8)]))
    seqs = np.stack(reads)
    seqs = seqs[rng.permutation(len(seqs))]
    want, got = _mine_both(sg, jidx, tidx, seqs, ["W0"], chunk_reads=700)
    assert got == want and len(got) >= 3


def test_inspect_name_equal():
    for a, b in (("IGH", "ABL1"), ("ENSG1", "X"), ("BCRX", "BCRY"),
                 ("BCR", "ABL1"), ("AB", "ABC"), ("ABL1", "ABL2")):
        assert tneg._inspect_name(a, b) == jneg._inspect_name(a, b)


def test_build_test_rows_and_attach_scores_equal(q_world):
    sg, jidx, tidx = q_world
    anchor_seq = sg.genes["Q1"].transcript(sg.genome)
    tg = _port_genome(sg.genome)
    specs = []
    for gname, off in (("Q3", 80), ("Q4", 30), ("Q2", 150), ("Q5", 5)):
        obp = sg.genes[gname].exons[0][0] + off
        for type_ in ("MS", "SM"):
            for strand in ("+", "-"):
                for tbp in (300, 40, len(anchor_seq) - 20):
                    specs.append((type_, tbp, obp, strand))
    specs += specs[:5]                       # duplicates collapse to one row

    def cands(cls):
        out = []
        for type_, tbp, obp, strand in specs:
            c = cls(type_)
            c.add_reads(tbp, ["chr1", obp, strand, 0, 0], "A" * 40, "C" * 40,
                        "", 3, ["s1"], ["b1"])
            out.append(c)
        return out

    jc, tc = cands(JCandidate), cands(Candidate)
    want = j_rows(jc, anchor_seq, sg.genome, jidx)
    got = build_test_rows(tc, anchor_seq, tg, tidx)
    assert got == want
    rows, row_cand = got
    assert len(rows) < len(specs) and all(len(r) == 201 for r in rows)
    scores = list(np.random.default_rng(2).random(len(rows)))
    assert (attach_scores(tc, row_cand, scores)
            == j_attach(jc, row_cand, scores))


# ---------------------------------------------------------------- FASTQ


@pytest.mark.parametrize("suffix", [".fastq", ".fastq.gz"])
def test_native_codec_matches_python_and_jax(tmp_path, suffix):
    from anchored_fusion_tpu.io.fastq import read_fastq_pair as j_read
    from anchored_fusion_tpu_torch.io import fastq, native
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair

    assert native.get_lib() is not None, "the C compiler should build codec.c"
    assert os.path.dirname(native.build()) == native.BUILD_DIR
    rng = np.random.default_rng(3)
    tx = "".join("ACGTN"[i] for i in rng.integers(0, 5, 3000)).lower()
    names, r1, r2 = simulate_pairs(rng, tx, 300, read_len=150,
                                   name_prefix="rd")
    r1 = [s[:int(n)] for s, n in zip(r1, rng.integers(20, 151, len(r1)))]
    p1, p2 = str(tmp_path / f"a_1{suffix}"), str(tmp_path / f"a_2{suffix}")
    write_fastq_pair(p1, p2, [f"{n} extra\tfield" for n in names], r1, r2)
    want = j_read(p1, p2)
    got = read_fastq_pair(p1, p2)
    assert got.names == want.names == names
    np.testing.assert_array_equal(got.seq, want.seq)
    np.testing.assert_array_equal(got.length, want.length)
    data = fastq._read_raw(p1)
    py = fastq._parse_python(data)
    nat = native.decode_fastq_native(data)
    assert nat[0] == py[0]
    for a, b in zip(nat[1:], py[1:]):
        np.testing.assert_array_equal(a, b)
    for width in (64, 256):
        nat, py = (native.decode_fastq_native(data, width),
                   fastq._parse_python(data, width))
        np.testing.assert_array_equal(nat[1], py[1])
        np.testing.assert_array_equal(nat[2], py[2])


def test_codec_rejection_is_reported(tmp_path, capsys):
    """A buffer the codec rejects (a record not starting with '@') is parsed
    in Python, as the JAX package does, and says so on stderr."""
    from anchored_fusion_tpu.io.fastq import read_fastq_pair as j_read
    from anchored_fusion_tpu_torch.io import fastq
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair

    paths = []
    for mate in (1, 2):
        p = tmp_path / f"r_{mate}.fastq"
        p.write_text(">r1\nACGTN\n+\nIIIII\n@r2\nGGA\n+\nIII\n")
        paths.append(str(p))
    got = read_fastq_pair(*paths)
    assert "rejected" in capsys.readouterr().err
    want = j_read(*paths)
    assert got.names == want.names == ["r1", "r2"]
    np.testing.assert_array_equal(got.seq, want.seq)
    np.testing.assert_array_equal(got.length, want.length)
    py = fastq._parse_python(fastq._read_raw(paths[0]))
    np.testing.assert_array_equal(got.seq[:, 0], py[1])


# ---------------------------------------------------------------- setup_filter


def test_setup_filter_mines_the_same_negatives(w_world, tmp_path, monkeypatch):
    """BASELINE config 3 from shipped assets, as tests/test_filter_assets.py
    drives it: both packages mine and persist the same negatives file."""
    from anchored_fusion_tpu.cli.common import setup_filter as j_setup
    from anchored_fusion_tpu.pipeline import FusionPipeline as JFusionPipeline
    from anchored_fusion_tpu_torch.cli.common import setup_filter
    from anchored_fusion_tpu_torch.pipeline import FusionPipeline

    monkeypatch.chdir(tmp_path)
    sg, jidx, tidx = w_world
    reads = _chimeras(sg, (("W1", "W4"), ("W2", "W5"), ("W3", "W5"),
                           ("W4", "W2")), 3)
    a = sg.genome.fetch_str("chr1", *sg.genes["W1"].exons[0])
    reads += [encode_ascii(a[i:101 + i], length=128) for i in range(6)]
    seqs = np.stack(reads)
    out = {}
    for tag in ("jax", "port"):
        args = types.SimpleNamespace(
            not_filter_false_positive=False, not_train_filter_model=False,
            model_file=str(tmp_path / f"{tag}.msgpack"),
            positive_samples="./data/positive_samples.txt",
            negative_samples="./Model/negative_samples.txt",
            homo_gene_file="./data/homo_gene.npy")
        mdir = str(tmp_path / tag)
        if tag == "jax":
            pipe = JFusionPipeline(sg.genome, jidx, sg.gene_rows(),
                                   JPipelineConfig(filter_model=JFilterModelConfig(**SMALL)))
            filt = j_setup(args, pipe, jidx, seqs, ["W0"], mdir)
        else:
            tg = _port_genome(sg.genome)
            pipe = FusionPipeline(tg, tidx, sg.gene_rows(),
                                  PipelineConfig(filter_model=FilterModelConfig(**SMALL)),
                                  device="cpu")
            filt = setup_filter(args, pipe, tidx, seqs, ["W0"], mdir)
        assert filt is not None
        assert os.path.exists(args.model_file)
        with open(os.path.join(mdir, "negative_samples.txt")) as fh:
            out[tag] = fh.read()
    assert out["port"] == out["jax"] and out["port"].count("\n") >= 2


# ---------------------------------------------------------------- bulk CLI


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """The engineered-fusion fixture of tests/test_torch_pipeline.py as CLI
    input files."""
    d = tmp_path_factory.mktemp("cli")
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               exons_per_gene=(3, 5), exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    decoy = [g for g in sg.genes.values()
             if g.name not in (anchor.name, partner.name)][0]
    rng = np.random.default_rng(12)
    tx_a = anchor.transcript(sg.genome)
    break5 = sum(e - s + 1 for s, e in anchor.exons[:2]) - 100
    fusion = fuse_transcripts(tx_a, partner.transcript(sg.genome), break5, 60)
    names, r1, r2 = [], [], []
    for tx, cov, pre in ((fusion, 40, "FUS"), (tx_a, 20, "WTA"),
                         (partner.transcript(sg.genome), 20, "WTP"),
                         (decoy.transcript(sg.genome), 20, "WTD")):
        nm, a, b = simulate_pairs(rng, tx, coverage_to_pairs(len(tx), cov),
                                  name_prefix=pre)
        names += nm
        r1 += a
        r2 += b
    write_fastq_pair(str(d / "r_1.fastq"), str(d / "r_2.fastq"), names, r1, r2)
    write_gtf(sg, str(d / "ann.gtf"))
    write_fasta({"chr1": sg.genome.fetch_str("chr1", 1,
                                             sg.genome.total_length)},
                str(d / "genome.fa"))
    write_fasta({f"NM_000001.1 {anchor.name}": tx_a}, str(d / "anchor.fa"))
    (d / "names.txt").write_text(anchor.name + "\n")
    argv = ["--file_anchored_cds", str(d / "anchor.fa"),
            "--gene_names", str(d / "names.txt"),
            "--fastq1", str(d / "r_1.fastq"), "--fastq2", str(d / "r_2.fastq"),
            "--file_ref_seq", str(d / "genome.fa"),
            "--file_ref_ann", str(d / "ann.gtf")]
    return d, argv, anchor, partner, break5


def _run_both(cli_inputs, tmp_path, capsys, monkeypatch, extra):
    from anchored_fusion_tpu.cli import bulk as jbulk
    from anchored_fusion_tpu_torch.cli import bulk

    monkeypatch.setenv("AFT_COMP_CACHE", "")
    _, argv, anchor, _, _ = cli_inputs
    out = {}
    for tag, main in (("jax", jbulk.main),
                      ("port", lambda a: bulk.main(a, device="cpu"))):
        folder = str(tmp_path / tag)
        capsys.readouterr()
        rc = main(argv + ["--out_folder", folder] + extra)
        rows = [ln for ln in capsys.readouterr().out.splitlines()
                if "\tspanning=" in ln]
        prefix = os.path.join(folder, f"{anchor.name}_fusion",
                              f"{anchor.name}_fusion_predictions")
        files = {}
        for suffix in (".txt", "_abridged.txt"):
            with open(prefix + suffix) as fh:
                files[suffix] = fh.read()
        out[tag] = (rc, rows, files, folder)
    return out


def test_bulk_cli_filter_off_byte_identical(cli_inputs, tmp_path, capsys,
                                            monkeypatch):
    _, _, anchor, partner, break5 = cli_inputs
    out = _run_both(cli_inputs, tmp_path, capsys, monkeypatch,
                    ["--not_filter_false_positive"])
    (jrc, jrows, jfiles, _), (rc, rows, files, folder) = out["jax"], out["port"]
    assert rc == jrc == 0
    assert rows == jrows
    assert any(r.startswith(f"{anchor.name}--{partner.name}\t{break5}\t")
               for r in rows), rows
    assert files == jfiles
    import json
    with open(os.path.join(folder, "run_stats.json")) as fh:
        stats = json.load(fh)["stats"]
    assert stats["kernel_launches"] == {"sw_align_fused": 0, "sw_end": 0}
    assert f"time.call:{anchor.name}_s" in stats


@pytest.fixture(scope="module")
def wildtype_cli_inputs(tmp_path_factory):
    """The wild-type-only fixture of tests/test_torch_pipeline.py (200 pairs
    of the anchor's own transcript, seed 13) as CLI input files."""
    d = tmp_path_factory.mktemp("cli_wt")
    sg = make_synthetic_genome(np.random.default_rng(11), n_genes=6,
                               exons_per_gene=(3, 5), exon_len=(250, 400))
    anchor = [g for g in sg.genes.values() if g.strand == "+"][0]
    tx_a = anchor.transcript(sg.genome)
    names, r1, r2 = simulate_pairs(np.random.default_rng(13), tx_a, 200,
                                   name_prefix="WT")
    write_fastq_pair(str(d / "r_1.fastq"), str(d / "r_2.fastq"), names, r1, r2)
    write_gtf(sg, str(d / "ann.gtf"))
    write_fasta({"chr1": sg.genome.fetch_str("chr1", 1,
                                             sg.genome.total_length)},
                str(d / "genome.fa"))
    write_fasta({f"NM_000001.1 {anchor.name}": tx_a}, str(d / "anchor.fa"))
    (d / "names.txt").write_text(anchor.name + "\n")
    argv = ["--file_anchored_cds", str(d / "anchor.fa"),
            "--gene_names", str(d / "names.txt"),
            "--fastq1", str(d / "r_1.fastq"), "--fastq2", str(d / "r_2.fastq"),
            "--file_ref_seq", str(d / "genome.fa"),
            "--file_ref_ann", str(d / "ann.gtf")]
    return d, argv, anchor, None, None


def test_bulk_cli_wildtype_byte_identical(wildtype_cli_inputs, tmp_path,
                                          capsys, monkeypatch):
    """Wild-type reads only, filter off: the same rows (none is a fusion
    of the anchor with another gene) and byte-identical files."""
    _, _, anchor, _, _ = wildtype_cli_inputs
    out = _run_both(wildtype_cli_inputs, tmp_path, capsys, monkeypatch,
                    ["--not_filter_false_positive"])
    (jrc, jrows, jfiles, _), (rc, rows, files, _) = out["jax"], out["port"]
    assert rc == jrc == 0
    assert rows == jrows
    assert files == jfiles and files[".txt"].startswith("Fusion_gene")


def test_bulk_cli_forced_xl_byte_identical(cli_inputs, tmp_path, capsys,
                                           monkeypatch):
    """The bulk CLI on the XL engine (both pipelines' int32 limit lowered
    below the genome), filter off: the hg38 flags reach the engine and the
    prediction files are byte-identical to the JAX CLI's."""
    import anchored_fusion_tpu.pipeline as jpipeline
    import anchored_fusion_tpu_torch.pipeline as tpipeline
    from anchored_fusion_tpu_torch.align.genome_xl import GenomeAlignerXL
    from anchored_fusion_tpu_torch.io.fasta import read_fasta

    d, _, anchor, partner, break5 = cli_inputs
    L = read_fasta(str(d / "genome.fa")).total_length
    for mod in (jpipeline, tpipeline):
        monkeypatch.setattr(mod, "_INT32_SAFE", L - 1)
    cfgs = []
    init = GenomeAlignerXL.__init__
    monkeypatch.setattr(GenomeAlignerXL, "__init__", lambda self, ref, cfg,
                        **kw: cfgs.append(cfg) or init(self, ref, cfg, **kw))
    out = _run_both(cli_inputs, tmp_path, capsys, monkeypatch,
                    ["--not_filter_false_positive", "--index_stride", "2",
                     "--genome_kmer", "11", "--xl_two_pass", "1",
                     "--xl_profile", "balanced"])
    (jrc, jrows, jfiles, _), (rc, rows, files, _) = out["jax"], out["port"]
    assert [(c.index_stride, c.genome_kmer, c.xl_two_pass, c.xl_pass1_hits,
             c.xl_pass1_top_k, c.xl_rescue_hits, c.xl_rescue_top_k)
            for c in cfgs] == [(2, 11, True, 4, 2, 16, 8)]
    assert rc == jrc == 0
    assert rows == jrows
    assert any(r.startswith(f"{anchor.name}--{partner.name}\t{break5}\t")
               for r in rows), rows
    assert files == jfiles


def _tsv(text):
    return list(csv.reader(io.StringIO(text), delimiter="\t"))


def test_bulk_cli_filter_on_shared_model(cli_inputs, tmp_path, capsys,
                                         monkeypatch):
    """BASELINE config 2 with a JAX-trained model file loaded by both."""
    from anchored_fusion_tpu.cli import bulk as jbulk
    from anchored_fusion_tpu.models.train import train_filter_model as j_train
    from anchored_fusion_tpu_torch.cli import bulk

    rng = np.random.default_rng(6)
    rows = []
    for _ in range(80):
        s = "".join("ACGT"[i] for i in rng.integers(0, 4, 201))
        rows.append(s[:100] + "H" + s[101:])
    model = str(tmp_path / "shared.msgpack")
    j_train(rows[:40], rows[40:], JFilterModelConfig(**SMALL), model,
            verbose=False)
    monkeypatch.setattr(jbulk, "PipelineConfig", lambda **kw: JPipelineConfig(
        filter_model=JFilterModelConfig(**SMALL), **kw))
    monkeypatch.setattr(bulk, "PipelineConfig", lambda **kw: PipelineConfig(
        filter_model=FilterModelConfig(**SMALL), **kw))
    out = _run_both(cli_inputs, tmp_path, capsys, monkeypatch,
                    ["--not_train_filter_model", "--model_file", model])
    (jrc, jrows, jfiles, _), (rc, trows, files, _) = out["jax"], out["port"]
    assert rc == jrc == 0 and trows == jrows and trows
    for suffix, text in files.items():
        got, want = _tsv(text), _tsv(jfiles[suffix])
        assert len(got) == len(want) and got[0] == want[0]
        if suffix == "_abridged.txt":
            assert "Natural_score" in got[0]
        col = got[0].index("Natural_score") if "Natural_score" in got[0] \
            else None
        for g, w in zip(got[1:], want[1:]):
            if col is None:
                assert g == w
                continue
            assert g[:col] + g[col + 1:] == w[:col] + w[col + 1:]
            assert abs(float(g[col]) - float(w[col])) <= 2e-4


def test_bulk_cli_refuses_what_is_not_ported(cli_inputs, tmp_path):
    from anchored_fusion_tpu_torch.cli import bulk, common

    ns = types.SimpleNamespace
    assert common.device_for(ns(gpu_number="-1")) == "cuda"
    assert common.device_for(ns(gpu_number="2")) == "cuda:2"
    assert common.device_for(ns(gpu_number="2"), device="cpu") == "cpu"
    _, argv, _, _, _ = cli_inputs
    base = argv + ["--out_folder", str(tmp_path), "--not_filter_false_positive"]
    # the cluster flags reach the runtime (a one-process cluster here)
    from anchored_fusion_tpu_torch.parallel import distributed
    calls = []
    init = distributed.initialize
    distributed.initialize = lambda *a, **kw: calls.append((a, kw)) or False
    try:
        assert bulk.main(argv + ["--out_folder", str(tmp_path / "cluster"),
                                 "--not_filter_false_positive",
                                 "--coordinator", "localhost:1", "--num_procs",
                                 "1", "--proc_id", "0"], device="cpu") == 0
    finally:
        distributed.initialize = init
    assert calls == [(("localhost:1", 1, 0), {"device": "cpu"})]
    if not torch.cuda.is_available():
        # no device named and no CUDA: stop at once, write nothing
        assert bulk.main(base) == bulk.EXIT_NO_DEVICE
        assert bulk.main(base + ["--gpu_number", "0"]) == bulk.EXIT_NO_DEVICE
        assert not os.path.exists(tmp_path / "run_stats.json")


# ---------------------------------------------------------------- utils


def test_stage_logger_traces_with_torch_profiler(tmp_path):
    import json
    from anchored_fusion_tpu_torch.utils.log import StageLogger

    log = StageLogger("t", profile_dir=str(tmp_path / "prof"))
    with log.stage("work", items=100):
        torch.ones(64, 64) @ torch.ones(64, 64)
    log.set(extra=1)
    log.dump(str(tmp_path / "stats.json"))
    stats = json.loads((tmp_path / "stats.json").read_text())["stats"]
    assert {"time.work_s", "rate.work_reads_per_s", "time.total_s",
            "extra", "profile_dir"} <= set(stats)
    traces = list((tmp_path / "prof").glob("t_*.trace.json"))
    assert len(traces) == 1
    assert "t.work" in traces[0].read_text()


def test_gene_guard_matches_jax():
    from anchored_fusion_tpu.utils.debug import gene_guard as j_guard
    from anchored_fusion_tpu_torch.utils import debug

    def flaky(n):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= n:
                raise ValueError(f"attempt {len(calls)}")
            return len(calls)
        return fn

    for n_fail, retries in ((0, 0), (1, 1), (2, 1)):
        out = []
        for guard in (j_guard, debug.gene_guard):
            failures = []
            with guard("G", failures, retries=retries,
                       retry_delay_s=0.0) as g:
                g.run(flaky(n_fail))
            out.append((g.result, g.failed,
                        [(f["gene"], f["error"], f["attempts"])
                         for f in failures]))
        assert out[0] == out[1]
    prev = torch.is_anomaly_enabled()
    try:
        debug.enable_debug_checks()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(prev)
