"""The port's headline harness (``bench/headline.py``) against the JAX
package's root ``bench.py``, on the CPU.

The harness reads a sample in the form of the reference tool's bundled
one, which is not shipped: ``chip_smoke.wgsim_sample`` writes one (at
~1,500 pairs here, 11,258 in chip_smoke.py's bench phase).  The streamed
stage's records and mapped count are held equal to JAX's
``align_to_reference``, and the pipeline's rows to JAX's ``call_gene`` on
the same surrogate genome; ``main`` runs at small stream, pipeline and
scaling sizes and must print ``bench.py``'s keys.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from anchored_fusion_tpu_torch.bench import headline as h

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


@pytest.fixture
def small(monkeypatch):
    """The harness at a CPU test's size: 2 copies a stream, 1 timed
    stream and call_gene, 2 device-resident calls, 512 / 256 / 128 reads
    in the scaling harness, one thread a rank."""
    for name, v in (("DEPTH", 2), ("ROUNDS", 1), ("PIPE_ROUNDS", 1),
                    ("RELAY_CALLS", 2), ("N_STRONG", 512), ("N_WEAK", 256),
                    ("N_SMALL", 128)):
        monkeypatch.setattr(h, name, v)
    monkeypatch.setattr(h, "_rank_threads", lambda world: 1)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = str(tmp_path_factory.mktemp("wgsim"))
    return mod.wgsim_sample(d, seed=21, n_pairs=SAMPLE_PAIRS)["paths"]


@pytest.fixture(scope="module")
def reads(sample):
    from anchored_fusion_tpu_torch.io.fasta import read_fasta
    from anchored_fusion_tpu_torch.io.fastq import read_fastq_pair
    rb = read_fastq_pair(sample["fastq1"], sample["fastq2"])
    seqs = rb.seq.reshape(-1, rb.max_len)
    return rb, read_fasta(sample["anchor"]).seq, seqs, \
        -(-len(seqs) // 128) * 128


@pytest.fixture(scope="module")
def expect(reads):
    """The sample's mapped count in the streamed stage's configuration."""
    from anchored_fusion_tpu_torch.align.aligner import align_to_reference
    from anchored_fusion_tpu_torch.config import AlignConfig
    _, anchor, seqs, chunk = reads
    res = align_to_reference(seqs, anchor, AlignConfig(gapped_refine=False),
                             chunk=chunk, device="cpu")
    return int(res.mapped.sum())


def _argv(sample, expect, *extra):
    return ["--fastq1", sample["fastq1"], "--fastq2", sample["fastq2"],
            "--anchor", sample["anchor"], "--expect-mapped", str(expect),
            *extra]


def test_streamed_stage_matches_jax(reads, expect):
    from anchored_fusion_tpu.align import align_to_reference as jalign
    from anchored_fusion_tpu.config import AlignConfig as JAlignConfig
    from anchored_fusion_tpu_torch.align.aligner import (
        RESULT_FIELDS, align_to_reference)
    from anchored_fusion_tpu_torch.config import AlignConfig
    _, anchor, seqs, chunk = reads
    assert chunk == 3072 and seqs.shape == (2 * SAMPLE_PAIRS, 128)
    want = jalign(seqs, anchor, JAlignConfig(gapped_refine=False),
                  chunk=chunk)
    got = align_to_reference(seqs, anchor, AlignConfig(gapped_refine=False),
                             chunk=chunk, device="cpu")
    for f in RESULT_FIELDS + ("mapped",):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert int(want.mapped.sum()) == expect > 0


def test_stream_parity_holds(reads, expect, small):
    _, anchor, seqs, chunk = reads
    cpu = torch.device("cpu")
    best, median, rounds = h.stream_throughput(seqs, anchor, expect, chunk,
                                               cpu)
    assert len(rounds) == 1 and best == median == rounds[0] > 0
    with pytest.raises(AssertionError, match="parity check failed"):
        h.stream_throughput(seqs, anchor, expect + 1, chunk, cpu)


def test_pipeline_rows_match_jax(reads, sample, tmp_path, small):
    from anchored_fusion_tpu.annotate.exon_index import ExonIndex
    from anchored_fusion_tpu.bench import surrogate as jsur
    from anchored_fusion_tpu.config import PipelineConfig
    from anchored_fusion_tpu.io.fastq import read_fastq_pair
    from anchored_fusion_tpu.pipeline import FusionPipeline
    rb, anchor, _, _ = reads
    got, dt, _ = h.pipeline_throughput(rb, anchor, torch.device("cpu"))
    jrb = read_fastq_pair(sample["fastq1"], sample["fastq2"])
    sg = jsur.build_surrogate_genome(anchor, jsur.reconstruct_transcripts(jrb))
    pipe = FusionPipeline(sg.genome, ExonIndex(sg.gtf_dic, inject_loci=False),
                          sg.gene_rows(),
                          PipelineConfig(filter_false_positive=False))
    want = pipe.call_gene("BCR", anchor, jrb, out_prefix=str(tmp_path / "j"))
    assert got.rows == want.rows
    timeless = lambda c: {k: v for k, v in c.items()
                          if k != "wall_s" and not k.startswith("time.")}
    assert timeless(got.counters) == timeless(want.counters)
    assert any(r["fusion"] == "BCR--ABL1"
               and int(r["anchor_breakpoint"]) == 3235 for r in got.rows)
    assert dt > 0


def _bench_py_keys() -> set:
    """The keys of the JSON line the root bench.py prints."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no JSON dict")


ATTRIB = {"fixed_overhead_s", "marginal_reads_per_s",
          "overhead_frac_at_big", "bottleneck"}


def test_main_prints_bench_py_keys(sample, expect, small, capsys):
    assert h.main(_argv(sample, expect, "--device", "cpu",
                        "--max-ranks", "2")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == _bench_py_keys()
    assert out["metric"] == "anchored_alignment_throughput"
    assert out["unit"] == "reads/s" and len(out["rounds"]) == 1
    assert out["value"] > 0 and out["pipeline_reads_per_s"] > 0
    assert set(out["relay"]) == {"roundtrip_ms", "h2d_mb_s",
                                 "compute_reads_per_s"}
    assert out["relay"]["compute_reads_per_s"] > 0
    sc = out["scaling"]
    assert set(sc) == {"anchored", "genome", "n_reads_strong",
                       "n_reads_weak_per_device", "note"}
    assert (sc["n_reads_strong"], sc["n_reads_weak_per_device"]) == (512, 256)
    for stage in ("anchored", "genome"):
        for regime in ("strong", "weak"):
            rows = sc[stage][regime]
            assert set(rows) == {"dp1", "dp2", "efficiency_dp2"}
            assert rows["efficiency_dp2"] == round(
                rows["dp2"] / (2 * rows["dp1"]), 3)
        assert set(sc[stage]["attrib_dp1"]) == ATTRIB
    assert set(sc["anchored"]) == {"strong", "weak", "attrib_dp1"}
    assert set(sc["genome"]) == {"strong", "weak", "attrib_dp1",
                                 "mp2_capacity", "mp2_vs_dp1", "mp2_attrib"}
    assert set(sc["genome"]["mp2_attrib"]) == ATTRIB
    assert sc["genome"]["mp2_vs_dp1"] == round(
        sc["genome"]["mp2_capacity"] / sc["genome"]["strong"]["dp1"], 3)


def test_main_refuses_a_missing_card(sample, expect):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        h.main(_argv(sample, expect))


def test_failed_scaling_rank_raises(sample, expect, small, tmp_path,
                                    monkeypatch, capsys):
    rank = tmp_path / "failing_rank.py"
    rank.write_text("def scaling_rank(task):\n"
                    "    raise ValueError('rank failed on purpose')\n")
    monkeypatch.setattr(h, "SCALING_TARGET", f"{rank}:scaling_rank")
    with pytest.raises(RuntimeError, match="rank failed on purpose"):
        h.main(_argv(sample, expect, "--device", "cpu", "--max-ranks", "2"))
    assert capsys.readouterr().out == ""
