"""The port's ``call_gene`` against the JAX package's on the two synthetic
fixtures of tests/test_pipeline_synthetic.py: the engineered fusion and
wild-type reads only.  Rows and non-time counters must be equal and the
prediction files byte-identical.
"""

import dataclasses
import filecmp

import numpy as np
import pytest

from anchored_fusion_tpu.annotate.exon_index import ExonIndex as JExonIndex
from anchored_fusion_tpu.bench.simulate import (
    make_synthetic_genome, fuse_transcripts, simulate_pairs, coverage_to_pairs)
from anchored_fusion_tpu.config import AlignConfig as JAlignConfig
from anchored_fusion_tpu.config import PipelineConfig as JPipelineConfig
from anchored_fusion_tpu.io.fastq import ReadBatch as JReadBatch
from anchored_fusion_tpu.ops.encode import encode_ascii
from anchored_fusion_tpu.pipeline import FusionPipeline as JFusionPipeline
from anchored_fusion_tpu_torch.annotate.exon_index import (
    ExonIndex as TExonIndex)
from anchored_fusion_tpu_torch.config import AlignConfig as TAlignConfig
from anchored_fusion_tpu_torch.config import PipelineConfig as TPipelineConfig
from anchored_fusion_tpu_torch.io.fasta import Reference as TReference
from anchored_fusion_tpu_torch.io.fastq import ReadBatch as TReadBatch
from anchored_fusion_tpu_torch.pipeline import FusionPipeline as TFusionPipeline


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(11)
    sg = make_synthetic_genome(rng, n_genes=6, exons_per_gene=(3, 5),
                               exon_len=(250, 400))
    plus = [g for g in sg.genes.values() if g.strand == "+"]
    anchor, partner = plus[0], plus[1]
    decoy = [g for g in sg.genes.values()
             if g.name not in (anchor.name, partner.name)][0]
    return sg, anchor, partner, decoy


def _batch(names, r1, r2):
    seq = np.stack([
        np.stack([encode_ascii(x, length=128), encode_ascii(y, length=128)])
        for x, y in zip(r1, r2)])
    return names, seq, np.full((len(names), 2), 101, np.int32)


def fusion_reads(sg, anchor, partner, decoy, seed=12):
    rng = np.random.default_rng(seed)
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
    return _batch(names, r1, r2), break5


def wildtype_reads(sg, anchor, seed=13):
    rng = np.random.default_rng(seed)
    return _batch(*simulate_pairs(rng, anchor.transcript(sg.genome), 200,
                                  name_prefix="WT"))


def _call_recording_stage4(pipe, mod, anchor, anchor_codes, batch, prefix):
    """``pipe.call_gene`` with stage 4's inputs to the genome engine's
    ``align_multi`` (the clipped reads, oriented) and the split reads
    ``extract_split_reads`` returns (through ``mod``, the pipeline module)."""
    seen = {}

    def keep(name, fn, arg):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[name] = np.asarray(a[0]) if arg else [
                dataclasses.astuple(sr) for sr in out]
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "extract_split_reads",
                   keep("split", mod.extract_split_reads, False))
        mp.setattr(pipe.genome_aligner, "align_multi",
                   keep("multi", pipe.genome_aligner.align_multi, True))
        got = pipe.call_gene(anchor.name, anchor_codes, batch,
                             out_prefix=prefix)
    return got, seen


def run_both(sg, anchor, batch, tmp_path, align_kw=None, engine=None):
    """call_gene in both packages; ``align_kw`` sets AlignConfig fields and
    ``engine`` names the genome engine the port must have picked.  Stage 4
    must give ``align_multi`` the same reads and find the same split reads."""
    import anchored_fusion_tpu.pipeline as jpipeline
    import anchored_fusion_tpu_torch.pipeline as tpipeline
    align_kw = align_kw or {}
    anchor_codes = encode_ascii(anchor.transcript(sg.genome))
    jpipe = JFusionPipeline(sg.genome, JExonIndex(sg.gtf_dic, inject_loci=False),
                            sg.gene_rows(),
                            JPipelineConfig(align=JAlignConfig(**align_kw),
                                            filter_false_positive=False))
    want, j_seen = _call_recording_stage4(
        jpipe, jpipeline, anchor, anchor_codes, JReadBatch(*batch),
        str(tmp_path / "jax"))
    g = sg.genome
    tgenome = TReference(list(g.names), g.starts.copy(), g.lengths.copy(),
                         g.seq.copy())
    tpipe = TFusionPipeline(tgenome, TExonIndex(sg.gtf_dic, inject_loci=False),
                            sg.gene_rows(),
                            TPipelineConfig(align=TAlignConfig(**align_kw),
                                            filter_false_positive=False),
                            device="cpu")
    if engine is not None:
        assert type(tpipe.genome_aligner).__name__ == engine
        assert type(jpipe.genome_aligner).__name__ == engine
    got, t_seen = _call_recording_stage4(
        tpipe, tpipeline, anchor, anchor_codes, TReadBatch(*batch),
        str(tmp_path / "torch"))
    assert got.rows == want.rows
    assert got.homo_genes == want.homo_genes
    timeless = lambda c: {k: v for k, v in c.items()
                          if k != "wall_s" and not k.startswith("time.")}
    assert timeless(got.counters) == timeless(want.counters)
    assert t_seen.keys() == j_seen.keys() and "split" in t_seen
    assert t_seen["split"] == j_seen["split"]
    if "multi" in j_seen:
        np.testing.assert_array_equal(t_seen["multi"], j_seen["multi"])
    for suffix in ("_predictions.txt", "_predictions_abridged.txt"):
        assert filecmp.cmp(str(tmp_path / ("jax" + suffix)),
                           str(tmp_path / ("torch" + suffix)), shallow=False)
    return got


def test_call_gene_engineered_fusion_matches_jax(synth, tmp_path):
    sg, anchor, partner, decoy = synth
    batch, break5 = fusion_reads(sg, anchor, partner, decoy)
    got = run_both(sg, anchor, batch, tmp_path)
    assert got.counters["split_reads"] > 0
    expected = f"{anchor.name}--{partner.name}"
    assert expected in {r["fusion"] for r in got.rows}
    assert all(decoy.name not in r["fusion"] for r in got.rows)
    row = max((r for r in got.rows if r["fusion"] == expected),
              key=lambda r: r["split"])
    assert row["anchor_breakpoint"] == break5


def test_call_gene_wildtype_matches_jax(synth, tmp_path):
    sg, anchor, _, _ = synth
    got = run_both(sg, anchor, wildtype_reads(sg, anchor), tmp_path)
    assert got.rows == []
    assert got.counters["anchor_mapped"] > 0


def force_engine(monkeypatch, genome_bp: int):
    """Lower the int32 limit of both pipelines below ``genome_bp``, so a
    small genome takes the engines of genomes past int32: 'xl' at index
    stride 2, 'sharded' at stride 1."""
    import anchored_fusion_tpu.pipeline as jpipeline
    import anchored_fusion_tpu_torch.pipeline as tpipeline
    for mod in (jpipeline, tpipeline):
        monkeypatch.setattr(mod, "_INT32_SAFE", genome_bp - 1)


FORCED = {"xl": ("GenomeAlignerXL", dict(index_stride=2, genome_kmer=11)),
          "sharded": ("ShardedGenomeAligner", dict(index_stride=1))}


@pytest.mark.parametrize("engine", sorted(FORCED))
@pytest.mark.parametrize("fixture", ["fusion", "wildtype"])
def test_call_gene_forced_engine_matches_jax(synth, tmp_path, monkeypatch,
                                             engine, fixture):
    sg, anchor, partner, decoy = synth
    force_engine(monkeypatch, sg.genome.total_length)
    cls, align_kw = FORCED[engine]
    if fixture == "fusion":
        batch, break5 = fusion_reads(sg, anchor, partner, decoy)
    else:
        batch = wildtype_reads(sg, anchor)
    got = run_both(sg, anchor, batch, tmp_path, align_kw, engine=cls)
    if fixture == "fusion":
        row = max((r for r in got.rows
                   if r["fusion"] == f"{anchor.name}--{partner.name}"),
                  key=lambda r: r["split"])
        assert row["anchor_breakpoint"] == break5
    else:
        assert got.rows == []


def test_unported_engines_raise(synth, monkeypatch):
    """Formerly: genomes past int32 raised NotImplementedError.  Both
    engines are ported now: the pipeline picks them by the JAX rule and no
    longer raises (the engines are stubbed: the genome is 2^31 bp of one
    repeated code)."""
    import anchored_fusion_tpu_torch.align.genome_xl as txl
    import anchored_fusion_tpu_torch.parallel.sharded_genome as tsh
    from anchored_fusion_tpu_torch.pipeline import genome_engine_kind
    assert genome_engine_kind(3_100_000_000, 8) == "xl"
    assert genome_engine_kind(3_100_000_000, 1) == "sharded"
    assert genome_engine_kind(2**31 - 2**20, 1) == "flat"
    sg, _, _, _ = synth
    g = sg.genome
    big = TReference(list(g.names), g.starts.copy(), g.lengths.copy(),
                     np.zeros(0, np.int8))
    big.seq = np.lib.stride_tricks.as_strided(np.zeros(1, np.int8),
                                              (2**31,), (0,))
    built = []
    stub = lambda name: (lambda genome, *a, **kw: built.append(  # noqa: E731
        (name, kw.get("n_shards"), kw["device"])) or name)
    monkeypatch.setattr(txl, "GenomeAlignerXL", stub("xl"))
    monkeypatch.setattr(tsh, "ShardedGenomeAligner", stub("sharded"))
    for stride, want in ((2, ("xl", None)), (1, ("sharded", 3))):
        cfg = TPipelineConfig(align=TAlignConfig(index_stride=stride))
        pipe = TFusionPipeline(big, TExonIndex(sg.gtf_dic, inject_loci=False),
                               sg.gene_rows(), cfg, device="cpu")
        assert pipe.genome_aligner == want[0]
        assert built[-1][:2] == want
