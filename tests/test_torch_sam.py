"""The port's SAM/BAM ingestion, external-alignment negative mining and
positive-row construction against the JAX package's, on the cases of
tests/test_sam.py, tests/test_bam.py and tests/test_training_data.py: equal
parses, byte-identical written files, ``multihits_from_sam`` equal field by
field with equal dtypes, and equal mined and built junction rows.
"""

import dataclasses
import filecmp

import numpy as np
import pytest

from anchored_fusion_tpu.align.genome import GenomeAligner as JGenomeAligner
from anchored_fusion_tpu.annotate.exon_index import ExonIndex as JExonIndex
from anchored_fusion_tpu.bench.simulate import make_synthetic_genome
from anchored_fusion_tpu.io import bam as jbam
from anchored_fusion_tpu.io import sam as jsam
from anchored_fusion_tpu.io.fasta import reference_from_dict as j_ref
from anchored_fusion_tpu.models import negative as jneg
from anchored_fusion_tpu.models import positive as jpos
from anchored_fusion_tpu.ops.encode import encode_ascii, decode_to_str, revcomp
from anchored_fusion_tpu_torch.annotate.exon_index import (
    ExonIndex as TExonIndex)
from anchored_fusion_tpu_torch.io import bam as tbam
from anchored_fusion_tpu_torch.io import sam as tsam
from anchored_fusion_tpu_torch.io.fasta import Reference as TReference
from anchored_fusion_tpu_torch.io.fasta import reference_from_dict as t_ref
from anchored_fusion_tpu_torch.models import negative as tneg
from anchored_fusion_tpu_torch.models import positive as tpos

REFS = [("chr1", 1000), ("chr2", 500)]


# ---------------------------------------------------------------- CIGAR


@pytest.mark.parametrize("cigar", ["55S46M", "*", "", "5H10M100N10M5S",
                                   "5=1X4=", "10M2D10M3I4M2P1S"])
def test_parse_cigar_equal(cigar):
    assert tsam.parse_cigar(cigar) == jsam.parse_cigar(cigar)


@pytest.mark.parametrize("cigar,seq", [
    ("55S46M", "A" * 101),
    ("10M2D10M", "ACGTACGTAC" + "TTTTTTTTTT"),
    ("10M3I10M", "ACGTACGTAC" + "GGG" + "TTTTTTTTTT"),
    ("5H10M100N10M5S", "A" * 25),
    ("5=1X4=", "A" * 10),
    ("3D10M", "C" * 10),
    ("2I8M2D3M1P4S", "ACGTACGTACGTACGTA"),
    ("10M5D", "G" * 10),
])
def test_normalize_cigar_equal(cigar, seq):
    assert tsam.normalize_cigar(cigar, seq) == jsam.normalize_cigar(cigar, seq)


@pytest.mark.parametrize("args", [(101, 0, 100), (101, 55, 100),
                                  (101, 0, 60), (50, 10, 20)])
def test_cigar_from_segment_equal(args):
    assert tsam.cigar_from_segment(*args) == jsam.cigar_from_segment(*args)


def test_sam_flags_equal():
    names = [n for n in dir(jsam) if n.startswith("SAM_FLAG_")]
    assert names and all(getattr(tsam, n) == getattr(jsam, n) for n in names)


def test_sam_roundtrip_equal(tmp_path):
    recs = [("r1", 0, 100, 60, "101M", "A" * 101),
            ("r2", 16, 7, 0, "55S46M", "C" * 101)]
    pt, pj = str(tmp_path / "t.sam"), str(tmp_path / "j.sam")
    tsam.write_sam(pt, "BCR", 6783, recs)
    jsam.write_sam(pj, "BCR", 6783, recs)
    assert filecmp.cmp(pt, pj, shallow=False)
    assert list(tsam.read_sam(pt)) == list(jsam.read_sam(pt)) == [
        ("r1", 0, "BCR", 100, "101M", "A" * 101),
        ("r2", 16, "BCR", 7, "55S46M", "C" * 101)]
    assert list(tsam._read_sam_tagged(pt)) == list(jsam._read_sam_tagged(pt))


# ---------------------------------------------------------------- BAM


BAM_RECS = [
    ("r1", 0, "chr1", 1, 60, "60M40S", "A" * 100, ["NM:i:2", "AS:i:56"]),
    ("r1", 2064, "chr2", 11, 60, "30H70M", "C" * 70, ["NM:i:0"]),
    ("r2", 0x100, "chr1", 5, 0, "100M", "*", ["AS:i:90"]),
    ("r3", 0, "chr1", 7, 60, "30M200N70M", "G" * 100, []),
    ("r4", 4, "chr1", 1, 0, "*", "ACGTN", ["XA:Z:chr2,+5,5M,0",
                                           "XF:f:1.5", "XC:A:q"]),
]


@pytest.mark.parametrize("n_recs", [len(BAM_RECS), 1500],
                         ids=["records", "multi_block"])
def test_bam_roundtrip_equal(tmp_path, n_recs):
    """Both writers give the same bytes (>64 KiB of records: several BGZF
    members); both readers give the same header and records."""
    recs = BAM_RECS if n_recs == len(BAM_RECS) else [
        (f"r{i}", 0, "chr1", 1 + i % 100, 60, "100M", "ACGT" * 25,
         ["NM:i:1"]) for i in range(n_recs)]
    pt, pj = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    tbam.write_bam(pt, REFS, recs)
    jbam.write_bam(pj, REFS, recs)
    assert filecmp.cmp(pt, pj, shallow=False)
    assert tbam.is_bam(pt) and not tbam.is_bam(__file__)
    assert tbam.read_bam_header(pt) == jbam.read_bam_header(pt)
    got = list(tbam.read_bam_records(pt))
    assert got == list(jbam.read_bam_records(pt))
    assert len(got) == n_recs
    assert got[-1][:6] == (recs[-1][0], recs[-1][1], recs[-1][2],
                           recs[-1][3], recs[-1][5], recs[-1][6])
    assert list(tsam._read_alignment_records(pt)) == got


def test_bam_rejects_bad_input(tmp_path):
    import gzip
    p = str(tmp_path / "bad.bam")
    with gzip.open(p, "wb") as fh:
        fh.write(b"NOPE\x00\x00\x00\x00")
    for fn in (tbam.read_bam_header, lambda x: list(tbam.read_bam_records(x))):
        with pytest.raises(ValueError, match="bad magic"):
            fn(p)
    tbam.write_bam(p, REFS, BAM_RECS[:1])
    with gzip.open(p, "rb") as fh:
        raw = fh.read()
    with gzip.open(p, "wb") as fh:
        fh.write(raw[:-5])
    with pytest.raises(EOFError):
        list(tbam.read_bam_records(p))


# ---------------------------------------------------------------- MultiHits

_LINES = {
    "soft_split": [
        "r1\t0\tchr1\t1\t60\t60M40S\t*\t0\t0\t" + "A" * 100 + "\t*",
        "r1\t2048\tchr1\t201\t60\t60S40M\t*\t0\t0\t" + "A" * 100 + "\t*"],
    "hard_split": [
        "r1\t0\tchr1\t1\t60\t60M40S\t*\t0\t0\t" + "A" * 100 + "\t*",
        "r1\t2048\tchr1\t201\t60\t60H40M\t*\t0\t0\t" + "A" * 40 + "\t*"],
    "reverse_soft": ["r1\t16\tchr1\t11\t60\t30S70M\t*\t0\t0\t" + "A" * 100
                     + "\t*"],
    "reverse_hard": ["r1\t2064\tchr1\t11\t60\t30H70M\t*\t0\t0\t" + "A" * 70
                     + "\t*"],
    "intron": ["r1\t0\tchr1\t1\t60\t30M200N70M\t*\t0\t0\t" + "A" * 100
               + "\t*"],
    "tagged": [
        "r1\t0\tchr1\t1\t60\t60M40S\t*\t0\t0\t" + "A" * 100
        + "\t*\tNM:i:3\tAS:i:51",
        "r1\t2048\tchr1\t201\t60\t60H40M\t*\t0\t0\t" + "A" * 40
        + "\t*\tNM:i:0",
        "r2\t16\tchr1\t11\t60\t30S70M\t*\t0\t0\t" + "C" * 100 + "\t*",
        "r3\t4\t*\t0\t0\t*\t*\t0\t0\t" + "G" * 50 + "\t*",
        "r4\t256\tchrX\t5\t0\t50M\t*\t0\t0\t*\t*",
        "r5\t256\tchr1\t5\t0\t10M2D20M5I15M\t*\t0\t0\t*\t*"],
}


def _assert_mh_equal(got, want):
    (gn, gl, gm), (wn, wl, wm) = got, want
    assert gn == wn
    assert gl.dtype == wl.dtype
    np.testing.assert_array_equal(gl, wl)
    for f in dataclasses.fields(wm):
        a, b = getattr(gm, f.name), getattr(wm, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("case", sorted(_LINES))
def test_multihits_from_sam_and_bam_equal(tmp_path, case):
    """Every fixture of tests/test_sam.py and tests/test_bam.py, read from
    SAM text and from the same records as BAM, in both packages."""
    seq = "ACGT" * 250
    sam = tmp_path / "t.sam"
    sam.write_text("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n"
                   + "\n".join(_LINES[case]) + "\n")
    recs = []
    for line in _LINES[case]:
        a = line.split("\t")
        if a[2] in ("chr1", "chrX"):
            recs.append((a[0], int(a[1]), a[2], int(a[3]), int(a[4]), a[5],
                         a[9], a[11:]))
    bam = str(tmp_path / "t.bam")
    tbam.write_bam(bam, [("chr1", 1000), ("chrX", 100)], recs)
    want = jsam.multihits_from_sam(str(sam), j_ref({"chr1": seq}))
    for path in (str(sam), bam):
        _assert_mh_equal(tsam.multihits_from_sam(path, t_ref({"chr1": seq})),
                         want)
    got = tsam.multihits_from_sam(str(sam), t_ref({"chr1": seq}))
    if case == "intron":
        assert list(got[2].ref_end) == [299]
    if case.endswith("_hard") or case == "hard_split":
        assert list(got[1]) == [100]          # the full read's length


# ---------------------------------------------------------------- mining


@pytest.fixture(scope="module")
def q_world():
    """The world of tests/test_training_data.py and tests/test_bam.py."""
    sg = make_synthetic_genome(np.random.default_rng(21), n_genes=6,
                               gene_prefix="Q")
    g = sg.genome
    tg = TReference(list(g.names), g.starts.copy(), g.lengths.copy(),
                    g.seq.copy())
    return sg, tg, JExonIndex(sg.gtf_dic, inject_loci=False), \
        TExonIndex(sg.gtf_dic, inject_loci=False)


def _external_sam(sg, seqs, path):
    """The alignments of ``seqs`` as a user's external SAM would hold them
    (primary + secondary split hits, NM/AS tags), as tests/test_bam.py and
    tests/test_training_data.py write it."""
    hits = JGenomeAligner(sg.genome).align_multi(seqs, min_score=20,
                                                 min_seg_len=20, top_k=6)
    order = np.lexsort((-np.asarray(hits.score), np.asarray(hits.read_id)))
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for c, ln in zip(sg.genome.names, sg.genome.lengths):
        lines.append(f"@SQ\tSN:{c}\tLN:{int(ln)}")
    seen = set()
    for h in order:
        rid = int(hits.read_id[h])
        L = int((seqs[rid] != 5).sum())
        qs, qe = int(hits.q_start[h]), int(hits.q_end[h])
        rev = int(hits.strand[h]) == 1
        flag = 0x10 if rev else 0
        if rid in seen:
            flag |= 0x100
        seen.add(rid)
        lc, rc = (L - 1 - qe, qs) if rev else (qs, L - 1 - qe)
        cigar = (f"{lc}S" if lc else "") + \
            f"{qe - qs + 1}M" + (f"{rc}S" if rc else "")
        codes = seqs[rid][:L]
        seq = decode_to_str(revcomp(codes) if rev else codes)
        chrom, pos1 = sg.genome.to_local(int(hits.ref_start[h]))
        nm = int(hits.length[h]) - int(hits.matches[h])
        lines.append(f"r{rid}\t{flag}\t{chrom}\t{pos1}\t60\t{cigar}\t*\t0\t0"
                     f"\t{seq}\t*\tNM:i:{nm}\tAS:i:{int(hits.score[h])}")
    path.write_text("\n".join(lines) + "\n")
    recs = []
    for line in lines[len(sg.genome.names) + 1:]:
        a = line.split("\t")
        recs.append((a[0], int(a[1]), a[2], int(a[3]), int(a[4]), a[5], a[9],
                     a[11:]))
    bam = path.with_suffix(".bam")
    tbam.write_bam(str(bam), [(c, int(ln)) for c, ln in
                              zip(sg.genome.names, sg.genome.lengths)], recs)
    return str(path), str(bam)


@pytest.mark.parametrize("targets", [["Q0"], ["Q1"]])
@pytest.mark.parametrize("n_each", [4, 6])
def test_mine_negatives_sam_equal(q_world, tmp_path, n_each, targets):
    """tests/test_bam.py's and tests/test_training_data.py's fixture
    (chimeric Q1+Q4 reads and linear Q1 reads), from SAM and from BAM: the
    same rows as JAX's ``mine_negative_junctions_sam``; a target gene
    mines nothing."""
    sg, tg, jidx, tidx = q_world
    seqA = sg.genome.fetch_str("chr1", *sg.genes["Q1"].exons[0])
    seqB = sg.genome.fetch_str("chr1", *sg.genes["Q4"].exons[0])
    reads = [encode_ascii(seqA[10 + i:60 + i] + seqB[20 + i:71 + i],
                          length=128) for i in range(n_each)]
    reads += [encode_ascii(seqA[i:101 + i], length=128)
              for i in range(n_each)]
    sam, bam = _external_sam(sg, np.stack(reads), tmp_path / "ext.sam")
    want = jneg.mine_negative_junctions_sam(sam, sg.genome, jidx, targets,
                                            min_locus_distance=1000)
    for path in (sam, bam):
        got = tneg.mine_negative_junctions_sam(path, tg, tidx, targets,
                                               min_locus_distance=1000)
        assert got == want
    if targets == ["Q0"]:
        assert len(want) == 1 and want[0].endswith("\tQ1->Q4")
    else:
        assert want == []


def test_positive_junctions_equal(q_world, tmp_path):
    """tests/test_training_data.py's positive fixture, more strands and
    windows, and a STAR-Fusion-style TSV through both parsers."""
    sg, tg, jidx, tidx = q_world
    g1, g2 = sg.genes["Q2"], sg.genes["Q3"]
    p1, p2 = g1.exons[0][0] + 120, g2.exons[0][0] + 50
    rows = [("Q2->Q3", ("chr1", p1, "+"), ("chr1", p2, "+")),
            ("Q3->Q2", ("chr1", p2, "-"), ("chr1", p1, "+")),
            ("Q2->Q5", ("chr1", p1 + 40, "+"),
             ("chr1", sg.genes["Q5"].exons[-1][1] - 10, "-")),
            ("X->Y", ("chr1", 1, "+"), ("chr1", 2, "+"))]
    for window in (100, 30):
        got = tpos.build_positive_junctions(rows, tg, tidx, window)
        assert got == jpos.build_positive_junctions(rows, sg.genome, jidx,
                                                    window)
    seq, name = got[0].split("\t")
    assert name == "Q2->Q3" and len(seq) == 61 and seq[30] == "H"

    def line(name, c1, c2, extra=""):
        a = [name] + [f"c{i}" for i in range(1, 22)]
        a[7], a[9] = "L" + extra, "R"
        a[20], a[21] = f"g1^{c1}", f"g2^{c2}"
        return "\t".join(a)
    tsv = tmp_path / "fusions.tsv"
    tsv.write_text("\n".join([
        "header", line("Q2->Q3", f"1:{p1}:+", f"1:{p2}:+"),
        line("Q2->Q3", f"1:{p1}:+", f"1:{p2}:+"),
        line("Q2->Q3", f"1:{p1 + 5}:+", f"1:{p2}:-", extra="2"),
        "short\trow", line("Q3->Q2", f"1:{p2}:-", f"1:{p1}:+")]) + "\n")
    parsed = tpos.parse_fusion_tsv(str(tsv))
    assert parsed == jpos.parse_fusion_tsv(str(tsv))
    assert [r[0] for r in parsed] == ["Q2->Q3", "Q2->Q3", "Q3->Q2"]
    assert (tpos.build_positive_junctions(parsed, tg, tidx)
            == jpos.build_positive_junctions(parsed, sg.genome, jidx))
