"""CIGAR algebra and minimal SAM interop.

The framework's native alignment records are clip/segment tuples and never
round-trip through SAM; this module exists for interoperability with
external BAM/SAM-producing tools and preserves the reference's CIGAR
normalization semantics (``deal_cigar``, functions.py:656-702):

  * N (intron skip): dropped, later ops shift left
  * D (deletion):    merged into the following op, read padded with N
  * I (insertion):   cut out of the read
  * H (hard clip):   dropped
  * adjacent M runs: merged

yielding the <=3-op S/M/S form every calling stage reasons about; the 2-op
SM/MS test (functions.py:919) becomes ``len(ops) == 2``.
"""

from __future__ import annotations

import re
from typing import List, Tuple

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    """[(length, op), ...]; '*' -> []."""
    if cigar == "*" or not cigar:
        return []
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def normalize_cigar(cigar: str, seq: str) -> Tuple[List[List], str]:
    """deal_cigar parity: returns ([cumulative_end, length, op], modified seq).

    The cumulative end is the 1-based read offset where each op ends after
    normalization — the representation all reference clustering code indexes
    ('=' and 'X' are folded into M first; the reference never sees them from
    bwa but external tools emit them).
    """
    ops = [(n, "M" if op in "=X" else op) for n, op in parse_cigar(cigar)]
    res: List[List] = []
    co = 0
    for n, op in ops:
        co += n
        res.append([co, n, op])
    i = 0
    while i < len(res):
        op = res[i][2]
        if op == "N":
            for j in range(i + 1, len(res)):
                res[j][0] -= res[i][1]
            del res[i]
        elif op == "D":
            if i != len(res) - 1:
                res[i + 1][1] += res[i][1]
            cut = res[i - 1][0] if i > 0 else 0
            seq = seq[:cut] + "N" * res[i][1] + seq[cut:]
            del res[i]
        elif op == "I":
            for j in range(i + 1, len(res)):
                res[j][0] -= res[i][1]
            seq = seq[:res[i - 1][0] if i > 0 else 0] + seq[res[i][0]:]
            del res[i]
        elif op == "H":
            for j in range(i + 1, len(res)):
                res[j][0] -= res[i][1]
            del res[i]
        elif op == "P":
            del res[i]
        else:
            i += 1
    i = 0
    while i < len(res) - 1:
        if res[i][2] == "M" and res[i + 1][2] == "M":
            res[i][0] = res[i + 1][0]
            res[i][1] += res[i + 1][1]
            del res[i + 1]
        else:
            i += 1
    return res, seq


def cigar_from_segment(read_len: int, read_start: int, read_end: int) -> str:
    """Our segment record -> SAM CIGAR (soft clips around one M run)."""
    left = read_start
    mid = read_end - read_start + 1
    right = read_len - 1 - read_end
    out = ""
    if left > 0:
        out += f"{left}S"
    out += f"{mid}M"
    if right > 0:
        out += f"{right}S"
    return out


SAM_FLAG_PAIRED = 0x1
SAM_FLAG_UNMAPPED = 0x4
SAM_FLAG_MATE_UNMAPPED = 0x8
SAM_FLAG_REVERSE = 0x10
SAM_FLAG_SECONDARY = 0x100
SAM_FLAG_QC_FAIL = 0x200
SAM_FLAG_DUP = 0x400
SAM_FLAG_SUPPLEMENTARY = 0x800


def write_sam(path: str, ref_name: str, ref_len: int, records):
    """Minimal SAM writer for interop/debugging.

    records: iterable of (name, flag, pos1, mapq, cigar, seq_str).
    """
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:unsorted\n")
        fh.write(f"@SQ\tSN:{ref_name}\tLN:{ref_len}\n")
        for name, flag, pos1, mapq, cigar, seq in records:
            fh.write(f"{name}\t{flag}\t{ref_name}\t{pos1}\t{mapq}\t{cigar}"
                     f"\t*\t0\t0\t{seq}\t*\n")


def read_sam(path: str):
    """Minimal SAM reader: yields (name, flag, rname, pos1, cigar, seq)."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            a = line.rstrip("\n").split("\t")
            if len(a) < 11:
                continue
            yield a[0], int(a[1]), a[2], int(a[3]), a[5], a[9]


def _read_sam_tagged(path: str):
    """Like :func:`read_sam` but also yields the optional-tag fields."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            a = line.rstrip("\n").split("\t")
            if len(a) < 11:
                continue
            yield a[0], int(a[1]), a[2], int(a[3]), a[5], a[9], a[11:]


def _read_alignment_records(path: str):
    """SAM text or BAM/BGZF, sniffed by magic — one record-tuple stream.

    Users point ``mine_negative_junctions_sam`` (and anything else built on
    :func:`multihits_from_sam`) at their existing whole-genome archive in
    either format; the reference consumes a BAM here (functions.py:1425).
    """
    from anchored_fusion_tpu_torch.io.bam import is_bam, read_bam_records
    if is_bam(path):
        return read_bam_records(path)
    return _read_sam_tagged(path)


def _query_len(ops) -> int:
    """Query length from a parsed CIGAR (S/M/I/=/X consume query)."""
    return sum(n for n, op in ops if op in "SMI=X")


def _ref_offsets(ops, t0: int, t1: int):
    """Reference offsets (from SAM POS) of normalized-query positions t0/t1.

    Walks the original CIGAR in the normalized-query frame produced by
    :func:`normalize_cigar` (H dropped, I cut, D padded into the read): M/D
    consume query+ref, N consumes ref ONLY — so an intron skip inside the
    chosen M run advances the reference without advancing the query
    (``pos + mlen - 1`` would understate ref_end by the intron span of a
    spliced STAR-style alignment).  S consumes query only; I/H/P neither.
    """
    nq = rq = 0
    r0 = r1 = None
    for n, op in ops:
        op = "M" if op in "=X" else op
        if op in "MD":
            if nq <= t0 < nq + n:
                r0 = rq + (t0 - nq)
            if nq <= t1 < nq + n:
                r1 = rq + (t1 - nq)
            nq += n
            rq += n
        elif op == "N":
            rq += n
        elif op == "S":
            nq += n
    return r0, r1


def multihits_from_sam(path: str, genome):
    """Parse a SAM text or BAM file into flat :class:`MultiHits` records.

    External-alignment ingestion: users with an
    existing whole-genome BAM (the reference's filter setup consumes one and
    mines SA-tagged chimeras from it, functions.py:1425-1441) can reuse it —
    e.g. via ``mine_negative_junctions_sam`` — instead of re-aligning the
    sample in-framework.  Every mapped record (primary, secondary 0x100,
    supplementary 0x800 — bwa writes SA-tagged splits as extra lines) becomes
    one hit; CIGARs go through :func:`normalize_cigar` (deal_cigar parity),
    the longest M run defines the aligned block, and query coordinates are
    returned in the PSL forward-query frame MultiHits uses.

    Tag handling: ``NM:i`` refines ``matches`` (M length − edit distance),
    ``AS:i`` supplies ``score`` (else matches).  Reference skips: records on
    contigs the genome doesn't contain.

    Args:
      path:   SAM text file or BAM/BGZF archive (sniffed by magic).
      genome: io.fasta.Reference providing contig -> global offsets.
    Returns:
      (names, read_lens, MultiHits) — ``names[i]``/``read_lens[i]`` describe
      read id ``i``; hit ``read_id`` indexes into them (ids assigned by first
      appearance of each QNAME).
    """
    import numpy as np
    from anchored_fusion_tpu_torch.align.aligner import MultiHits

    name_to_id = {}
    names, read_lens = [], []
    rid_l, strand_l, score_l, match_l, len_l = [], [], [], [], []
    qs_l, qe_l, rs_l, re_l = [], [], [], []
    for name, flag, rname, pos1, cigar, seq, tags in \
            _read_alignment_records(path):
        if flag & SAM_FLAG_UNMAPPED or cigar in ("*", ""):
            continue
        ops = parse_cigar(cigar)
        # full-read frame: hard clips consume read bases bwa's SA-tagged
        # supplementary records drop from SEQ (clipped-frame coordinates
        # against full read_lens would misclassify MS/SM junction sides)
        h_total = sum(n for n, op in ops if op == "H")
        h_lead = 0
        for n, op in ops:
            if op != "H":
                break
            h_lead += n
        L = _query_len(ops) + h_total
        if L == 0:
            continue
        if name not in name_to_id:
            name_to_id[name] = len(names)
            names.append(name)
            read_lens.append(L)
        rid = name_to_id[name]
        read_lens[rid] = max(read_lens[rid], L)
        if rname not in genome._name_to_id:
            continue
        # normalize to the <=3-op S/M/S frame ('*' SEQ of secondary records
        # only needs a correctly-sized placeholder for the N-padding algebra)
        res, _ = normalize_cigar(cigar, seq if seq != "*" else "N" * (L - h_total))
        m_runs = [r for r in res if r[2] == "M"]
        if not m_runs:
            continue
        cum_end, mlen, _ = max(m_runs, key=lambda r: r[1])
        # 0-based inclusive, full-read frame (leading-H shift); reverse flips
        # through the full length so trailing H lands on the other side too
        s0, e0 = cum_end - mlen + h_lead, cum_end - 1 + h_lead
        rev = bool(flag & SAM_FLAG_REVERSE)
        qs, qe = ((L - 1 - e0, L - 1 - s0) if rev else (s0, e0))
        nm = None
        score = None
        for t in tags:
            if t.startswith("NM:i:"):
                nm = int(t[5:])
            elif t.startswith("AS:i:"):
                score = int(t[5:])
        matches = max(0, mlen - nm) if nm is not None else mlen
        rid_l.append(rid)
        strand_l.append(1 if rev else 0)
        score_l.append(score if score is not None else matches)
        match_l.append(matches)
        len_l.append(mlen)
        qs_l.append(qs)
        qe_l.append(qe)
        g = genome.to_global(rname, pos1)
        # ref span of the chosen run from the ORIGINAL ops: N (intron) bases
        # consume reference the normalized frame dropped (_ref_offsets)
        r0, r1 = _ref_offsets(ops, cum_end - mlen, cum_end - 1)
        rs_l.append(g + (r0 if r0 is not None else 0))
        re_l.append(g + (r1 if r1 is not None else mlen - 1))
    mh = MultiHits(
        read_id=np.asarray(rid_l, np.int32),
        strand=np.asarray(strand_l, np.int8),
        score=np.asarray(score_l, np.int32),
        matches=np.asarray(match_l, np.int32),
        length=np.asarray(len_l, np.int32),
        q_start=np.asarray(qs_l, np.int32),
        q_end=np.asarray(qe_l, np.int32),
        ref_start=np.asarray(rs_l, np.int64),
        ref_end=np.asarray(re_l, np.int64),
    )
    return names, np.asarray(read_lens, np.int64), mh
