"""BAM/BGZF ingestion (and a minimal writer for fixtures/interop).

The reference's filter setup consumes an existing whole-genome **BAM**
(functions.py:1425-1441, Anchored_Fusion.py:102); real-world alignment
archives are BAM, not SAM text, so :func:`read_bam_records` decodes them
directly into the same record tuples :mod:`io.sam` parses — no samtools
round trip.  Standard library only (``gzip``, ``struct``, ``zlib``).

BGZF is a sequence of concatenated gzip members (each <=64KiB of payload,
carrying its compressed size in a ``BC`` extra subfield used only for random
access, which this sequential reader doesn't need).  Python's ``gzip`` module
decodes concatenated members natively, so the reader streams through
``gzip.open`` — memory stays flat however large the archive is.

Layout (SAM spec §4.2, little-endian throughout):
  magic "BAM\\1" | l_text text | n_ref (l_name name\\0 l_ref)*
  records: block_size, refID, pos(0-based), l_read_name, mapq, bin,
  n_cigar_op, flag, l_seq, next_refID, next_pos, tlen, read_name\\0,
  cigar u32[n] (len<<4|op), seq 4-bit packed, qual, tags.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import Iterator, List, Sequence, Tuple

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_TAG_FMT = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2), "S": ("<H", 2),
            "i": ("<i", 4), "I": ("<I", 4), "f": ("<f", 4)}
# SAM text renders every integer subtype as 'i' (spec §1.5) and float as 'f'
_TAG_SAM_TYPE = {"c": "i", "C": "i", "s": "i", "S": "i", "i": "i", "I": "i",
                 "f": "f", "A": "A", "Z": "Z", "H": "H", "B": "B"}


def _read_exact(fh, n: int) -> bytes:
    buf = fh.read(n)
    if len(buf) != n:
        raise EOFError(f"truncated BAM: wanted {n} bytes, got {len(buf)}")
    return buf


def _decode_tags(buf: bytes) -> List[str]:
    """Binary optional fields -> SAM text form (``NM:i:6``, ``AS:i:40``...)."""
    out: List[str] = []
    i = 0
    n = len(buf)
    while i + 3 <= n:
        tag = buf[i:i + 2].decode("ascii")
        vt = chr(buf[i + 2])
        i += 3
        if vt == "A":
            out.append(f"{tag}:A:{chr(buf[i])}")
            i += 1
        elif vt in _TAG_FMT:
            fmt, sz = _TAG_FMT[vt]
            (v,) = struct.unpack_from(fmt, buf, i)
            i += sz
            out.append(f"{tag}:{_TAG_SAM_TYPE[vt]}:{v}")
        elif vt in "ZH":
            end = buf.index(b"\0", i)
            out.append(f"{tag}:{vt}:{buf[i:end].decode('ascii')}")
            i = end + 1
        elif vt == "B":
            sub = chr(buf[i])
            (cnt,) = struct.unpack_from("<i", buf, i + 1)
            fmt, sz = _TAG_FMT[sub]
            vals = struct.unpack_from("<" + fmt[1] * cnt, buf, i + 5)
            i += 5 + cnt * sz
            out.append(f"{tag}:B:{sub}," + ",".join(str(v) for v in vals))
        else:
            raise ValueError(f"unknown BAM tag value type {vt!r}")
    return out


def read_bam_header(path: str) -> Tuple[str, List[Tuple[str, int]]]:
    """(header_text, [(ref_name, ref_len), ...])."""
    with gzip.open(path, "rb") as fh:
        if _read_exact(fh, 4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", _read_exact(fh, 4))
        text = _read_exact(fh, l_text).split(b"\0", 1)[0].decode("ascii")
        (n_ref,) = struct.unpack("<i", _read_exact(fh, 4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(fh, 4))
            name = _read_exact(fh, l_name)[:-1].decode("ascii")
            (l_ref,) = struct.unpack("<i", _read_exact(fh, 4))
            refs.append((name, l_ref))
        return text, refs


def read_bam_records(path: str) -> Iterator[Tuple[str, int, str, int, str,
                                                  str, List[str]]]:
    """Yield ``(name, flag, rname, pos1, cigar, seq, tags)`` per record —
    the exact tuple form :func:`io.sam._read_sam_tagged` yields, so every
    SAM consumer (``multihits_from_sam`` and everything above it) ingests
    BAM transparently."""
    with gzip.open(path, "rb") as fh:
        if _read_exact(fh, 4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic)")
        (l_text,) = struct.unpack("<i", _read_exact(fh, 4))
        _read_exact(fh, l_text)
        (n_ref,) = struct.unpack("<i", _read_exact(fh, 4))
        ref_names = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", _read_exact(fh, 4))
            ref_names.append(_read_exact(fh, l_name)[:-1].decode("ascii"))
            _read_exact(fh, 4)                      # l_ref
        while True:
            head = fh.read(4)
            if len(head) == 0:
                return
            if len(head) != 4:
                raise EOFError("truncated BAM record length")
            (block_size,) = struct.unpack("<i", head)
            rec = _read_exact(fh, block_size)
            (ref_id, pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _next_ref, _next_pos, _tlen) = struct.unpack_from(
                "<iiBBHHHiiii", rec, 0)
            off = 32
            name = rec[off:off + l_read_name - 1].decode("ascii")
            off += l_read_name
            cig = struct.unpack_from(f"<{n_cigar}I", rec, off)
            off += 4 * n_cigar
            cigar = ("".join(f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in cig)
                     or "*")
            nb = (l_seq + 1) // 2
            sb = rec[off:off + nb]
            off += nb
            if l_seq:
                chars = []
                for b in sb:
                    chars.append(_SEQ_CODES[b >> 4])
                    chars.append(_SEQ_CODES[b & 0xF])
                seq = "".join(chars[:l_seq])
            else:
                seq = "*"
            off += l_seq                            # qual (unused)
            tags = _decode_tags(rec[off:])
            rname = ref_names[ref_id] if 0 <= ref_id < n_ref else "*"
            yield name, flag, rname, pos + 1, cigar, seq, tags


def is_bam(path: str) -> bool:
    """True if the file starts with the gzip magic (BGZF/BAM vs SAM text)."""
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


# ---------------------------------------------------------------------------
# writer (fixtures + interop)

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _bgzf_block(payload: bytes) -> bytes:
    """One BGZF member: gzip wrapper + BC extra subfield (BSIZE-1)."""
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    data = comp.compress(payload) + comp.flush()
    bsize = 12 + 6 + len(data) + 8                 # header+extra+data+crc/isize
    head = (b"\x1f\x8b\x08\x04" + b"\0\0\0\0" + b"\0\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1))
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload) & 0xFFFFFFFF)
    return head + data + tail


_TAG_TEXT_ENC = {"i": lambda v: b"i" + struct.pack("<i", int(v)),
                 "f": lambda v: b"f" + struct.pack("<f", float(v)),
                 "A": lambda v: b"A" + v.encode("ascii"),
                 "Z": lambda v: b"Z" + v.encode("ascii") + b"\0"}


def _encode_record(name: str, flag: int, ref_id: int, pos1: int, mapq: int,
                   cigar: str, seq: str, tags: Sequence[str]) -> bytes:
    from anchored_fusion_tpu_torch.io.sam import parse_cigar
    ops = parse_cigar(cigar)
    cig = b"".join(struct.pack("<I", (n << 4) | _CIGAR_OPS.index(op))
                   for n, op in ops)
    if seq == "*":
        l_seq, sb, qual = 0, b"", b""
    else:
        l_seq = len(seq)
        nibs = [_SEQ_CODES.index(c) if c in _SEQ_CODES else 15 for c in seq]
        if l_seq % 2:
            nibs.append(0)
        sb = bytes((nibs[i] << 4) | nibs[i + 1] for i in range(0, len(nibs), 2))
        qual = b"\xff" * l_seq
    tag_b = b""
    for t in tags:
        tag, vt, val = t.split(":", 2)
        tag_b += tag.encode("ascii") + _TAG_TEXT_ENC[vt](val)
    nm = name.encode("ascii") + b"\0"
    body = struct.pack("<iiBBHHHiiii", ref_id, pos1 - 1, len(nm), mapq,
                       0, len(ops), flag, l_seq, -1, -1, 0)
    body += nm + cig + sb + qual + tag_b
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, refs: Sequence[Tuple[str, int]], records,
              header_text: str = "@HD\tVN:1.6\tSO:unsorted\n"):
    """Minimal BAM writer.

    records: iterable of ``(name, flag, rname, pos1, mapq, cigar, seq,
    tags)`` with tags as SAM-text strings (``NM:i:6``).  Payload is split
    into <=64KiB BGZF members + the standard EOF block, so samtools (and
    this module's reader) accept the output.
    """
    name_to_id = {n: i for i, (n, _) in enumerate(refs)}
    head = b"BAM\x01"
    text = header_text.encode("ascii")
    head += struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(refs))
    for n, ln in refs:
        nb = n.encode("ascii") + b"\0"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    payload = bytearray(head)
    with open(path, "wb") as fh:
        def drain(final=False):
            while len(payload) >= 0xFF00 or (final and payload):
                fh.write(_bgzf_block(bytes(payload[:0xFF00])))
                del payload[:0xFF00]
        for name, flag, rname, pos1, mapq, cigar, seq, tags in records:
            payload += _encode_record(name, flag, name_to_id[rname], pos1,
                                      mapq, cigar, seq, tags)
            drain()
        drain(final=True)
        fh.write(_BGZF_EOF)
