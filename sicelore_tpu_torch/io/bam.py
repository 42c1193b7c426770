"""BAM reader/writer + record model (htsjdk-role replacement).

The reference does all its BAM work through htsjdk SAMRecord streams
(the Java reference src: utils/LongreadParser.java, programs/* — stream-rewrite
pattern). Here: a self-contained BAM codec over the BGZF layer with a
lightweight record class whose SAM tags round-trip byte-exactly; columnar
batch decode for device feeding lives with the consumers.

Spec: SAMv1.pdf §4 (BAM). CIGAR ops MIDNSHP=X; seq nibble code
=ACMGRSVTWYHKDBN.
"""
from __future__ import annotations

import heapq
import struct
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

from sicelore_tpu_torch.io.bgzf import BGZFReader, BGZFWriter
from sicelore_tpu_torch.utils import trace

BAM_MAGIC = b"BAM\x01"
CIGAR_OPS = "MIDNSHP=X"
SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIB = {c: i for i, c in enumerate(SEQ_NIBBLE)}
# packed SEQ -> letters: `bytes.hex()` spells each nibble as a hex digit,
# high nibble first, and this maps each digit to its base
_HEX_TO_BASE = str.maketrans("0123456789abcdef", SEQ_NIBBLE)
_FIXED = struct.Struct("<iiBBHHHiiii")
_CONSUMES_REF = frozenset("MDN=X")
_CONSUMES_QUERY = frozenset("MIS=X")


@dataclass
class BamHeader:
    text: str = ""
    refs: list[tuple[str, int]] = field(default_factory=list)

    def ref_id(self, name: str) -> int:
        for i, (n, _) in enumerate(self.refs):
            if n == name:
                return i
        return -1


class BamRecord:
    """One alignment record. `seq` is a `str` of `SEQ_NIBBLE` letters; a
    record from `decode_record` holds SEQ as its packed nibble bytes and
    spells it out on the first read of `seq` (counter `bam.seq_decoded`,
    bases, while the program's tracer is on). `l_seq` is its length
    either way."""
    __slots__ = ("qname", "flag", "ref_id", "pos", "mapq", "cigar",
                 "next_ref_id", "next_pos", "tlen", "_seq", "_packed",
                 "_l_seq", "qual", "tags", "_bin")

    def __init__(self, qname: str = "", flag: int = 4, ref_id: int = -1,
                 pos: int = -1, mapq: int = 0,
                 cigar: list[tuple[str, int]] | None = None,
                 seq: str = "", qual: bytes = b"",
                 tags: list[tuple[str, str, object]] | None = None,
                 next_ref_id: int = -1, next_pos: int = -1, tlen: int = 0):
        self.qname = qname
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos  # 0-based leftmost
        self.mapq = mapq
        self.cigar = cigar or []
        self.next_ref_id = next_ref_id
        self.next_pos = next_pos
        self.tlen = tlen
        self.seq = seq
        self.qual = qual  # raw phred bytes (not +33), b"" if absent
        self.tags = tags or []  # ordered [(tag, type_char, value)]
        self._bin = None

    @property
    def seq(self) -> str:
        if self._seq is None:
            self._seq = self._packed.hex().translate(_HEX_TO_BASE)[
                :self._l_seq]
            self._packed = None
            if trace.ON:
                trace.count("bam.seq_decoded", self._l_seq)
        return self._seq

    @seq.setter
    def seq(self, value: str):
        self._seq = value
        self._packed = None
        self._l_seq = len(value)

    @property
    def l_seq(self) -> int:
        return self._l_seq

    # -- flags ----------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & 0x800)

    # -- tags -----------------------------------------------------------
    def get_tag(self, tag: str, default=None):
        for t, _, v in self.tags:
            if t == tag:
                return v
        return default

    def set_tag(self, tag: str, value, type_char: str | None = None):
        if type_char is None:
            type_char = ("i" if isinstance(value, int)
                         else "f" if isinstance(value, float) else "Z")
        for i, (t, _, _) in enumerate(self.tags):
            if t == tag:
                self.tags[i] = (tag, type_char, value)
                return
        self.tags.append((tag, type_char, value))

    # -- geometry -------------------------------------------------------
    def reference_length(self) -> int:
        return sum(n for op, n in self.cigar if op in _CONSUMES_REF)

    def reference_end(self) -> int:
        """0-based exclusive end."""
        return self.pos + self.reference_length()

    def query_length(self) -> int:
        return sum(n for op, n in self.cigar if op in _CONSUMES_QUERY)

    def clip_left(self) -> int:
        c = self.cigar
        i, n = 0, 0
        while i < len(c) and c[i][0] in "HS":
            n += c[i][1]
            i += 1
        return n

    def clip_right(self) -> int:
        c = self.cigar
        i, n = len(c) - 1, 0
        while i >= 0 and c[i][0] in "HS":
            n += c[i][1]
            i -= 1
        return n


# ---------------------------------------------------------------------------
# record decode / encode
# ---------------------------------------------------------------------------

def decode_record(buf: bytes) -> BamRecord:
    (ref_id, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = _FIXED.unpack_from(buf, 0)
    off = 32
    qname = buf[off:off + l_qname - 1].decode()
    off += l_qname
    cigar = [(CIGAR_OPS[v & 0xF], v >> 4)
             for v in struct.unpack_from(f"<{n_cigar}I", buf, off)]
    off += 4 * n_cigar
    nseq = (l_seq + 1) // 2
    packed = buf[off:off + nseq]
    off += nseq
    qual = buf[off:off + l_seq]
    off += l_seq
    if qual[:1] == b"\xff":
        qual = b""
    rec = BamRecord(qname, flag, ref_id, pos, mapq, cigar, "", qual,
                    decode_tags(buf, off), next_ref, next_pos, tlen)
    if l_seq:
        rec._seq, rec._packed, rec._l_seq = None, packed, l_seq
    return rec


def decode_tags(buf: bytes, off: int) -> list[tuple[str, str, object]]:
    tags = []
    n = len(buf)
    while off < n:
        tag = buf[off:off + 2].decode()
        tc = chr(buf[off + 2])
        off += 3
        if tc == "A":
            tags.append((tag, tc, chr(buf[off]))); off += 1
        elif tc in "cC":
            v = struct.unpack_from("<b" if tc == "c" else "<B", buf, off)[0]
            tags.append((tag, tc, v)); off += 1
        elif tc in "sS":
            v = struct.unpack_from("<h" if tc == "s" else "<H", buf, off)[0]
            tags.append((tag, tc, v)); off += 2
        elif tc in "iI":
            v = struct.unpack_from("<i" if tc == "i" else "<I", buf, off)[0]
            tags.append((tag, tc, v)); off += 4
        elif tc == "f":
            tags.append((tag, tc, struct.unpack_from("<f", buf, off)[0]))
            off += 4
        elif tc in "ZH":
            end = buf.index(b"\x00", off)
            tags.append((tag, tc, buf[off:end].decode())); off = end + 1
        elif tc == "B":
            sub = chr(buf[off]); cnt = struct.unpack_from("<I", buf, off + 1)[0]
            off += 5
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[sub]
            sz = struct.calcsize(fmt)
            vals = list(struct.unpack_from(f"<{cnt}{fmt}", buf, off))
            off += cnt * sz
            tags.append((tag, "B" + sub, vals))
        else:
            raise ValueError(f"unknown tag type {tc!r} for {tag}")
    return tags


def encode_tags(tags) -> bytes:
    out = bytearray()
    for tag, tc, v in tags:
        out += tag.encode()
        if tc.startswith("B"):
            sub = tc[1]
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                   "I": "I", "f": "f"}[sub]
            out += b"B" + sub.encode() + struct.pack("<I", len(v))
            out += struct.pack(f"<{len(v)}{fmt}", *v)
            continue
        out += tc.encode()
        if tc == "A":
            out += v.encode() if isinstance(v, str) else bytes([v])
        elif tc == "c":
            out += struct.pack("<b", v)
        elif tc == "C":
            out += struct.pack("<B", v)
        elif tc == "s":
            out += struct.pack("<h", v)
        elif tc == "S":
            out += struct.pack("<H", v)
        elif tc == "i":
            out += struct.pack("<i", v)
        elif tc == "I":
            out += struct.pack("<I", v)
        elif tc == "f":
            out += struct.pack("<f", float(v))
        elif tc in "ZH":
            out += str(v).encode() + b"\x00"
        else:
            raise ValueError(f"unknown tag type {tc!r} for {tag}")
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_record(rec: BamRecord) -> bytes:
    qname_b = rec.qname.encode() + b"\x00"
    cigar_b = b"".join(
        struct.pack("<I", (n << 4) | CIGAR_OPS.index(op))
        for op, n in rec.cigar)
    l_seq = len(rec.seq)
    seq_b = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(rec.seq):
        nib = _NIB.get(ch, 15)
        if i % 2 == 0:
            seq_b[i // 2] = nib << 4
        else:
            seq_b[i // 2] |= nib
    qual_b = rec.qual if rec.qual else b"\xff" * l_seq
    if len(qual_b) != l_seq:
        raise ValueError(f"qual length {len(qual_b)} != seq length {l_seq} "
                         f"for {rec.qname}")
    tags_b = encode_tags(rec.tags)
    end = rec.reference_end() if rec.cigar else rec.pos + 1
    bin_ = _reg2bin(max(rec.pos, 0), max(end, rec.pos + 1)) if rec.pos >= 0 else 4680
    body = struct.pack("<iiBBHHHiiii", rec.ref_id, rec.pos, len(qname_b),
                       rec.mapq, bin_, len(rec.cigar), rec.flag, l_seq,
                       rec.next_ref_id, rec.next_pos, rec.tlen)
    return (struct.pack("<i", len(body) + len(qname_b) + len(cigar_b)
                        + len(seq_b) + len(qual_b) + len(tags_b))
            + body + qname_b + cigar_b + bytes(seq_b) + qual_b + tags_b)


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------

class BamReader:
    def __init__(self, path: str | Path):
        self._r = BGZFReader(path)
        magic = self._r.read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._r.read(4))[0]
        text = self._r.read(l_text).split(b"\x00")[0].decode()
        n_ref = struct.unpack("<i", self._r.read(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._r.read(4))[0]
            name = self._r.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._r.read(4))[0]
            refs.append((name, l_ref))
        self.header = BamHeader(text, refs)

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            rec = self.read_record()
            if rec is None:
                return
            yield rec

    def read_record(self) -> BamRecord | None:
        buf = self.read_raw()
        return None if buf is None else decode_record(buf)

    def read_raw(self) -> bytes | None:
        """The next record's bytes as `decode_record` takes them, or None
        at the end."""
        szb = self._r.read(4)
        if len(szb) < 4:
            return None
        size = struct.unpack("<i", szb)[0]
        return self._r.read(size)

    def tell_virtual(self) -> int:
        return self._r.tell_virtual()

    def seek_virtual(self, v: int):
        self._r.seek_virtual(v)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    def __init__(self, path: str | Path, header: BamHeader, level: int = 6):
        self._w = BGZFWriter(path, level)
        self.header = header
        text = header.text.encode()
        self._w.write(BAM_MAGIC + struct.pack("<i", len(text)) + text
                      + struct.pack("<i", len(header.refs)))
        for name, length in header.refs:
            nb = name.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb
                          + struct.pack("<i", length))

    def write(self, rec: BamRecord):
        self._w.write(encode_record(rec))

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def sort_bam(in_path: str | Path, out_path: str | Path,
             max_in_mem: int = 500_000):
    """Coordinate-sort (ref_id, pos), unmapped last — samtools-sort role.

    In-memory chunks spilled as temporary BAMs + k-way merge."""
    rd = BamReader(in_path)
    header = rd.header

    def key(rec: BamRecord):
        r = rec.ref_id if rec.ref_id >= 0 else 1 << 30
        return (r, rec.pos)

    chunks: list[Path] = []
    buf: list[BamRecord] = []
    tmpdir = tempfile.mkdtemp(prefix="bamsort_")

    def spill():
        buf.sort(key=key)
        p = Path(tmpdir) / f"chunk{len(chunks)}.bam"
        with BamWriter(p, header, level=1) as w:
            for r in buf:
                w.write(r)
        chunks.append(p)
        buf.clear()

    for rec in rd:
        buf.append(rec)
        if len(buf) >= max_in_mem:
            spill()
    rd.close()
    if not chunks:
        buf.sort(key=key)
        with BamWriter(out_path, header) as w:
            for r in buf:
                w.write(r)
        return
    if buf:
        spill()
    readers = [BamReader(p) for p in chunks]
    heap = []
    for i, r in enumerate(readers):
        rec = r.read_record()
        if rec is not None:
            heapq.heappush(heap, (key(rec), i, rec))
    with BamWriter(out_path, header) as w:
        while heap:
            _, i, rec = heapq.heappop(heap)
            w.write(rec)
            nxt = readers[i].read_record()
            if nxt is not None:
                heapq.heappush(heap, (key(nxt), i, nxt))
    for r in readers:
        r.close()
    for p in chunks:
        p.unlink()
    Path(tmpdir).rmdir()


# ---------------------------------------------------------------------------
# BAI index (samtools-index role): writer + region query
# ---------------------------------------------------------------------------
#
# The reference depends on htsjdk indexed queries for per-position pileups
# (SNPMatrix.java:138-141 queryOverlapping) and the CollapseModel isobam
# loader's per-chromosome pass (UCSCRefFlatParser.java:138-208). Format:
# SAMv1 §5.2 — R-tree binning (reg2bin) chunks + a 16 kb linear index.

BAI_MAGIC = b"BAI\x01"
_LINEAR_SHIFT = 14  # 16 kb windows


def _reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (SAMv1 §5.3)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def build_bai(bam_path: str | Path, bai_path: str | Path | None = None):
    """Index a coordinate-sorted BAM; writes `<bam>.bai`."""
    bai_path = Path(bai_path) if bai_path else Path(str(bam_path) + ".bai")
    rd = BamReader(bam_path)
    n_ref = len(rd.header.refs)
    bins: list[dict[int, list[list[int]]]] = [dict() for _ in range(n_ref)]
    linear: list[dict[int, int]] = [dict() for _ in range(n_ref)]
    prev_key = (-2, -1)
    while True:
        vbeg = rd.tell_virtual()
        rec = rd.read_record()
        if rec is None:
            break
        vend = rd.tell_virtual()
        if rec.ref_id < 0 or rec.is_unmapped:
            continue
        key = (rec.ref_id, rec.pos)
        if key < prev_key:
            raise ValueError("BAM is not coordinate-sorted; sort_bam first")
        prev_key = key
        end = rec.reference_end() if rec.cigar else rec.pos + 1
        b = _reg2bin(rec.pos, max(end, rec.pos + 1))
        chunks = bins[rec.ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1][1] = vend  # merge adjacent chunks
        else:
            chunks.append([vbeg, vend])
        lin = linear[rec.ref_id]
        for w in range(rec.pos >> _LINEAR_SHIFT,
                       ((max(end, rec.pos + 1) - 1) >> _LINEAR_SHIFT) + 1):
            if w not in lin or vbeg < lin[w]:
                lin[w] = vbeg
    rd.close()
    with open(bai_path, "wb") as fh:
        fh.write(BAI_MAGIC + struct.pack("<i", n_ref))
        for r in range(n_ref):
            fh.write(struct.pack("<i", len(bins[r])))
            for b in sorted(bins[r]):
                chunks = bins[r][b]
                fh.write(struct.pack("<Ii", b, len(chunks)))
                for beg, cend in chunks:
                    fh.write(struct.pack("<QQ", beg, cend))
            lin = linear[r]
            n_intv = (max(lin) + 1) if lin else 0
            fh.write(struct.pack("<i", n_intv))
            filled = 0
            for w in range(n_intv):
                filled = lin.get(w, filled)
                fh.write(struct.pack("<Q", filled))
    return bai_path


def load_bai(bai_path: str | Path):
    """-> per-ref (bins {bin: [(vbeg, vend)]}, linear [uint64])."""
    with open(bai_path, "rb") as fh:
        data = fh.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"{bai_path}: not a BAI index")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        b = {}
        for _ in range(n_bin):
            bin_, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            cl = []
            for _ in range(n_chunk):
                beg, cend = struct.unpack_from("<QQ", data, off)
                off += 16
                cl.append((beg, cend))
            b[bin_] = cl
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        refs.append((b, lin))
    return refs


class IndexedBamReader(BamReader):
    """BamReader + region queries through a .bai index."""

    def __init__(self, path: str | Path, bai_path: str | Path | None = None):
        super().__init__(path)
        bai = Path(bai_path) if bai_path else Path(str(path) + ".bai")
        if not bai.exists():
            build_bai(path, bai)
        self._index = load_bai(bai)

    def fetch(self, chrom: str, start: int, end: int):
        """Yield records overlapping [start, end) (0-based half-open),
        in file order — htsjdk queryOverlapping role."""
        rid = self.header.ref_id(chrom)
        if rid < 0 or rid >= len(self._index):
            return
        bins, linear = self._index[rid]
        w = start >> _LINEAR_SHIFT
        min_off = linear[w] if w < len(linear) else (linear[-1] if linear
                                                     else 0)
        chunks = []
        for b in _reg2bins(start, max(end, start + 1)):
            for beg, cend in bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(beg, min_off), cend))
        if not chunks:
            return
        chunks.sort()
        merged = [list(chunks[0])]
        for beg, cend in chunks[1:]:
            if beg <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], cend)
            else:
                merged.append([beg, cend])
        for beg, cend in merged:
            self.seek_virtual(beg)
            while self.tell_virtual() < cend:
                rec = self.read_record()
                if rec is None:
                    return
                if rec.ref_id != rid or rec.pos >= end:
                    break
                rend = rec.reference_end() if rec.cigar else rec.pos + 1
                if rend > start:
                    yield rec
