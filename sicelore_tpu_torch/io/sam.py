"""SAM text codec: SAM <-> BamRecord (samtools-view role).

Needed to ingest minimap2's SAM output without samtools and for
human-readable debugging. SAMv1 spec §1.4-1.5.
"""
from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterator

from sicelore_tpu_torch.io.bam import BamHeader, BamRecord, BamWriter, CIGAR_OPS

_TYPE_PARSE = {"A": str, "i": int, "f": float, "Z": str, "H": str}


def _parse_tag(field: str):
    tag, tc, val = field.split(":", 2)
    if tc == "B":
        sub = val[0]
        vals = [float(x) if sub == "f" else int(x)
                for x in val[1:].lstrip(",").split(",")]
        return (tag, "B" + sub, vals)
    return (tag, tc, _TYPE_PARSE[tc](val))


def _parse_cigar(s: str):
    if s == "*":
        return []
    out = []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((ch, n))
            n = 0
    return out


def parse_sam_line(line: str) -> BamRecord | tuple[None, str]:
    f = line.rstrip("\n").split("\t")
    rec = BamRecord(
        qname=f[0], flag=int(f[1]), ref_id=-1, pos=int(f[3]) - 1,
        mapq=int(f[4]), cigar=_parse_cigar(f[5]),
        seq="" if f[9] == "*" else f[9],
        qual=b"" if f[10] == "*" else bytes(ord(c) - 33 for c in f[10]),
        tags=[_parse_tag(x) for x in f[11:]],
        next_pos=int(f[7]) - 1, tlen=int(f[8]))
    return rec, f[2], f[6]  # record, rname, rnext


def read_sam(path: str | Path) -> tuple[BamHeader, Iterator[BamRecord]]:
    """Parse a SAM file -> (header, record iterator). Reference names are
    resolved against @SQ lines (records with unknown rname get ref_id -1)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    fh = opener(str(path), "rt")
    header_lines = []
    refs = []
    first_record = None
    for line in fh:
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                d = dict(x.split(":", 1) for x in line.rstrip().split("\t")[1:]
                         if ":" in x)
                refs.append((d.get("SN", "?"), int(d.get("LN", 0))))
        else:
            first_record = line
            break
    header = BamHeader("".join(header_lines), refs)
    ref_idx = {n: i for i, (n, _) in enumerate(refs)}

    def records():
        def emit(line):
            rec, rname, rnext = parse_sam_line(line)
            rec.ref_id = ref_idx.get(rname, -1)
            rec.next_ref_id = (rec.ref_id if rnext == "="
                               else ref_idx.get(rnext, -1))
            return rec
        if first_record is not None:
            yield emit(first_record)
        for line in fh:
            if line.strip():
                yield emit(line)
        fh.close()

    return header, records()


def sam_to_bam(sam_path, bam_path) -> int:
    header, records = read_sam(sam_path)
    n = 0
    with BamWriter(bam_path, header) as w:
        for rec in records:
            w.write(rec)
            n += 1
    return n


def record_to_sam_line(rec: BamRecord, ref_names: list[str]) -> str:
    rname = ref_names[rec.ref_id] if 0 <= rec.ref_id < len(ref_names) else "*"
    rnext = ("=" if rec.next_ref_id == rec.ref_id and rec.ref_id >= 0
             else (ref_names[rec.next_ref_id]
                   if 0 <= rec.next_ref_id < len(ref_names) else "*"))
    cig = "".join(f"{n}{op}" for op, n in rec.cigar) or "*"
    qual = ("".join(chr(q + 33) for q in rec.qual) if rec.qual else "*")
    tags = []
    for tag, tc, v in rec.tags:
        if tc.startswith("B"):
            tags.append(f"{tag}:B:{tc[1]}," + ",".join(str(x) for x in v))
        elif tc in ("c", "C", "s", "S", "i", "I"):
            tags.append(f"{tag}:i:{v}")
        else:
            tags.append(f"{tag}:{tc}:{v}")
    fields = [rec.qname, str(rec.flag), rname, str(rec.pos + 1),
              str(rec.mapq), cig, rnext, str(rec.next_pos + 1),
              str(rec.tlen), rec.seq or "*", qual] + tags
    return "\t".join(fields) + "\n"


def bam_to_sam(bam_path, sam_path) -> int:
    from sicelore_tpu_torch.io.bam import BamReader
    n = 0
    with BamReader(bam_path) as rd, open(sam_path, "w") as fh:
        fh.write(rd.header.text)
        ref_names = [x for x, _ in rd.header.refs]
        for rec in rd:
            fh.write(record_to_sam_line(rec, ref_names))
            n += 1
    return n
