"""Read-name metadata codec — the stage-1 -> stage-3 data contract.

scanfastq appends barcode-assignment metadata to read names; assignumis
recovers it from the BAM read names. Format reproduced byte-for-byte from
the reference (the Java reference, README.md:396-459, Jar/config.xml:40-53):

  orig[sp2]_FWD_PS=566_PE=590_AE=619[_T=40]_bc=TCCG..._ed=0_ed_sec=2147483647
      _bcStart=618_bcEnd=603_rk=2987_X=AAAA..._Q=27.1

  FWD/REV    read orientation (positions are in the STRANDED read)
  PS/PE      first/last A of the polyA
  AE         last adapter base before the cell BC
  T          last TSO base before cDNA (only when found)
  bc         assigned barcode sequence
  ed/ed_sec  Levenshtein distance of best/second-best barcode
             (ed_sec = 2147483647 = INTMAX when none found)
  bcStart/bcEnd  barcode start/end in the stranded read (descending:
             the BC reads 3'->5' on the stranded read)
  rk         barcode rank by read count (1 = most reads)
  X          polyA start .. 3 bases of adapter, forward on stranded read
  Q          mean QV of the X= region (1 decimal)
  sp2        second part of a split chimeric read
"""
from __future__ import annotations

import re
from dataclasses import dataclass

INT_MAX = 2**31 - 1


@dataclass
class ScanInfo:
    """Parsed scanfastq read-name metadata."""
    orig_name: str
    is_fwd: bool
    ps: int
    pe: int
    ae: int
    tso_end: int | None = None
    bc: str | None = None
    ed: int | None = None
    ed_sec: int | None = None
    bc_start: int | None = None
    bc_end: int | None = None
    rank: int | None = None
    x_seq: str | None = None
    x_qv: float | None = None
    is_split: bool = False  # sp2 chimera part


def encode_name(orig: bytes, *, is_fwd: bool, ps: int, pe: int, ae: int,
                bc: str, ed: int, ed_sec: int, bc_start: int, bc_end: int,
                rank: int, x_seq: bytes, x_qv: float,
                tso_end: int | None = None, split_part: int = 0) -> bytes:
    """Assemble the passed-read name. split_part>=2 appends spN to orig."""
    parts = [orig + (f"sp{split_part}".encode() if split_part >= 2 else b""),
             b"FWD" if is_fwd else b"REV",
             b"PS=%d" % ps, b"PE=%d" % pe, b"AE=%d" % ae]
    if tso_end is not None and tso_end >= 0:
        parts.append(b"T=%d" % tso_end)
    parts += [b"bc=" + bc.encode(), b"ed=%d" % ed, b"ed_sec=%d" % ed_sec,
              b"bcStart=%d" % bc_start, b"bcEnd=%d" % bc_end,
              b"rk=%d" % rank, b"X=" + x_seq,
              b"Q=" + (b"%.1f" % x_qv)]
    return b"_".join(parts)


_NAME_RE = re.compile(
    r"^(?P<orig>.*?)_(?P<strand>FWD|REV)"
    r"_PS=(?P<ps>-?\d+)_PE=(?P<pe>-?\d+)_AE=(?P<ae>-?\d+)"
    r"(?:_T=(?P<t>-?\d+))?"
    r"_bc=(?P<bc>[ACGTN]*)_ed=(?P<ed>-?\d+)_ed_sec=(?P<edsec>-?\d+)"
    r"_bcStart=(?P<bcs>-?\d+)_bcEnd=(?P<bce>-?\d+)_rk=(?P<rk>-?\d+)"
    r"_X=(?P<x>[ACGTN]*)_Q=(?P<q>-?[\d.]+)$")


def parse_name(name: bytes | str) -> ScanInfo | None:
    """Parse a scanfastq-produced read name; None if it has no metadata."""
    if isinstance(name, bytes):
        name = name.decode()
    m = _NAME_RE.match(name)
    if not m:
        return None
    orig = m.group("orig")
    is_split = orig.endswith("sp2") or bool(re.search(r"sp\d+$", orig))
    return ScanInfo(
        orig_name=orig,
        is_fwd=m.group("strand") == "FWD",
        ps=int(m.group("ps")), pe=int(m.group("pe")), ae=int(m.group("ae")),
        tso_end=int(m.group("t")) if m.group("t") is not None else None,
        bc=m.group("bc") or None,
        ed=int(m.group("ed")), ed_sec=int(m.group("edsec")),
        bc_start=int(m.group("bcs")), bc_end=int(m.group("bce")),
        rank=int(m.group("rk")),
        x_seq=m.group("x") or None, x_qv=float(m.group("q")),
        is_split=is_split)
