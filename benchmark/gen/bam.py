"""A minimal BAM writer (BGZF blocks by zlib): mapped records of one
reference, with string and float tags and no sequence, as Step 4b reads
them. Independent of the program's own BAM code."""
from __future__ import annotations

import struct
import zlib

BLOCK = 0xff00        # uncompressed bytes a BGZF block
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                          "000000")


def reg2bin(beg: int, end: int) -> int:
    """The BAM bin of the 0-based half-open interval [beg, end) (SAM spec
    5.3)."""
    end -= 1
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return first + (beg >> shift)
    return 0


def _block(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    head = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6,
                       66, 67, 2, len(body) + 25)
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def record(qname: str, pos: int, tags, ref_id: int = 0, mapq: int = 60,
           match: int = 100) -> bytes:
    """One BAM record: `match`M at 0-based pos, flag 0, no sequence; tags
    are (tag, "Z", str) or (tag, "f", float)."""
    name = qname.encode() + b"\0"
    t = bytearray()
    for tag, typ, val in tags:
        t += tag.encode() + typ.encode()
        t += (val.encode() + b"\0") if typ == "Z" else struct.pack("<f", val)
    core = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name), mapq,
                       reg2bin(pos, pos + match), 1, 0, 0, -1, -1, 0)
    body = core + name + struct.pack("<I", match << 4) + bytes(t)
    return struct.pack("<i", len(body)) + body


def write_bam(path, records, refs=(("chr1", 1_000_000),), level: int = 1):
    """records: an iterable of encoded records (`record`). Returns the
    bytes written."""
    text = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs)
    head = bytearray(b"BAM\1" + struct.pack("<i", len(text)) + text.encode()
                     + struct.pack("<i", len(refs)))
    for n, ln in refs:
        head += struct.pack("<i", len(n) + 1) + n.encode() + b"\0" \
            + struct.pack("<i", ln)
    raw = bytes(head) + b"".join(records)
    with open(path, "wb") as fh:
        n = 0
        for i in range(0, len(raw), BLOCK):
            n += fh.write(_block(raw[i:i + BLOCK], level))
        n += fh.write(EOF_BLOCK)
    return n
