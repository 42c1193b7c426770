"""BGZF block-gzip codec (the BAM container format).

Self-contained replacement for the htsjdk/samtools BGZF layer the reference
relies on (the Java reference pom.xml: htsjdk BlockCompressed*Stream; no
samtools in this image). Pure zlib; block-level parallelism is possible
later via a C++ backend without changing this API.

Virtual file offsets follow the SAM spec: voffset = coffset << 16 | uoffset
(compressed block start, offset within uncompressed block) — the currency
of BAM indexing.
"""
from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

from sicelore_tpu_torch.utils import trace

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
MAX_BLOCK = 65280  # uncompressed payload per block (samtools default)


class BGZFReader:
    """Sequential BGZF reader with virtual-offset support.

    When the native parallel codec (native/build/libbgzf.so via io.native)
    is available the whole stream is inflated up front with a thread
    fan-out; otherwise blocks decode lazily in pure Python. Each inflate
    is a `bam.inflate` span of the program's tracer (the native one whole,
    or one a zlib block), and the inflated bytes its counter of that
    name, by `route`."""

    def __init__(self, path: str | Path, use_native: bool | None = None):
        self._fh = open(path, "rb")
        self._block = b""
        self._block_coffset = 0
        self._pos = 0  # position within current block
        self._native_data = None
        if use_native is not False:
            self._try_native(use_native is True)

    def _try_native(self, required: bool):
        from sicelore_tpu_torch.io import native
        try:
            size = os.fstat(self._fh.fileno()).st_size
        except OSError:
            return
        if size > (1 << 31) and not required:  # keep huge files lazy
            return
        if native.get_lib() is None:
            return
        raw = self._fh.read()
        with trace.span("bam.inflate", route="native"):
            res = native.bgzf_decompress(raw, want_offsets=True)
        if res is None:
            self._fh.seek(0)
            return
        data, coff, uoff = res
        trace.count("bam.inflate", len(data), route="native")
        self._native_data = data
        self._native_coff = coff
        self._native_uoff = uoff
        self._npos = 0

    def _native_read(self, n: int) -> bytes:
        out = self._native_data[self._npos:self._npos + n]
        self._npos += len(out)
        return out

    def _read_block(self) -> bool:
        self._block_coffset = self._fh.tell()
        hdr = self._fh.read(18)
        if len(hdr) == 0:
            self._block = b""
            self._pos = 0
            return False
        if len(hdr) < 18 or hdr[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF block (bad gzip/FEXTRA header)")
        xlen = struct.unpack("<H", hdr[10:12])[0]
        extra = hdr[12:18] + self._fh.read(xlen - 6)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2:i + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0]
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF: missing BC subfield")
        cdata = self._fh.read(bsize + 1 - 12 - xlen - 8)
        crc, isize = struct.unpack("<II", self._fh.read(8))
        with trace.span("bam.inflate", route="zlib"):
            self._block = zlib.decompress(cdata, -15)
        trace.count("bam.inflate", len(self._block), route="zlib")
        if len(self._block) != isize:
            raise ValueError("BGZF: ISIZE mismatch")
        self._pos = 0
        return True

    def read(self, n: int) -> bytes:
        if self._native_data is not None:
            return self._native_read(n)
        out = []
        need = n
        while need > 0:
            if self._pos >= len(self._block):
                if not self._read_block():
                    break
                if not self._block:  # empty (EOF) block: keep going
                    continue
            take = min(need, len(self._block) - self._pos)
            out.append(self._block[self._pos:self._pos + take])
            self._pos += take
            need -= take
        return b"".join(out)

    def tell_virtual(self) -> int:
        if self._native_data is not None:
            import numpy as np
            i = int(np.searchsorted(self._native_uoff, self._npos,
                                    side="right")) - 1
            i = max(i, 0)
            return (int(self._native_coff[i]) << 16) | (
                self._npos - int(self._native_uoff[i]))
        return (self._block_coffset << 16) | self._pos

    def seek_virtual(self, voffset: int):
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        if self._native_data is not None:
            import numpy as np
            i = int(np.searchsorted(self._native_coff, coffset))
            if i >= len(self._native_coff) or self._native_coff[i] != coffset:
                raise ValueError("seek to unknown BGZF block offset")
            self._npos = int(self._native_uoff[i]) + uoffset
            return
        self._fh.seek(coffset)
        self._block = b""
        self._pos = 0
        if not self._read_block():
            return
        self._pos = uoffset

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BGZFWriter:
    """BGZF writer; large buffered runs compress through the native
    parallel codec when available (tell_virtual stays exact: the native
    codec splits at the same MAX_BLOCK boundaries)."""

    _NATIVE_FLUSH = 128 * MAX_BLOCK  # whole blocks per native call (~8MB)

    def __init__(self, path: str | Path, level: int = 6,
                 use_native: bool | None = None):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._native = None
        if use_native is not False:
            from sicelore_tpu_torch.io import native
            if native.get_lib() is not None:
                self._native = native

    def write(self, data: bytes):
        self._buf += data
        if self._native is not None:
            if len(self._buf) >= self._NATIVE_FLUSH:
                self._drain_full_blocks()
        else:
            while len(self._buf) >= MAX_BLOCK:
                self._flush_block(self._buf[:MAX_BLOCK])
                del self._buf[:MAX_BLOCK]

    def _drain_full_blocks(self):
        """Compress out every complete MAX_BLOCK chunk (leaves < MAX_BLOCK
        buffered so virtual offsets stay exact block boundaries)."""
        nfull = len(self._buf) // MAX_BLOCK
        if not nfull:
            return
        chunk = bytes(self._buf[:nfull * MAX_BLOCK])
        if self._native is not None:
            comp = self._native.bgzf_compress(chunk, self._level)
            if comp is not None:
                del self._buf[:len(chunk)]
                self._fh.write(comp)
                return
            self._native = None  # native failure: fall back forever
        while len(self._buf) >= MAX_BLOCK:
            self._flush_block(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]

    def tell_virtual(self) -> int:
        self._drain_full_blocks()
        return (self._fh.tell() << 16) | len(self._buf)

    def _flush_block(self, payload: bytes):
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(payload)) + co.flush()
        bsize = len(cdata) + 25  # header(10+2+6) + cdata + crc/isize(8) - 1
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                  + struct.pack("<H", 6)  # XLEN
                  + b"BC" + struct.pack("<HH", 2, bsize))
        self._fh.write(header + cdata
                       + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                     len(payload)))

    def close(self):
        while self._buf:
            self._flush_block(bytes(self._buf[:MAX_BLOCK]))
            del self._buf[:MAX_BLOCK]
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
