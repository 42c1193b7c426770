"""Fastq I/O: multi-file discovery, chunked batch reading, gz support.

Host-side equivalent of the jar's parallel fastq machinery
(readerwriter/FastqFileReader $ReadChunk/$Worker, FoundFiles, FastqWriterThreadPool;
reference README.md:155-162 "don't merge fastqs — multiple fastqs process much
faster"). Reads stream in fixed-size chunks that feed fixed-shape device
batches; writers append per output class (passed/failed), preserving the
reference's directory layout.
"""
from __future__ import annotations

import gzip
import io
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclass
class FastqChunk:
    """A chunk of reads as parallel lists (converted to tensors downstream)."""
    names: list[bytes]      # read name (without '@', without comment)
    comments: list[bytes]   # rest of header line (b"" if none)
    seqs: list[bytes]
    quals: list[bytes]

    def __len__(self) -> int:
        return len(self.names)


def find_fastq_files(directory: str | Path, pattern: str = r".*\.(fastq|fq)(\.gz)?$",
                     recursive: bool = True) -> list[Path]:
    """Recursive regex discovery of fastq files (jar FoundFiles equivalent)."""
    rx = re.compile(pattern)
    root = Path(directory)
    it = root.rglob("*") if recursive else root.glob("*")
    return sorted(p for p in it if p.is_file() and rx.match(p.name))


def _open(path: str | Path, mode: str = "rb"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode)
    return open(p, mode, buffering=1 << 20)


def read_fastq(path: str | Path, chunk_size: int = 50_000) -> Iterator[FastqChunk]:
    """Stream one fastq file in chunks of `chunk_size` reads.

    Record parsing runs in the native extension when present (one C pass
    creating exactly 4 bytes objects per record — the Python block parser
    it replaces was ~0.34 s per 32k-read warm e2e); the Python block
    parser remains the fallback.
    """
    from sicelore_tpu_torch.io import native as _native
    ext = _native.get_hostenc()
    if ext is not None and hasattr(ext, "parse_fastq"):
        yield from _read_fastq_native(path, chunk_size, ext)
        return
    names, comments, seqs, quals = [], [], [], []
    pend: list[bytes] = []  # parsed lines not yet grouped into records
    with _open(path) as fh:
        rem = b""
        while True:
            data = fh.read(8 << 20)
            if not data:
                break
            data = rem + data
            lines = data.split(b"\n")
            rem = lines.pop()  # partial trailing line (or b"")
            pend.extend(lines)
            n_rec = len(pend) // 4
            for ri in range(n_rec):
                header = pend[4 * ri]
                seq = pend[4 * ri + 1]
                qual = pend[4 * ri + 3]
                if header.endswith(b"\r"):
                    header = header[:-1]
                if seq.endswith(b"\r"):
                    seq = seq[:-1]
                if qual.endswith(b"\r"):
                    qual = qual[:-1]
                if not header.startswith(b"@"):
                    raise ValueError(
                        f"malformed fastq header in {path}: {header[:60]!r}")
                sp = header.find(b" ")
                if sp == -1:
                    name, comment = header[1:], b""
                else:
                    name, comment = header[1:sp], header[sp + 1:]
                names.append(name)
                comments.append(comment)
                seqs.append(seq)
                quals.append(qual)
                if len(names) >= chunk_size:
                    yield FastqChunk(names, comments, seqs, quals)
                    names, comments, seqs, quals = [], [], [], []
            del pend[:4 * n_rec]
        # trailing lines (file not ending in newline / partial record)
        if rem:
            pend.append(rem)
        while pend and not pend[-1]:
            pend.pop()
        if pend:
            header = pend[0].rstrip(b"\r")
            seq = pend[1].rstrip(b"\r") if len(pend) > 1 else b""
            qual = pend[3].rstrip(b"\r") if len(pend) > 3 else b""
            if qual or seq:
                if not header.startswith(b"@"):
                    raise ValueError(
                        f"malformed fastq header in {path}: {header[:60]!r}")
                sp = header.find(b" ")
                if sp == -1:
                    name, comment = header[1:], b""
                else:
                    name, comment = header[1:sp], header[sp + 1:]
                names.append(name)
                comments.append(comment)
                seqs.append(seq)
                quals.append(qual)
    if names:
        yield FastqChunk(names, comments, seqs, quals)


def _read_fastq_native(path, chunk_size: int, ext) -> Iterator[FastqChunk]:
    names, comments, seqs, quals = [], [], [], []
    with _open(path) as fh:
        rem = b""
        while True:
            data = fh.read(8 << 20)
            if not data:
                break
            block = rem + data if rem else data
            try:
                ns, cs, ss, qs, used = ext.parse_fastq(block)
            except ValueError as e:
                raise ValueError(f"{e} in {path}") from None
            rem = block[used:]
            names.extend(ns)
            comments.extend(cs)
            seqs.extend(ss)
            quals.extend(qs)
            while len(names) >= chunk_size:
                yield FastqChunk(names[:chunk_size], comments[:chunk_size],
                                 seqs[:chunk_size], quals[:chunk_size])
                names = names[chunk_size:]
                comments = comments[chunk_size:]
                seqs = seqs[chunk_size:]
                quals = quals[chunk_size:]
        # trailing partial record (file not ending in newline)
        if rem.strip():
            lines = [ln.rstrip(b"\r") for ln in rem.split(b"\n")]
            while lines and not lines[-1]:
                lines.pop()
            if lines:
                header = lines[0]
                if not header.startswith(b"@"):
                    raise ValueError(
                        f"malformed fastq header in {path}: {header[:60]!r}")
                sp = header.find(b" ")
                name, comment = ((header[1:], b"") if sp == -1 else
                                 (header[1:sp], header[sp + 1:]))
                seq = lines[1] if len(lines) > 1 else b""
                qual = lines[3] if len(lines) > 3 else b""
                if seq or qual:
                    names.append(name)
                    comments.append(comment)
                    seqs.append(seq)
                    quals.append(qual)
    if names:
        yield FastqChunk(names, comments, seqs, quals)


def read_fastq_dirs(paths: list[str | Path], chunk_size: int = 50_000,
                    pattern: str = r".*\.(fastq|fq)(\.gz)?$") -> Iterator[FastqChunk]:
    """Stream reads from files and/or directories (recursively discovered)."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(find_fastq_files(p, pattern))
        else:
            files.append(p)
    for f in files:
        yield from read_fastq(f, chunk_size)


_write_pool = None
# Futures detached from their writer (async close path): writer_barrier()
# must .result() them so a failed background write/close (ENOSPC, gzip
# error) surfaces instead of silently truncating output (ADVICE r3).
_detached_futs: list = []


def _writer_pool():
    """One shared background writer thread: file writes leave the pipeline's
    critical path (the reference's FastqWriterThreadPool role); a single
    thread preserves per-writer record order."""
    global _write_pool
    if _write_pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _write_pool = ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="fastq-write")
    return _write_pool


class FastqWriter:
    """Buffered fastq writer (optionally gzip); writes happen on the shared
    background writer thread."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = _open(self.path, "wb")
        self._buf: list[bytes] = []
        self._futs: list = []

    def write(self, name: bytes, seq: bytes, qual: bytes, comment: bytes = b""):
        header = b"@" + name + ((b" " + comment) if comment else b"")
        self._buf.append(header + b"\n" + seq + b"\n+\n" + qual + b"\n")
        if len(self._buf) >= 4096:
            self.flush()

    def write_raw(self, records: bytes):
        """Append pre-assembled fastq records (native batch emitter)."""
        if records:
            self._buf.append(records)
            self.flush()

    def _submit(self, data: bytes):
        self._futs.append(_writer_pool().submit(self._fh.write, data))
        if len(self._futs) > 8:  # backpressure: bound queued bytes
            self._futs.pop(0).result()

    def flush(self):
        if self._buf:
            self._submit(b"".join(self._buf))
            self._buf.clear()

    def close(self, wait: bool = True):
        """Flush and close. With wait=False the close itself rides the
        writer thread (FIFO, so it lands after this writer's records) and
        the caller must eventually call writer_barrier() — the pipeline
        closes per-file writers async so disk writes overlap the next
        file's compute."""
        self.flush()
        if wait:
            for f in self._futs:
                f.result()
            self._futs.clear()
            self._fh.close()
        else:
            _detached_futs.extend(self._futs)
            _detached_futs.append(_writer_pool().submit(self._fh.close))
            self._futs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def writer_barrier():
    """Block until every queued background write/close has completed and
    re-raise the first error any of them hit."""
    if _write_pool is not None:
        _write_pool.submit(lambda: None).result()
    futs, _detached_futs[:] = list(_detached_futs), []
    for f in futs:
        f.result()


def load_fastq_dict(directory: str | Path) -> dict[bytes, tuple[bytes, bytes]]:
    """Whole-directory fastq -> {name: (seq, qual)} (reference FastqLoader,
    utils/FastqLoader.java — RAM-bound by design)."""
    out: dict[bytes, tuple[bytes, bytes]] = {}
    d = Path(directory)
    files = find_fastq_files(d) if d.is_dir() else [d]
    for f in files:
        for chunk in read_fastq(f, chunk_size=200_000):
            for n, s, q in zip(chunk.names, chunk.seqs, chunk.quals):
                out[n] = (s, q)
    return out
