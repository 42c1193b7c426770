"""Step 1's read encoding: a chunk's raw bytes to the scans' int8 rows.

Port of the JAX main path's encoder route, which is not a Pallas kernel:
`sicelore_tpu/ops/edgescan.py::encode_composite_tm` (the native host
encoder, `native/hostenc`) with the device decode `unpack_tm` (`:147`),
and for the v1 scan `encode_composite_2bit` + `unpack_2bit`
(`sicelore_tpu/models/readscan.py:742, :734`). No Python loop touches a
read's bytes: the host joins the chunk's sequences and qualities into one
buffer each with their int64 offsets (`join`), writes each shard's span
with rebased offsets into a reusable pinned staging buffer (`Staged`) and
copies it up once (`Staged.upload`); csrc/encode.cu writes the rows.

  encode_two_half_dev   -> (codes [B, 2E] int8, qv2 [B, 2E] int8,
                            qsum [B] int32): ops/edgescan.encode_two_half's
                            rows (the v2 passes)
  encode_composite_dev  -> (codes [B, 2E] int8, qv [B, 2E] int8):
                            models/readscan.encode_composite's (v1)

The true lengths are the host's offsets' differences: nothing comes down
for them. A wrapper given CPU tensors runs its plain version
(`encode_two_half_plain`, `encode_composite_plain`: one gather index [B,
2E], the byte table and the masks as torch ops); given CUDA tensors it
launches the kernel or raises. Each counts its calls in `.launches`. The
numpy `encode_two_half` and `encode_composite` stay beside the scans as
the oracles the tests hold these to the JAX package with.
"""
from __future__ import annotations

import ctypes
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from sicelore_tpu_torch.ops import _build
from sicelore_tpu_torch.ops.edgescan import _ENC_PAD0, E
from sicelore_tpu_torch.utils import dna

W2 = 2 * E                  # a row: head and tail, or the v1 composite
STAGING_BYTES = 256 << 20   # the largest pinned staging buffer kept


class Chunk(NamedTuple):
    """A chunk's bytes on the host: seq uint8 [S] and qual uint8 [Q], the
    reads joined, with their offsets soffs and qoffs int64 [B + 1]."""
    seq: np.ndarray
    soffs: np.ndarray
    qual: np.ndarray
    qoffs: np.ndarray

    @property
    def lens(self) -> np.ndarray:
        """The reads' true lengths, int32 [B]."""
        return np.diff(self.soffs).astype(np.int32)


def _offsets(parts) -> np.ndarray:
    o = np.zeros(len(parts) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, parts), np.int64, len(parts)), out=o[1:])
    return o


def join(seqs, quals) -> Chunk:
    """One join a stream (writable buffers) and the offsets."""
    if len(seqs) != len(quals):
        raise ValueError(f"{len(seqs)} sequences, {len(quals)} qualities")
    return Chunk(np.frombuffer(bytearray().join(seqs), np.uint8),
                 _offsets(seqs),
                 np.frombuffer(bytearray().join(quals), np.uint8),
                 _offsets(quals))


class EncodeInputs(NamedTuple):
    """The wrappers' inputs on one device: seq, soffs, qual, qoffs, and the
    offsets on the host (host_soffs, host_qoffs), which the checks read."""
    seq: torch.Tensor
    soffs: torch.Tensor
    qual: torch.Tensor
    qoffs: torch.Tensor
    host_soffs: np.ndarray
    host_qoffs: np.ndarray

    def lens(self) -> torch.Tensor:
        """The reads' lengths on the inputs' device, int32 [B]."""
        return (self.soffs[1:] - self.soffs[:-1]).to(torch.int32)


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


class _Ring:
    """Two pinned staging buffers used in turn, each with the events of the
    copies read from it and the `Staged` that holds it with the spans it
    has still to upload. A buffer is written again only once its copies
    have completed, which in a pipeline that keeps one chunk in flight
    they have (the chunk before last was waited on); taking it while its
    holder is alive with a span not uploaded raises, since those bytes
    would be overwritten before they went up."""

    def __init__(self):
        self.lock = threading.Lock()
        self.bufs: list = [None, None]
        self.events: list[list] = [[], []]
        self.holders: list = [None, None]     # weakref to the Staged
        self.pending: list[set] = [set(), set()]
        self.next = 0

    def _alloc(self, cap: int) -> torch.Tensor:
        return torch.empty(cap, dtype=torch.uint8, pin_memory=True)

    def take(self, nbytes: int, holder, spans):
        """(index, a uint8 tensor of at least nbytes) for `holder` to stage
        `spans` in, once the copies from that buffer have completed."""
        with self.lock:
            i, ref = self.next, self.holders[self.next]
            if ref is not None and ref() is not None and self.pending[i]:
                raise RuntimeError(
                    f"staging buffer {i} still holds spans "
                    f"{sorted(self.pending[i])} not uploaded: upload every "
                    f"span before staging the chunk after next")
            self.next = 1 - i
            for ev in self.events[i]:
                ev.synchronize()
            self.events[i] = []
            self.holders[i] = weakref.ref(holder)
            self.pending[i] = set(spans)
            buf = self.bufs[i]
            if buf is None or buf.numel() < nbytes:
                self.bufs[i] = None
                buf = self.bufs[i] = self._alloc(
                    min(max(1 << 20, 1 << (nbytes - 1).bit_length()),
                        STAGING_BYTES))
            return i, buf

    def upload(self, i: int, holder, span, copy) -> None:
        """Run copy() (the upload of `holder`'s `span` from buffer i, which
        returns its event) and keep the event."""
        with self.lock:
            ref = self.holders[i]
            if ref is None or ref() is not holder:
                raise RuntimeError(f"staging buffer {i} was taken by a "
                                   f"later chunk")
            self.events[i].append(copy())
            self.pending[i].discard(span)


_ring = _Ring()


class Staged:
    """`chunk` cut into the shards' `spans` ([(a, b)]: rows [a, b)) for
    devices of `device_type`, each span ready for one upload. On the
    CPU the spans are views of the chunk. Otherwise each span's region
    (rebased soffs and qoffs, its sequence bytes, its quality bytes, each
    16-byte aligned; its upload whole 16-byte words, so the kernel's
    aligned copies of a span's edges stay inside it) lies in a pinned
    staging buffer of `_ring`, or, for a chunk over STAGING_BYTES, in
    pageable memory (a copy the host waits for). Upload every span before
    staging the chunk after next: the ring has two buffers, and staging a
    third chunk while the first is alive with a span not uploaded raises
    RuntimeError."""

    def __init__(self, chunk: Chunk, spans, device_type: str):
        self.chunk = chunk
        self.views = {}       # (a, b) -> EncodeInputs (CPU)
        self.regions = {}     # (a, b) -> (so, qo, region's byte offsets)
        layout, total = [], 0
        for a, b in spans:
            s0, s1 = int(chunk.soffs[a]), int(chunk.soffs[b])
            q0, q1 = int(chunk.qoffs[a]), int(chunk.qoffs[b])
            so, qo = chunk.soffs[a:b + 1] - s0, chunk.qoffs[a:b + 1] - q0
            if device_type == "cpu":
                self.views[(a, b)] = EncodeInputs(
                    torch.from_numpy(chunk.seq[s0:s1]), torch.from_numpy(so),
                    torch.from_numpy(chunk.qual[q0:q1]), torch.from_numpy(qo),
                    so, qo)
                continue
            no = _a16(so.nbytes)
            hs = total + 2 * no
            hq = hs + _a16(s1 - s0)
            layout.append((so, qo, (s0, s1), (q0, q1)))
            self.regions[(a, b)] = (so, qo, (total, no, hs, hq, hq + q1 - q0))
            total = _a16(hq + q1 - q0)
        self.ring_index = self.host = None
        if not layout:
            return
        if total <= STAGING_BYTES:
            self.ring_index, buf = _ring.take(total, self,
                                              list(self.regions))
            self.host = buf[:total]
        else:
            self.host = torch.empty(total, dtype=torch.uint8)
        hn = self.host.numpy()
        for (so, qo, (s0, s1), (q0, q1)), (_, _, (at, no, hs, hq, _)) in zip(
                layout, self.regions.values()):
            hn[at:at + so.nbytes] = so.view(np.uint8)
            hn[at + no:at + no + qo.nbytes] = qo.view(np.uint8)
            hn[hs:hs + s1 - s0] = chunk.seq[s0:s1]
            hn[hq:hq + q1 - q0] = chunk.qual[q0:q1]

    def upload(self, dev, a: int, b: int) -> EncodeInputs:
        """Span [a, b)'s inputs on `dev`: one copy of its region, on dev's
        current stream (the host does not wait for a pinned one)."""
        if (a, b) in self.views:
            return self.views[(a, b)]
        so, qo, (at, no, hs, hq, end) = self.regions[(a, b)]
        # whole 16-byte words: the kernel's aligned 16-byte copies of a
        # span's edges stay inside the region
        d = torch.empty(_a16(end - at), dtype=torch.uint8, device=dev)
        words = self.host[at:at + d.numel()]
        if self.ring_index is None:
            d.copy_(words)
        else:
            def copy():
                d.copy_(words, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d.device))
                return ev
            _ring.upload(self.ring_index, self, (a, b), copy)
        n8 = so.nbytes
        return EncodeInputs(d[hs - at:hq - at][:int(so[-1])],
                            d[:n8].view(torch.int64), d[hq - at:end - at],
                            d[no:no + n8].view(torch.int64), so, qo)


def chunk_inputs(seqs, quals, device) -> EncodeInputs:
    """A chunk's inputs on `device` in one upload (one shard)."""
    dev = torch.device(device)
    return Staged(join(seqs, quals), [(0, len(seqs))], dev.type).upload(
        dev, 0, len(seqs))


# ---------------------------------------------------------------------------
# Checks and plain versions
# ---------------------------------------------------------------------------

def _sizes(seq, soffs, qual, qoffs, host_soffs=None, host_qoffs=None) -> int:
    """B of the wrappers' inputs; raises ValueError on what they do not
    take. The offsets' values are checked in their host copies (by default
    the tensors themselves where they lie on the CPU): a CUDA call that
    read them back would wait for the card."""
    for name, t in (("seq", seq), ("qual", qual)):
        if t.dim() != 1 or t.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8 [n], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("soffs", soffs), ("qoffs", qoffs)):
        if t.dim() != 1 or t.numel() < 1 or t.dtype != torch.int64:
            raise ValueError(f"{name} must be int64 [B + 1], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if soffs.numel() != qoffs.numel():
        raise ValueError(f"soffs and qoffs must be [B + 1] alike, got "
                         f"{soffs.numel()} and {qoffs.numel()}")
    if len({t.device for t in (seq, soffs, qual, qoffs)}) != 1:
        raise ValueError("seq, soffs, qual and qoffs must be on one device")
    for name, t, buf, h in (("soffs", soffs, seq, host_soffs),
                            ("qoffs", qoffs, qual, host_qoffs)):
        if h is None:
            if t.device.type != "cpu":
                raise ValueError(f"{name} on {t.device} needs its copy on "
                                 f"the host")
            h = t
        o = np.asarray(h)
        if o.shape != tuple(t.shape):
            raise ValueError(f"the host copy of {name} must be {name} on the "
                             f"host, got shape {o.shape} for "
                             f"{tuple(t.shape)}")
        n = buf.numel()
        falls = int((o[1:] < o[:-1]).sum())
        if o[0] != 0 or o[-1] != n or falls:
            raise ValueError(f"{name} must rise from 0 to {n} without a "
                             f"fall, got {o[0]} .. {o[-1]} with {falls} "
                             f"falls")
    return soffs.numel() - 1


def _placed(buf: torch.Tensor, offs: torch.Tensor, two_half: bool):
    """(bytes, inside) [B, 2E]: the byte of `buf` each column takes (the
    kernel's placement rule, see csrc/encode.cu) and whether it lies inside
    the read; L from `offs`."""
    o = offs.long()
    L = (o[1:] - o[:-1])[:, None]
    c = torch.arange(W2, device=buf.device)[None, :]
    if two_half:
        src = torch.where(c < E, c, c + L - W2)
        inside = torch.where(c < E, c < L, src >= 0)
    else:
        src = c + torch.where((c >= E) & (L > W2), L - W2, 0)
        inside = c < L
    if buf.numel() == 0:
        return torch.zeros(src.shape, dtype=torch.uint8,
                           device=buf.device), inside
    pos = (o[:-1, None] + src).clamp(0, buf.numel() - 1)
    return buf[pos], inside


def _codes_qv(seq, soffs, qual, qoffs, two_half: bool):
    sb, s_in = _placed(seq, soffs, two_half)
    qb, q_in = _placed(qual, qoffs, two_half)
    table = torch.from_numpy(_ENC_PAD0).to(seq.device)
    codes = torch.where(s_in, table[sb.long()], dna.PAD)
    # (int8)(q - 33): the uint8 difference wraps, viewed as int8
    qv = torch.where(q_in & (qb >= 33), (qb - 33).view(torch.int8), 0)
    return codes, qv


def encode_two_half_plain(seq, soffs, qual, qoffs, host_soffs=None,
                          host_qoffs=None):
    """Plain version of `encode_two_half_dev` (torch ops, any device)."""
    encode_two_half_plain.launches += 1
    _sizes(seq, soffs, qual, qoffs, host_soffs, host_qoffs)
    codes, qv2 = _codes_qv(seq, soffs, qual, qoffs, True)
    o = soffs.long()
    L = (o[1:] - o[:-1])[:, None]
    c = torch.arange(W2, device=seq.device)[None, :]
    in_sum = (c < L.clamp(max=E)) | (c >= W2 - (L - E).clamp(min=0))
    qsum = torch.where(in_sum, qv2.int(), 0).sum(1, dtype=torch.int32)
    return codes, qv2, qsum


encode_two_half_plain.launches = 0


def encode_composite_plain(seq, soffs, qual, qoffs, host_soffs=None,
                           host_qoffs=None):
    """Plain version of `encode_composite_dev` (torch ops, any device)."""
    encode_composite_plain.launches += 1
    _sizes(seq, soffs, qual, qoffs, host_soffs, host_qoffs)
    return _codes_qv(seq, soffs, qual, qoffs, False)


encode_composite_plain.launches = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_outputs(seq, soffs, qual, qoffs, host_soffs, host_qoffs):
    """(B, codes, qv) of a kernel call: the checks, then the outputs."""
    B = _sizes(seq, soffs, qual, qoffs, host_soffs, host_qoffs)
    if not all(t.is_contiguous() for t in (seq, soffs, qual, qoffs)) or (
            soffs.data_ptr() % 8 or qoffs.data_ptr() % 8):
        raise ValueError("inputs must be contiguous, the offsets 8-byte "
                         "aligned")
    return B, *(torch.empty((B, W2), dtype=torch.int8, device=seq.device)
                for _ in range(2))


def encode_two_half_dev(seq, soffs, qual, qoffs, host_soffs=None,
                        host_qoffs=None):
    """A chunk's two-half rows: (codes [B, 2E] int8, qv2 [B, 2E] int8,
    qsum [B] int32) as ops/edgescan.encode_two_half computes them from the
    reads' bytes (see csrc/encode.cu). seq / qual uint8, soffs / qoffs
    int64 [B + 1] (`EncodeInputs`: `chunk_inputs` or `Staged.upload` give
    all six). CPU tensors take the plain version; CUDA tensors launch
    csrc/encode.cu, with no wait for the card."""
    if seq.device.type == "cpu":
        return encode_two_half_plain(seq, soffs, qual, qoffs, host_soffs,
                                     host_qoffs)
    B, codes, qv2 = _kernel_outputs(seq, soffs, qual, qoffs, host_soffs,
                                    host_qoffs)
    qsum = torch.empty(B, dtype=torch.int32, device=seq.device)
    if B:
        fn = _build.bind("encode", "encode_two_half_launch", 7, 1)
        _build.launch(fn, "encode_two_half", seq.device, seq.data_ptr(),
                      soffs.data_ptr(), qual.data_ptr(), qoffs.data_ptr(),
                      codes.data_ptr(), qv2.data_ptr(), qsum.data_ptr(), B)
        encode_two_half_dev.launches += 1
    return codes, qv2, qsum


encode_two_half_dev.launches = 0


def encode_composite_dev(seq, soffs, qual, qoffs, host_soffs=None,
                         host_qoffs=None):
    """A chunk's v1 composite rows: (codes [B, 2E] int8, qv [B, 2E] int8)
    as models/readscan.encode_composite computes them (the same inputs as
    `encode_two_half_dev`). CPU tensors take the plain version; CUDA
    tensors launch csrc/encode.cu."""
    if seq.device.type == "cpu":
        return encode_composite_plain(seq, soffs, qual, qoffs, host_soffs,
                                      host_qoffs)
    B, codes, qv = _kernel_outputs(seq, soffs, qual, qoffs, host_soffs,
                                   host_qoffs)
    if B:
        fn = _build.bind("encode", "encode_composite_launch", 6, 1)
        _build.launch(fn, "encode_composite", seq.device, seq.data_ptr(),
                      soffs.data_ptr(), qual.data_ptr(), qoffs.data_ptr(),
                      codes.data_ptr(), qv.data_ptr(), B)
        encode_composite_dev.launches += 1
    return codes, qv


encode_composite_dev.launches = 0


def grid_warps(device) -> int:
    """The warps of a full csrc/encode.cu grid on CUDA `device` (its SMs x
    blocks an SM x warps a block): a launch of more reads gives a warp
    several, so tests launch around it."""
    dev = torch.device(device)
    fn = _build.load("encode").encode_grid_warps
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        n = fn()
    _build.check(max(-n, 0), "encode_grid_warps")
    return n
