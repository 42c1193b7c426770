"""Tiled chimera scan: CUDA kernel wrappers (csrc/tilescan.cu, and the fused
short-read tile feed csrc/tilefeed.cu) and their plain PyTorch versions.

Replaces the Pallas kernel `sicelore_tpu/ops/tilescan_tpu.py::_tile_kernel`.
Both take the nibble tile rows of `models.readscan.build_tiles`
([T, TILE/2 + 16] uint8: two 4-bit codes a byte, then own_lo u16, own_hi u16,
tlen u16, pad, g0 u32, rlen u32) and return [3, T] int32: the number of
distinct confirmed split positions and the first two (tile-local; -1 when
absent). The plain version is a torch port of
`sicelore_tpu/models/readscan.py::_make_internal_tile_inner`.

The tile feed builds those rows on the device from `encode_two_half`'s codes
for the reads that lie whole in them (the route of
`sicelore_tpu/ops/tilescan_tpu.py::make_composite_tile_fn`), so the cached
pass 1 scans their interiors from the upload it has already made: only
those reads' rows, gathered by an index the host builds from the lengths.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import PipelineConfig
from sicelore_tpu_torch.ops import _build, editdist, scan
from sicelore_tpu_torch.ops.edgescan import E

TILE = 1024
TILE_META = 16
ROW_BYTES = TILE // 2 + TILE_META
K_TILE_SITES = 3    # captured run starts per direction per tile
WI_CONFIRM = 160    # confirm window length (polyA run + UMI + BC + adapter)
BIG = 10**9


@dataclass(frozen=True, eq=False)
class TileParams:
    k: int
    mc: int
    m_adc: int
    edmax: int
    peq_adc: np.ndarray   # uint32 [4, 1]
    edge: int             # polyA search window kept off both read ends


def tile_params(cfg: PipelineConfig) -> TileParams:
    p = cfg.polyat
    k = p.internal_pat_length
    a = cfg.adapter3p
    return TileParams(
        k=k, mc=scan.min_count_for(k, p.internal_fraction_at_in_polyat),
        m_adc=len(a.sequence_complete),
        edmax=a.max_complete_seq_needleman_mismatches,
        peq_adc=editdist.build_peq(dna.encode(a.sequence_complete)[None, :]),
        edge=p.window_search_for_polya)


def feed_covered(lens, p: TileParams):
    """The reads whose tile the feed builds: min_len < L <= 2E, min_len =
    2 edge + k (their interior lies whole in the two-half codes). Works on
    numpy arrays and tensors alike."""
    return (lens > 2 * p.edge + p.k) & (lens <= 2 * E)


def _unpack(rows: torch.Tensor):
    nib = rows[:, :TILE // 2]
    codes = torch.stack([nib >> 4, nib & 0xF], dim=-1).reshape(
        rows.shape[0], TILE).to(torch.int8)
    mb = rows[:, TILE // 2:].to(torch.int64)
    own_lo = mb[:, 0] | (mb[:, 1] << 8)
    own_hi = mb[:, 2] | (mb[:, 3] << 8)
    tlen = mb[:, 4] | (mb[:, 5] << 8)
    g0 = mb[:, 8] | (mb[:, 9] << 8) | (mb[:, 10] << 16) | (mb[:, 11] << 24)
    rlen = (mb[:, 12] | (mb[:, 13] << 8) | (mb[:, 14] << 16)
            | (mb[:, 15] << 24))
    return codes, own_lo, own_hi, tlen, g0, rlen


def tile_sites_plain(rows: torch.Tensor, p: TileParams):
    """The detection of the plain tile scan: the first K_TILE_SITES starts
    of maximal passing stretches inside each tile's ownership span, per
    direction. rows [T, TILE/2 + 16] uint8 -> (sA, sT) [T, K] int64, -1
    where a tile has fewer. The confirms the scan runs are the sites >= 0."""
    k = p.k
    codes, own_lo, own_hi, tlen, _, _ = _unpack(rows)
    pos = torch.arange(TILE - k + 1, device=rows.device)[None, :]
    site_lists = []
    for base in (dna.A, dna.T):
        counts = scan._rolling_count((codes == base).to(torch.int32), k)
        ok = ((counts >= p.mc) & (pos >= own_lo[:, None])
              & (pos < own_hi[:, None]) & (pos <= tlen[:, None] - k))
        rs = ok & ~F.pad(ok[:, :-1], (1, 0))
        ss = []
        for _ in range(K_TILE_SITES):
            j = torch.where(rs, pos, BIG).min(dim=1).values
            ss.append(torch.where(j < BIG, j, -1))
            rs = rs & (pos > j[:, None])
        site_lists.append(torch.stack(ss, dim=1))        # [T, K]
    return site_lists[0], site_lists[1]


def tile_scan_plain(rows: torch.Tensor, p: TileParams) -> torch.Tensor:
    """Plain PyTorch tile scan: rows [T, TILE/2 + 16] uint8 -> [3, T] int32."""
    tile_scan_plain.launches += 1
    S = rows.shape[0]
    dev = rows.device
    K, Wi = K_TILE_SITES, WI_CONFIRM
    codes, _, _, tlen, g0, rlen = _unpack(rows)
    sA, sT = tile_sites_plain(rows, p)
    # one stacked confirm over the 2K windows of each tile: the windows of
    # gather_window(codes, tlen, start, Wi), A-sites reverse-complemented
    src = torch.arange(S, device=dev).repeat_interleave(K).repeat(2)
    starts = torch.cat([sA.reshape(-1), sT.reshape(-1) - Wi])
    idx = starts[:, None] + torch.arange(Wi, device=dev)[None, :]
    valid = (idx >= 0) & (idx < tlen[src][:, None])
    wins = codes[src[:, None], idx.clamp(0, TILE - 1)]
    wins = torch.where(valid, wins, dna.PAD)
    comp = torch.as_tensor(dna._COMP, device=dev)
    wins = torch.cat([comp[wins[:S * K].long()].flip(1), wins[S * K:]])
    ed6, pos6 = scan.adapter_search_plain(wins, p.peq_adc,
                                          p.m_adc)
    a_ed, t_ed = ed6[:S * K].reshape(S, K), ed6[S * K:].reshape(S, K)
    a_pos, t_pos = pos6[:S * K].reshape(S, K), pos6[S * K:].reshape(S, K)
    a_split = sA + Wi - 1 - a_pos + p.m_adc
    t_split = sT - Wi + t_pos - (p.m_adc - 1)
    spl = torch.cat([a_split, t_split], dim=1)                 # [S, 2K]
    okc = torch.cat([(sA >= 0) & (a_ed <= p.edmax),
                     (sT >= 0) & (t_ed <= p.edmax)], dim=1)
    gpos = g0[:, None] + spl
    okc = okc & (gpos > 50) & (gpos < rlen[:, None] - 50)
    n = torch.zeros(S, dtype=torch.int64, device=dev)
    s0 = torch.full((S,), -1, dtype=torch.int64, device=dev)
    s1 = s0.clone()
    taken = []
    for i2 in range(2 * K):
        dup = torch.zeros(S, dtype=torch.bool, device=dev)
        for j2, tk in taken:
            dup = dup | (tk & (spl[:, j2] == spl[:, i2]))
        take = okc[:, i2] & ~dup
        s0 = torch.where(take & (n == 0), spl[:, i2], s0)
        s1 = torch.where(take & (n == 1), spl[:, i2], s1)
        n = n + take.to(torch.int64)
        taken.append((i2, take))
    return torch.stack([n, s0, s1], dim=0).to(torch.int32)


tile_scan_plain.launches = 0


@functools.lru_cache(maxsize=16)
def kernel_params(p: TileParams) -> np.ndarray:
    """The int32 parameter array matching csrc/tilescan.cu::TileParams,
    built once a parameter set (TileParams is frozen, hashed by identity)."""
    return np.ascontiguousarray(np.concatenate([
        np.asarray([p.k, p.mc, p.m_adc, p.edmax, WI_CONFIRM], np.int32),
        p.peq_adc[:, 0].view(np.int32)]))


def tile_scan(rows: torch.Tensor, p: TileParams) -> torch.Tensor:
    """Chimera scan of nibble tile rows [T, TILE/2 + 16] uint8 -> [3, T]
    int32 (n, split0, split1). CPU tensors take the plain version; CUDA
    tensors launch csrc/tilescan.cu on the rows as they are (contiguous,
    16-byte aligned: the kernel stages them with 16-byte loads)."""
    if rows.dim() != 2 or rows.shape[1] != ROW_BYTES:
        raise ValueError(f"rows must be [T, {ROW_BYTES}], "
                         f"got {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return tile_scan_plain(rows, p)
    if rows.dtype != torch.uint8 or not rows.is_contiguous():
        raise ValueError("rows must be contiguous uint8")
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary")
    if not (1 <= p.k <= 31 and 1 <= p.m_adc <= 31):
        raise NotImplementedError(
            f"tile kernel takes k <= 31 and an adapter <= 31 bases "
            f"(k={p.k}, m={p.m_adc})")
    T = rows.shape[0]
    out = torch.empty((3, T), dtype=torch.int32, device=rows.device)
    if T == 0:
        return out
    prm = kernel_params(p)
    fn = _build.bind("tilescan", "tilescan_launch", 3, 2)
    _build.launch(fn, "tilescan", rows.device, rows.data_ptr(),
                  out.data_ptr(), prm.ctypes.data, T, prm.size)
    tile_scan.launches += 1
    return out


tile_scan.launches = 0


def _pack_rows(codes: torch.Tensor, meta) -> torch.Tensor:
    """Tile codes [T, TILE] (0..5) and meta columns (own_lo, own_hi, tlen,
    g0, rlen; each [T] int64) -> build_tiles rows [T, ROW_BYTES] uint8."""
    c = codes.to(torch.uint8)
    own_lo, own_hi, tlen, g0, rlen = meta
    cols = [own_lo, own_lo >> 8, own_hi, own_hi >> 8, tlen, tlen >> 8,
            torch.zeros_like(tlen), torch.zeros_like(tlen)]
    cols += [v >> s for v in (g0, rlen) for s in (0, 8, 16, 24)]
    mb = (torch.stack(cols, dim=1) & 0xFF).to(torch.uint8)
    return torch.cat([(c[:, 0::2] << 4) | c[:, 1::2], mb], dim=1)


def tile_feed_plain(codes: torch.Tensor, lens: torch.Tensor,
                    idx: torch.Tensor, p: TileParams) -> torch.Tensor:
    """Plain PyTorch tile feed: encode_two_half's codes [B, 2E] int8, lens
    [B] and idx [C] (the reads to feed, each in [0, B): the caller's
    `feed_covered` reads) -> [C, ROW_BYTES] uint8, row i for read idx[i].
    A covered read (`feed_covered`) gets the one row build_tiles writes for
    it (g0 = 0, the tail shifted by 2E - L into place, PAD from L on, a PAD
    code inside the read as N, as build_tiles encodes a NUL byte); any other
    read an inert row (PAD codes, zero meta), which the scan reports as
    n = 0."""
    tile_feed_plain.launches += 1
    dev = codes.device
    ix = idx.to(device=dev, dtype=torch.int64)
    L = lens.to(device=dev, dtype=torch.int64)[ix]
    cov = feed_covered(L, p)
    j = torch.arange(TILE, device=dev)[None, :]
    src = torch.where(j < E, j, j + 2 * E - L[:, None]).clamp(0, 2 * E - 1)
    c = codes[ix].gather(1, src)
    c = torch.where(c == dna.PAD, dna.N_CODE, c)
    c = torch.where((j < L[:, None]) & cov[:, None], c, dna.PAD)
    zero = torch.zeros_like(L)
    lc = torch.where(cov, L, zero)
    return _pack_rows(c, (
        torch.where(cov, p.edge, zero),
        torch.where(cov, (L - p.edge - p.k + 1).clamp(min=0), zero),
        lc, zero, lc))


tile_feed_plain.launches = 0


def tile_feed(codes: torch.Tensor, lens: torch.Tensor, idx: torch.Tensor,
              p: TileParams) -> torch.Tensor:
    """Tile rows [C, ROW_BYTES] uint8 of the reads idx [C] int32 of
    encode_two_half's codes [B, 2E] int8 and lens [B] int32 (see
    tile_feed_plain). CPU tensors take the plain version; CUDA tensors
    launch csrc/tilefeed.cu on the codes as they are (contiguous, 16-byte
    aligned: the kernel copies them in 16-byte pieces). C = 0 launches
    nothing."""
    if codes.dim() != 2 or codes.shape[1] != 2 * E:
        raise ValueError(f"codes must be [B, 2E={2 * E}], "
                         f"got {tuple(codes.shape)}")
    B = codes.shape[0]
    if idx.dim() != 1:
        raise ValueError(f"idx must be [C], got {tuple(idx.shape)}")
    if codes.device.type == "cpu":
        return tile_feed_plain(codes, lens, idx, p)
    if codes.dtype != torch.int8 or not codes.is_contiguous():
        raise ValueError("codes must be contiguous int8")
    if codes.data_ptr() % 16:
        raise ValueError("codes must start on a 16-byte boundary")
    for name, t, n in (("lens", lens, B), ("idx", idx, idx.shape[0])):
        if (t.dtype != torch.int32 or t.shape != (n,)
                or t.device != codes.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{n}] on "
                             f"codes' device")
    C = idx.shape[0]
    out = torch.empty((C, ROW_BYTES), dtype=torch.uint8, device=codes.device)
    if C == 0:
        return out
    fn = _build.bind("tilefeed", "tilefeed_launch", 4, 4)
    _build.launch(fn, "tilefeed", codes.device, codes.data_ptr(),
                  lens.data_ptr(), idx.data_ptr(), out.data_ptr(), B, C,
                  p.edge, p.k)
    tile_feed.launches += 1
    return out


tile_feed.launches = 0
