"""Read-scan model: the scan passes of `scanfastq` on a device.

Port of `sicelore_tpu/models/readscan.py::ReadScanModel`: the v2 two-half
passes that `ScanFastqPipeline.run` drives, and the v1 composite edge scan
(`scan_reads`) and bucketed chimera scan (`scan_internal`) behind
the synchronous pass 2. Every read ships as N-safe int8 codes, so the device
result is final for every read: no read or tile re-runs on a second, exact
path. v2 device outputs are int32 rows named by the `*_ROW_NAMES` tuples and
finalized on the host (`finalize_rows_np`) into the same dicts the JAX model
returns.

Kernels (CUDA for CUDA tensors, plain torch for CPU tensors):
  * read encoding   ops.encode_cuda.encode_two_half_dev (every v2 pass: a
                    chunk's raw bytes to the [B, 2E] rows the scans read,
                    qv2 and qsum), encode_composite_dev (scan_reads);
                    csrc/encode.cu: bulk copies of each read's spans into
                    a shared-memory ring, mapped four bytes an operation
  * edge scan       ops.edgescan_cuda.edge_scan2   (pass 1, split rescans,
                                                    streaming pass 2; 3p
                                                    and 5p)
  * window search   ops.editdist.myers_win1        (the composed edge scan of
                    configs outside the edge kernel's envelope, the v1
                    composite scan, scan_internal)
  * whitelist sweep ops.bcsearch.bc_sweep          (pass 2)
  * chimera scan    ops.tilescan_cuda.tile_scan    (pass 2; and pass 1 of
                                                    the cached pipeline on
                                                    the fused route)
  * tile feed       ops.tilescan_cuda.tile_feed    (the fused route: the
                    tile rows of the reads with min_len < L <= 2E, and of
                    no other, built from pass 1's uploaded codes)

The JAX model's `_pack_batch` (nibble packing, power-of-two batch buckets)
and `_pack_meta` (int16 meta rows) have no counterpart: they shape the
TPU's uploads and downloads, not the scan's results.

`*_async` methods launch on the device's current stream and start the
device->host copy; the matching `finish_*` waits for it, so the pipeline
overlaps one chunk's host work with the next chunk's device work.

With a mesh (a list of devices, `parallel.shard`) the five methods that the
JAX model shards (`scan_pass1_async`, `scan_pass1_full_async`,
`scan_search_async`, `bc_sweep_async`, `internal_tiles_async`) cut a
chunk's rows (reads, BC windows or tiles) into one contiguous span a
shard, run the same body on each shard's device and join the rows in read
order on the host; the tiles keep their global read index and offset. The
counterpart of the JAX model's `make_sharded2` and
`make_internal_tile_sharded_fn`; without a mesh there is one shard.
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import PipelineConfig
from sicelore_tpu_torch.device import resolve
from sicelore_tpu_torch.ops import bcsearch, editdist, scan
from sicelore_tpu_torch.ops import edgescan as eg2
from sicelore_tpu_torch.ops import encode_cuda as enc
from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
from sicelore_tpu_torch.ops.tilescan_cuda import (ROW_BYTES, TILE,
                                                  feed_covered, tile_feed,
                                                  tile_params, tile_scan)
from sicelore_tpu_torch.parallel import shard

I16_BIG = 32000   # sweep EDs at or above it report not-found (bcsearch.BIG)
BIG = 10**9
EDGE = eg2.E      # bases kept from each read end in the v1 composite
WI_INTERNAL = 160  # scan_internal confirm window: polyA tail+UMI+BC+adapter
K_INTERNAL = 4     # internal polyA/T sites kept per read and direction

TILE_CTX = 192      # ownership context: >= confirm window (160) + run slack
TILE_STRIDE = TILE - 2 * TILE_CTX


def gather_window(seqs: torch.Tensor, lens: torch.Tensor,
                  starts: torch.Tensor, W: int,
                  rc: bool = False) -> torch.Tensor:
    """Per-row windows seqs[b, starts[b] : starts[b]+W].

    Out-of-read positions (idx < 0 or >= lens[b]) become PAD. With rc=True
    the window is reverse-complemented (in code space) after extraction."""
    B, L = seqs.shape
    idx = starts.long()[:, None] + torch.arange(W, device=seqs.device)[None, :]
    valid = (idx >= 0) & (idx < lens.long()[:, None])
    w = seqs.gather(1, idx.clamp(0, L - 1))
    w = torch.where(valid, w, dna.PAD)
    if rc:
        comp = torch.as_tensor(dna._COMP, device=seqs.device)
        w = comp[w.long()].flip(1)
    return w


# ---------------------------------------------------------------------------
# v1: composite edge scan and bucketed internal scan (synchronous pass 2)
# ---------------------------------------------------------------------------

EDGE_META_KEYS = (
    "is_fwd", "stranded", "has_polyat", "ps", "pe", "ae", "adapter_ed",
    "adapter_complete_ed", "adapter_run", "tso_end", "tso_ed",
    "x_start", "x_end")
_BOOL_KEYS = {"is_fwd", "stranded", "has_polyat"}


def make_edge_scan_fn(cfg: PipelineConfig):
    """The v1 edge scan over fixed [B, 2*EDGE] composites.

    Returns scan_fn(seqs [B, L] int8, lens [B] int32 composite lengths) ->
    dict of tensors in composite stranded coordinates (the host remaps them,
    `remap_composite`; QVs are host-side). The three adapter searches go
    through `scan.adapter_search`: the window-search kernel on the card."""
    p = eg2.edge_params(cfg)
    nbases = cfg.readscanner.nbases_of_adapter_seq_in_readname
    x_len = 40 + nbases  # X= spans [AE-40, AE+nbases-1]
    awin, twin = p.awin, p.twin

    def scan_fn(seqs: torch.Tensor, lens: torch.Tensor) -> dict:
        B = seqs.shape[0]
        lens = lens.to(torch.int32)
        zeros = torch.zeros_like(lens)
        fwd_found, fwd_ps, fwd_pe = scan.polyat_find(
            seqs, lens, base=dna.A, k=p.k, min_count=p.mc, window=p.win_p,
            from_end=True)
        rev_found, rev_ts, rev_te = scan.polyat_find(
            seqs, lens, base=dna.T, k=p.k, min_count=p.mc, window=p.win_p,
            from_end=False)

        # adapter search, unified sense-orientation window
        if p.is5p:
            w_fwd = gather_window(seqs, lens, zeros, awin)
            w_rev = gather_window(seqs, lens, lens - awin, awin, rc=True)
        else:
            w_fwd = gather_window(seqs, lens, fwd_pe + 1, awin, rc=True)
            w_rev = gather_window(seqs, lens, rev_ts - awin, awin)
        ed2, pos2 = scan.adapter_search(torch.cat([w_fwd, w_rev], dim=0),
                                        p.peq_ad, p.m_ad)
        ed_f = torch.where(fwd_found, ed2[:B], BIG)
        ed_r = torch.where(rev_found, ed2[B:], BIG)
        pos_f, pos_r = pos2[:B], pos2[B:]

        ok_f = fwd_found & (ed_f <= p.mm_ad)
        ok_r = rev_found & (ed_r <= p.mm_ad)
        stranded = ok_f | ok_r
        is_fwd = torch.where(stranded, ok_f & (~ok_r | (ed_f <= ed_r)),
                             fwd_found)

        has_pat = torch.where(is_fwd, fwd_found, rev_found)
        ps = torch.where(is_fwd, fwd_ps, lens - 1 - rev_te)
        pe = torch.where(is_fwd, fwd_pe, lens - 1 - rev_ts)
        ps = torch.where(has_pat, ps, -1)
        pe = torch.where(has_pat, pe, -1)
        if p.is5p:
            ae = torch.where(is_fwd, pos_f, pos_r)
        else:
            ae = torch.where(is_fwd, fwd_pe + awin - pos_f,
                             lens - 1 - (rev_ts - awin + pos_r))
        ad_ed = torch.where(is_fwd, ed_f, ed_r)
        ad_pos_local = torch.where(is_fwd, pos_f, pos_r)
        ae = torch.where(stranded, ae, -1)

        w_used = torch.where(is_fwd[:, None], w_fwd, w_rev)
        edc, _ = scan.adapter_search(w_used, p.peq_adc, p.m_adc)
        ad_runs, _ = scan.match_run_stats(w_used, p.adc_codes, p.m_adc)
        bc_windows = gather_window(w_used, torch.full_like(lens, awin),
                                   ad_pos_local + 1 - p.pad, p.bw)

        # TSO: 3p at the stranded 5' start; 5p after adapter + BC
        t0 = (ae + 1 + p.bc_len) if p.is5p else zeros
        w5_f = gather_window(seqs, lens, t0, twin)
        w5_r = gather_window(seqs, lens, lens - twin - t0, twin, rc=True)
        w5 = torch.where(is_fwd[:, None], w5_f, w5_r)
        tso_ed, tso_pos = scan.adapter_search(w5, p.peq_tso, p.m_tso)
        bail = scan.run_bailout(w5, p.tso_codes, p.m_tso, p.c1, p.c2)
        tso_found = (tso_ed <= p.mm_tso) | bail
        tso_end = torch.where(tso_found, t0 + tso_pos + (p.off_tso - 1), -1)

        if p.is5p:
            xs_str, xe_str = ae - nbases + 1, ae + (x_len - nbases)
        else:
            xs_str, xe_str = ae - (x_len - nbases), ae + nbases - 1
        return {
            "is_fwd": is_fwd, "stranded": stranded, "has_polyat": has_pat,
            "ps": ps, "pe": pe, "ae": ae,
            "adapter_ed": torch.where(stranded, ad_ed, BIG),
            "adapter_complete_ed": edc, "adapter_run": ad_runs,
            "bc_windows": bc_windows,
            "tso_end": tso_end, "tso_ed": tso_ed,
            "x_start": xs_str, "x_end": xe_str,
        }

    return scan_fn


def unpack_edge_meta(meta: np.ndarray) -> dict:
    """[len(EDGE_META_KEYS), B] int32 rows of the v1 edge scan -> dict
    (flags as bool, everything else int32)."""
    out = {}
    for r, k in enumerate(EDGE_META_KEYS):
        v = meta[r].astype(np.int32)
        out[k] = v.astype(bool) if k in _BOOL_KEYS else v
    return out


def compute_qvs_np(qv: np.ndarray, lens: np.ndarray, out: dict,
                   bc_len: int, is5p: bool = False) -> None:
    """Host-side QV means over a [B, L] qual matrix (read / X region / BC
    region); adds read_qv, x_qv and bc_qv to `out`."""
    B, L = qv.shape
    lens = np.asarray(lens).astype(np.int64)
    qsum = qv.sum(axis=1, dtype=np.int32)
    out["read_qv"] = (qsum / np.maximum(lens, 1)).astype(np.float32)
    is_fwd = out["is_fwd"]
    ae = out["ae"]
    rows = np.arange(B)[:, None]

    def window_mean(s_str, e_str):
        s = np.where(is_fwd, s_str, lens - 1 - e_str)
        e = np.where(is_fwd, e_str, lens - 1 - s_str)
        s = np.clip(s, 0, L)
        e1 = np.minimum(np.clip(e + 1, 0, L), lens)
        n = np.maximum(e1 - s, 1)
        Wm = max(int(np.max(n, initial=1)), 1)
        cols = s[:, None] + np.arange(Wm, dtype=np.int64)
        m = cols < e1[:, None]
        w = qv[rows, np.minimum(cols, L - 1)].astype(np.int32)
        return ((w * m).sum(axis=1) / n).astype(np.float32)

    if "x_start" in out:
        out["x_qv"] = window_mean(out["x_start"], out["x_end"])
    if is5p:  # BC right AFTER the adapter end in 5' chemistry
        out["bc_qv"] = window_mean(ae + 1, ae + bc_len)
    else:
        out["bc_qv"] = window_mean(ae - bc_len, ae - 1)


_ENC_PAD0 = dna._ENC.copy()
_ENC_PAD0[0] = dna.PAD  # NUL byte = padding in the bulk-encode fast path


def encode_composite(seqs: list[bytes], quals: list[bytes]):
    """Encode reads into fixed [B, 2*EDGE] composites (head + tail splice).

    Reads longer than 2*EDGE keep their first and last EDGE bases; all
    stranding evidence lives there. Returns (codes, qv, comp_lens,
    true_lens)."""
    edge = EDGE
    B, W = len(seqs), 2 * edge
    true_lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    comp_lens = np.minimum(true_lens, W)
    z = b"\x00"
    sbuf = b"".join(
        s[:edge].ljust(edge, z)
        + (s[edge:W] if len(s) <= W else s[-edge:]).ljust(edge, z)
        for s in seqs)
    codes = _ENC_PAD0[np.frombuffer(sbuf, np.uint8)].reshape(B, W)
    qbuf = b"".join(
        q[:edge].ljust(edge, z)
        + (q[edge:W] if len(q) <= W else q[-edge:]).ljust(edge, z)
        for q in quals)
    qarr = np.frombuffer(qbuf, np.uint8).reshape(B, W)
    qv = np.where(qarr >= 33, qarr.astype(np.int16) - 33, 0).astype(np.int8)
    return codes, qv, comp_lens, true_lens


def remap_composite(pos: np.ndarray, true_lens: np.ndarray) -> np.ndarray:
    """Map composite stranded coords back to true read coords: for reads
    longer than 2*EDGE, composite positions >= EDGE belong to the read tail
    (true = pos + true_len - 2*EDGE). Negative positions pass through."""
    shift = np.maximum(true_lens - 2 * EDGE, 0)
    out = np.where((pos >= EDGE), pos + shift, pos)
    return np.where(pos < 0, pos, out)


def internal_sites(seqs: torch.Tensor, lens: torch.Tensor, *, base: int,
                   k: int, min_count: int, edge: int):
    """Up to K_INTERNAL disjoint internal polyA/T runs (chimera candidates).

    Returns (count [B] int32, starts [B, K_INTERNAL] int32 window-start
    positions, -1 padded)."""
    max_sites = K_INTERNAL
    B, L = seqs.shape
    dev = seqs.device
    if L < k:
        return (torch.zeros(B, dtype=torch.int32, device=dev),
                torch.full((B, max_sites), -1, dtype=torch.int32, device=dev))
    lens = lens.long()
    counts = scan._rolling_count((seqs == base).to(torch.int32), k)
    pos = torch.arange(L - k + 1, device=dev)[None, :]
    inread = pos <= (lens[:, None] - k)
    internal = (pos >= edge) & ((pos + k - 1) < (lens[:, None] - edge))
    ok = (counts >= min_count) & inread & internal
    starts = []
    for _ in range(max_sites):
        j = torch.where(ok, pos, BIG).min(dim=1).values  # first passing window
        starts.append(torch.where(j < BIG, j, -1))
        # mask the contiguous run starting at j (conservatively [j, j + 2k))
        ok = ok & ~((pos >= j[:, None]) & (pos < (j[:, None] + 2 * k)))
    st = torch.stack(starts, dim=1).to(torch.int32)
    return (st >= 0).sum(dim=1).to(torch.int32), st


def make_internal_scan_fn(cfg: PipelineConfig):
    """The bucketed full-length internal/chimera scan.

    Returns fn(seqs [B, L] int8, lens [B]) -> int32 [2 + 6*K_INTERNAL, B]
    (see `unpack_internal_meta`): per-site confirmation EDs and split
    positions (part 2 starts at split). The two [B*K_INTERNAL, 160] confirm
    searches go through `scan.adapter_search`."""
    pa = cfg.polyat
    adc = dna.encode(cfg.adapter3p.sequence_complete)
    m_adc = len(adc)
    peq_adc = editdist.build_peq(adc[None, :])
    k = pa.internal_pat_length
    mc = scan.min_count_for(k, pa.internal_fraction_at_in_polyat)
    edge = pa.window_search_for_polya
    Wi, K = WI_INTERNAL, K_INTERNAL

    def fn(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        B = seqs.shape[0]
        lens = lens.to(torch.int32)
        nA, sA = internal_sites(seqs, lens, base=dna.A, k=k, min_count=mc,
                                edge=edge)
        nT, sT = internal_sites(seqs, lens, base=dna.T, k=k, min_count=mc,
                                edge=edge)
        rs = seqs.repeat_interleave(K, dim=0)
        rl = lens.repeat_interleave(K)
        sAf, sTf = sA.reshape(-1), sT.reshape(-1)
        # A-junction: ...cDNA1 polyA rcUMI rcBC rcAdapterC | cDNA2...: the
        # complete adapter (sense) in the rc window after the run start
        a_ed, a_pos = scan.adapter_search(
            gather_window(rs, rl, sAf, Wi, rc=True), peq_adc, m_adc)
        a_ed = torch.where(sAf >= 0, a_ed, BIG).reshape(B, K)
        a_split = (sAf + Wi - 1 - a_pos + (m_adc - 1) + 1).reshape(B, K)
        # T-junction: ...rc(cDNA1) | adapterC BC UMI polyT cDNA2...: the
        # complete adapter (sense) right before the polyT run
        t_ed, t_pos = scan.adapter_search(
            gather_window(rs, rl, sTf - Wi, Wi), peq_adc, m_adc)
        t_ed = torch.where(sTf >= 0, t_ed, BIG).reshape(B, K)
        t_split = (sTf - Wi + t_pos - (m_adc - 1)).reshape(B, K)
        return torch.cat([
            nA[None, :], sA.t(), a_ed.t(), a_split.t(),
            nT[None, :], sT.t(), t_ed.t(), t_split.t()], dim=0
        ).to(torch.int32)

    return fn


def unpack_internal_meta(meta: np.ndarray) -> dict:
    """[2 + 6*K_INTERNAL, B] int32 rows of the internal scan -> dict of
    [B] counts and [B, K_INTERNAL] starts, confirm EDs and splits."""
    K = K_INTERNAL
    rows = {}
    off = 0
    for name, n in (("n_internal_a", 1), ("internal_a", K),
                    ("internal_a_ed", K), ("internal_a_split", K),
                    ("n_internal_t", 1), ("internal_t", K),
                    ("internal_t_ed", K), ("internal_t_split", K)):
        v = meta[off:off + n]
        rows[name] = v[0] if n == 1 else v.T
        off += n
    return rows


# ---------------------------------------------------------------------------
# Tiled internal/chimera scan: host tiling (numpy)
# ---------------------------------------------------------------------------

def pack_nibbles_np(codes: np.ndarray) -> np.ndarray:
    """[B, 2E] int8 codes (0..5) -> [B, E] uint8, two 4-bit codes per byte."""
    c = codes.astype(np.uint8)
    return (c[:, 0::2] << 4) | c[:, 1::2]


def build_tiles(seqs: list[bytes], cfg: PipelineConfig):
    """Cut long-read interiors into TILE-base tiles.

    Returns (rows [T, TILE/2 + TILE_META] uint8 — nibble codes plus meta
    (own_lo u16, own_hi u16, tlen u16, pad, g0 u32, rlen u32) — read_idx
    [T] int32, g0s [T] int32); T == 0 when no read qualifies."""
    from sicelore_tpu_torch.io import native as _native

    p = cfg.polyat
    edge = p.window_search_for_polya
    k = p.internal_pat_length
    ext = _native.get_hostenc()
    if ext is not None and hasattr(ext, "encode_tiles"):
        rows_b, ri_b, g0_b = ext.encode_tiles(seqs, edge, k, TILE, TILE_CTX)
        rows = np.frombuffer(rows_b, np.uint8).reshape(-1, ROW_BYTES)
        return (rows, np.frombuffer(ri_b, np.int32),
                np.frombuffer(g0_b, np.int32))
    min_len = 2 * edge + k
    tiles: list[bytes] = []
    read_idx: list[int] = []
    meta: list[tuple] = []
    for i, sq in enumerate(seqs):
        L = len(sq)
        if L <= min_len:
            continue
        lo_g, hi_g = edge, L - edge - k + 1
        if hi_g <= lo_g:
            continue
        t = 0
        while True:
            own_start = 0 if t == 0 else t * TILE_STRIDE + TILE_CTX
            if own_start >= hi_g:
                break
            g0 = t * TILE_STRIDE
            own_end = TILE_CTX + (t + 1) * TILE_STRIDE
            ol, oh = max(own_start, lo_g), min(own_end, hi_g)
            if ol < oh:
                tiles.append(sq[g0:g0 + TILE])
                read_idx.append(i)
                meta.append((ol - g0, oh - g0, min(TILE, L - g0), g0, L))
            t += 1
    T = len(tiles)
    if T == 0:
        return (np.zeros((0, ROW_BYTES), np.uint8),
                np.zeros(0, np.int32), np.zeros(0, np.int32))
    codes, _ = dna.encode_batch(tiles, TILE)
    rows = np.zeros((T, ROW_BYTES), np.uint8)
    rows[:, :TILE // 2] = pack_nibbles_np(codes)
    ma = np.asarray(meta, np.int64)
    mv = rows[:, TILE // 2:]
    mv[:, 0] = ma[:, 0] & 0xFF
    mv[:, 1] = ma[:, 0] >> 8
    mv[:, 2] = ma[:, 1] & 0xFF
    mv[:, 3] = ma[:, 1] >> 8
    mv[:, 4] = ma[:, 2] & 0xFF
    mv[:, 5] = ma[:, 2] >> 8
    mv[:, 8:12] = (ma[:, 3].astype("<u4").view(np.uint8).reshape(-1, 4))
    mv[:, 12:16] = (ma[:, 4].astype("<u4").view(np.uint8).reshape(-1, 4))
    return rows, np.asarray(read_idx, np.int32), ma[:, 3].astype(np.int32)


# ---------------------------------------------------------------------------
# Row layouts + host finalization
# ---------------------------------------------------------------------------

P1_ROWS = (("is_fwd", eg2.ROW_IS_FWD), ("stranded", eg2.ROW_STRANDED),
           ("has_polyat", eg2.ROW_HAS_POLYAT),
           ("kmer_valid", eg2.ROW_KMER_VALID),
           ("adapter_run", eg2.ROW_AD_RUN), ("ae", eg2.ROW_AE),
           ("kmer_lo", eg2.ROW_KMER_LO), ("kmer_hi", eg2.ROW_KMER_HI))
P1F_ROWS = P1_ROWS + (("ps", eg2.ROW_PS), ("pe", eg2.ROW_PE),
                      ("tso_end", eg2.ROW_TSO_END))
P2_META_ROWS = (("is_fwd", eg2.ROW_IS_FWD), ("stranded", eg2.ROW_STRANDED),
                ("has_polyat", eg2.ROW_HAS_POLYAT), ("ps", eg2.ROW_PS),
                ("pe", eg2.ROW_PE), ("ae", eg2.ROW_AE),
                ("tso_end", eg2.ROW_TSO_END))
SEARCH_ROW_NAMES = ("best_ed", "best_idx", "second_ed", "overflow")
P1_ROW_NAMES = tuple(n for n, _ in P1_ROWS)
P1F_ROW_NAMES = tuple(n for n, _ in P1F_ROWS)
P2_ROW_NAMES = tuple(n for n, _ in P2_META_ROWS) + SEARCH_ROW_NAMES


def finalize_rows_np(arr: np.ndarray, names, true_lens: np.ndarray,
                     cfg: PipelineConfig) -> dict:
    """Host finalization of named int32 rows: half-local coordinates -> true
    stranded coords (see edgescan.finalize_meta_np), kmer halves -> bc_kmer."""
    rows = {n: arr[i].astype(np.int64) for i, n in enumerate(names)}
    L = np.asarray(true_lens).astype(np.int64)
    is_fwd = rows["is_fwd"] != 0
    stranded = rows["stranded"] != 0
    out = {"is_fwd": is_fwd, "stranded": stranded,
           "true_lens": np.asarray(true_lens),
           "has_polyat": rows["has_polyat"] != 0}
    shift = L - eg2.E
    is5p = getattr(cfg, "chemistry", "3p") == "5p"

    def fin(loc):
        return np.where(is_fwd, loc + shift, L - 1 - loc)

    if "ps" in rows:
        has_pat = out["has_polyat"]
        out["ps"] = np.where(has_pat, fin(rows["ps"]), -1)
        out["pe"] = np.where(has_pat, fin(rows["pe"]), -1)
    ae = np.where(stranded, rows["ae"] if is5p else fin(rows["ae"]), -1)
    out["ae"] = ae
    nb = cfg.readscanner.nbases_of_adapter_seq_in_readname
    if is5p:
        out["x_start"] = ae - nb + 1
        out["x_end"] = ae + 40
    else:
        out["x_start"] = ae - 40
        out["x_end"] = ae + nb - 1
    if "tso_end" in rows:
        out["tso_end"] = rows["tso_end"]
    if "adapter_run" in rows:
        out["adapter_run"] = rows["adapter_run"]
    if "kmer_lo" in rows:
        out["bc_kmer"] = (((rows["kmer_hi"] & 0xFFFF) << 16)
                          | (rows["kmer_lo"] & 0xFFFF)).astype(np.uint32)
        out["bc_kmer_valid"] = rows["kmer_valid"] != 0
    for k in SEARCH_ROW_NAMES:
        if k in rows:
            out[k] = rows[k]
    return out


# ---------------------------------------------------------------------------
# Pass bodies (device tensors in, int32 rows out)
# ---------------------------------------------------------------------------

def _search_rows(wins_u8: torch.Tensor, peq_bc: torch.Tensor, nvalid: int,
                 cfg: PipelineConfig, mode: str, qgram_t, radius: int,
                 K: int) -> torch.Tensor:
    """The whitelist search of text-major BC windows (uint8 [bw, B]) ->
    int32 [4, B] (SEARCH_ROW_NAMES). "sweep": the brute sweep kernel,
    overflow 0. "prefilter": the q-gram candidate search, exact within
    `radius`; overflow marks the reads the caller re-runs on the sweep."""
    m = cfg.barcodes.cell_bc_length
    if mode == "prefilter":
        res = bcsearch.qgram_prefilter_search(
            wins_u8.t().to(torch.int8), qgram_t, peq_bc, nvalid, m, radius, K)
        return res[[0, 1, 2, 4]]
    best = bcsearch.bc_sweep(wins_u8, peq_bc, nvalid, m, track_pos=False)
    return torch.cat([best[:3], torch.zeros_like(best[:1])])


def make_pass1_body2(cfg: PipelineConfig):
    """Pass-1 body: fn(codes, lens) -> int32 [len(P1_ROWS), B]."""
    p = eg2.edge_params(cfg)
    sel = [r for _, r in P1_ROWS]

    def fn(codes, lens):
        return edge_scan2(codes, lens, p)[sel]

    return fn


def make_pass1_full_body(cfg: PipelineConfig, fused_tiles: bool = False):
    """Pass-1 FULL body of the cached pipeline: ONE edge scan emits the
    pass-1 rows, everything pass 2 emits from, and the BC search windows
    (uint8 [bw, B]) the pass-2 sweep reads. fn(codes, lens) -> (rows
    int32 [len(P1F_ROWS), B], windows uint8 [bw, B]). With `fused_tiles`
    fn(codes, lens, idx) and a third output: the chimera scan [3, C] int32
    of the tile feed's rows of the reads idx [C] int32 (the covered reads,
    `feed_covered`) of the SAME uploaded codes; the reads with an interior
    outside the feed take the host tiles. C = 0 launches neither kernel."""
    p = eg2.edge_params(cfg)
    tp = tile_params(cfg)
    sel = [r for _, r in P1F_ROWS]

    def fn(codes, lens, idx=None):
        meta = edge_scan2(codes, lens, p)
        out = (meta[sel], meta[eg2.ROW_BC0:].to(torch.uint8))
        if fused_tiles:
            out += (tile_scan(tile_feed(codes, lens, idx, tp), tp)
                    if len(idx) else
                    torch.zeros((3, 0), dtype=torch.int32,
                                device=codes.device),)
        return out

    return fn


def make_scan_search2_body(cfg: PipelineConfig, mode: str = "sweep",
                           radius: int = 2, K: int = 64):
    """Fused edge scan + whitelist search: fn(codes, lens, peq_bc,
    nvalid, qgram_t) -> int32 [len(P2_ROW_NAMES), B]."""
    p = eg2.edge_params(cfg)
    sel = [r for _, r in P2_META_ROWS]

    def fn(codes, lens, peq_bc, nvalid, qgram_t=None):
        meta = edge_scan2(codes, lens, p)
        wins = meta[eg2.ROW_BC0:].to(torch.uint8)
        return torch.cat([meta[sel], _search_rows(
            wins, peq_bc, nvalid, cfg, mode, qgram_t, radius, K)])

    return fn


def make_sweep_only_body(cfg: PipelineConfig, mode: str = "sweep",
                         radius: int = 2, K: int = 64):
    """Whitelist search alone over cached BC windows (uint8 [bw, B]) — the
    cached pipeline's pass-2 device step. fn(wins, peq_bc, nvalid, qgram_t)
    -> int32 [4, B]: best_ed, best_idx, second_ed, overflow."""

    def fn(wins_u8, peq_bc, nvalid, qgram_t=None):
        return _search_rows(wins_u8, peq_bc, nvalid, cfg, mode, qgram_t,
                            radius, K)

    return fn


def _to_host_async(t: torch.Tensor):
    """Start a device->host copy; `_host` waits for it."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _host(h) -> np.ndarray:
    t, ev = h
    if ev is not None:
        ev.synchronize()
    return t.numpy()


def _host_rows(handles, i: int = 0, axis: int = -1) -> np.ndarray:
    """Output i of each shard (`ReadScanModel._sharded`) on the host, the
    shards' parts joined in read order along `axis` (the columns of the
    [rows, B] outputs; axis 0 for qv2, [B, 2E])."""
    parts = [_host(h[i]) for h in handles]
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)


def _encode(staged: enc.Staged, dev, a: int, b: int):
    """Rows [a, b) of a staged chunk on `dev`, encoded there (one upload,
    one encode launch): (codes [n, 2E] int8, lens [n] int32, qv2, qsum)."""
    inp = staged.upload(dev, a, b)
    codes, qv2, qsum = enc.encode_two_half_dev(*inp)
    return codes, inp.lens(), qv2, qsum


def fused_tiles_route(device: torch.device, mesh) -> bool:
    """Whether the cached pass 1 scans the short reads' interiors from its
    own upload (the tile feed): on a CUDA device without a mesh, as the
    JAX package does on its accelerator without one
    (`_p1f_tiles = on_tpu and self.mesh is None`)."""
    return torch.device(device).type == "cuda" and mesh is None


class ReadScanModel:
    """Host-side wrapper: owns the pattern bitmasks, the pass bodies and the
    bound used-barcode list on one device, or on each device of a mesh.
    `_p1f_tiles` (from `fused_tiles_route`; a test may set it) picks the
    cached pass 1's route for the chimera scan."""

    def __init__(self, cfg: PipelineConfig | None = None, device="cuda",
                 mesh=None):
        """`mesh`: a list of devices (of `device`'s type) the sharded
        methods split their rows across; the other methods run on its
        first device."""
        self.cfg = cfg or PipelineConfig()
        self.mesh = None if mesh is None else shard.resolve_mesh(mesh, device)
        self.device = self.mesh[0] if self.mesh else resolve(device)
        self.is5p = getattr(self.cfg, "chemistry", "3p") == "5p"
        self.peq_ad, self.peq_adc, self.peq_tso = \
            eg2.patterns_from_cfg(self.cfg)
        self._tile_params = tile_params(self.cfg)
        self._pass1_fn = make_pass1_body2(self.cfg)
        self._pass1_full_fn = make_pass1_full_body(self.cfg)
        self._pass1_full_tiles_fn = make_pass1_full_body(self.cfg,
                                                         fused_tiles=True)
        self._p1f_tiles = fused_tiles_route(self.device, self.mesh)
        self._edge_fn = make_edge_scan_fn(self.cfg)
        self._internal_fn = make_internal_scan_fn(self.cfg)

    @property
    def bc_window_width(self) -> int:
        return eg2.bc_window_width(self.cfg)

    def prepare_search(self, patterns: np.ndarray, n_valid: int,
                       radius: int = 2, mode: str | None = None,
                       K: int = 64):
        """Bind a used-barcode list ([N, m] int8 code matrix) for the
        whitelist search. `mode` None/"sweep" is the brute sweep (the
        kernel). "prefilter" is the q-gram candidate search for very large
        used lists (`ops.bcsearch.qgram_prefilter_search`, at most `K`
        candidates a read): its results are exact within `radius`, the
        dynamic-ED search radius, and report not-found beyond it."""
        mode = mode or "sweep"
        if mode not in ("sweep", "prefilter"):
            raise ValueError(f"unknown search mode {mode!r}")
        used_peq = editdist.build_peq(patterns) if len(patterns) else \
            np.zeros((4, 1), np.uint32)
        self._peq_raw = used_peq
        self._peq_bc = bcsearch.peq_device(used_peq, self.device)
        self._n_valid = n_valid
        self._mode = mode
        self._radius = radius
        self._qgram_t = None
        if mode == "prefilter":
            qt = np.zeros((256, used_peq.shape[1]), np.float32)
            if len(patterns):
                qt = bcsearch.build_qgram_table(patterns)
            self._qgram_t = torch.from_numpy(qt).to(self.device)
        # a copy of the list on every other device of the mesh
        self._list_copies = {
            dev: (self._peq_bc.to(dev), None if self._qgram_t is None
                  else self._qgram_t.to(dev))
            for dev in set(self.mesh or ()) - {self.device}}
        self._search_fn = make_scan_search2_body(self.cfg, mode, radius, K)
        self._sweep_only_fn = make_sweep_only_body(self.cfg, mode, radius, K)

    def _used_list(self, dev):
        """The bound used list on `dev` as the search bodies take it:
        (peq_bc, nvalid, qgram_t)."""
        peq, qt = (self._peq_bc, self._qgram_t) if dev == self.device \
            else self._list_copies[dev]
        return peq, self._n_valid, qt

    # -- shards ----------------------------------------------------------

    def _staged(self, seqs, quals) -> enc.Staged:
        """A chunk's bytes joined and staged for the spans `_sharded` cuts
        (each shard uploads its own span)."""
        devices = self.mesh or [self.device]
        return enc.Staged(enc.join(seqs, quals),
                         shard.cuts(len(seqs), len(devices)),
                         devices[0].type)

    def _sharded(self, n: int, body):
        """body(device, a, b) -> a device tensor, or a tuple of them, for
        rows [a, b) of n, on each shard that has rows (n == 0: once, on the
        first); every shard's work is issued, and its outputs' copies to the
        host started, before any is waited on. -> [(copy handle, ...)] a
        shard, for `_host_rows`."""
        devices = self.mesh or [self.device]

        def run(dev, a, b):
            out = body(dev, a, b)
            return tuple(_to_host_async(t) for t in
                         (out if isinstance(out, tuple) else (out,)))

        return shard.map_shards(devices, shard.cuts(n, len(devices)), run)

    # -- pass 1 (streaming) ----------------------------------------------

    def scan_pass1_async(self, seqs: list[bytes], quals: list[bytes]):
        """Launch the pass-1 scan; force with finish_pass1. Every shard's
        outputs start with its qv2 and qsum (`_encode`)."""
        st = self._staged(seqs, quals)

        def run(dev, a, b):
            codes, lens, qv2, qsum = _encode(st, dev, a, b)
            return qv2, qsum, self._pass1_fn(codes, lens)

        return self._sharded(len(seqs), run), st.chunk.lens

    def finish_pass1(self, handle):
        hs, true_lens = handle
        out = finalize_rows_np(_host_rows(hs, 2), P1_ROW_NAMES, true_lens,
                               self.cfg)
        qv2, qsum = _host_rows(hs, 0, axis=0), _host_rows(hs, 1)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum, need_x=False)
        return out

    def scan_pass1(self, seqs: list[bytes], quals: list[bytes]):
        """Pass-1 scan of one chunk, synchronously."""
        return self.finish_pass1(self.scan_pass1_async(seqs, quals))

    # -- pass-1 FULL variant + sweep-only pass 2 (cached pipeline) -------

    def scan_pass1_full_async(self, seqs: list[bytes], quals: list[bytes]):
        """Launch the pass-1 FULL scan (edge rows + BC windows, and on the
        fused route the covered reads' chimera scan, see
        make_pass1_full_body); force with finish_pass1_full."""
        st = self._staged(seqs, quals)
        true_lens = st.chunk.lens
        body = self._pass1_full_tiles_fn if self._p1f_tiles \
            else self._pass1_full_fn
        # the fused route (one device, no mesh: one shard, a = 0): the
        # covered reads' index, from the host's lengths, goes up beside the
        # chunk's bytes
        cov_idx = np.nonzero(feed_covered(true_lens, self._tile_params))[0] \
            if self._p1f_tiles else None

        def run(dev, a, b):
            codes, lens, qv2, qsum = _encode(st, dev, a, b)
            args = (codes, lens)
            if cov_idx is not None:
                args += (torch.from_numpy(cov_idx.astype(np.int32)).to(dev),)
            return qv2, qsum, *body(*args)

        hs = self._sharded(len(true_lens), run)
        return hs, true_lens, cov_idx

    def finish_pass1_full(self, handle):
        """-> (out dict with finalized ps/pe/ae/tso/x windows and all three
        QV means, the BC search windows uint8 [bw, B] for the pass-2
        sweep, the fused route's chimera scan [3, B] int32 or None: the
        covered reads' rows scattered back to their reads, every other read
        n = 0, no split)."""
        hs, true_lens, cov_idx = handle
        out = finalize_rows_np(_host_rows(hs, 2), P1F_ROW_NAMES, true_lens,
                               self.cfg)
        eg2.compute_qvs2_np(_host_rows(hs, 0, axis=0), true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            _host_rows(hs, 1))
        tiles3 = None
        if cov_idx is not None:
            tiles3 = np.zeros((3, len(true_lens)), np.int32)
            tiles3[1:] = -1
            tiles3[:, cov_idx] = _host_rows(hs, 4)
        return out, _host_rows(hs, 3), tiles3

    def tiles_fused_mask(self, true_lens, dirty):
        """(covered, need): the reads whose chimera scan the fused pass 1
        already made (`feed_covered`, not dirty), and the rest with an
        interior (L > min_len), which still need the host tiles. The port's
        codes are N-safe, so its caller passes `dirty` all False."""
        L = np.asarray(true_lens).astype(np.int64)
        has_interior = L > 2 * self._tile_params.edge + self._tile_params.k
        covered = feed_covered(L, self._tile_params) & ~np.asarray(dirty)
        return covered, has_interior & ~covered

    def finish_tiles_merged(self, tiles3, covered, sub_handle, need_idx):
        """Merge the fused route's chimera scan of the covered reads with
        the host tile scan of the residue (`sub_handle`, over the reads
        `need_idx`) -> (splits, discard) as finish_internal_tiles returns
        them. A covered read's tile starts at 0, so its splits are read
        positions."""
        n, s0, s1 = tiles3
        splits, discard = _collect_splits(
            (int(r), 0, int(n[r]), int(s0[r]), int(s1[r]))
            for r in np.nonzero((n > 0) & covered)[0])
        sub_splits, sub_discard = self.finish_internal_tiles(sub_handle)
        for si, pos in sub_splits.items():
            splits[int(need_idx[si])] = pos
        for si in sub_discard:
            discard.add(int(need_idx[si]))
        return splits, discard

    def bc_sweep_async(self, windows_tm: np.ndarray):
        """Launch the whitelist sweep alone on cached pass-1 BC windows
        (uint8 [bw, B]); force with finish_bc_sweep. Requires
        prepare_search."""
        hs = self._sharded(windows_tm.shape[1], lambda dev, a, b:
                           self._sweep_only_fn(torch.from_numpy(
                               np.ascontiguousarray(windows_tm[:, a:b])).to(
                               dev), *self._used_list(dev)))
        return hs, windows_tm

    def _bc_dict(self, rows: dict) -> dict:
        """Search rows -> bc dict {ed, idx, ed2}: ed at or above I16_BIG
        reports bcsearch BIG, ed2 there reports INT_MAX (no second
        barcode)."""
        ed = np.where(rows["best_ed"] >= I16_BIG, bcsearch.BIG,
                      rows["best_ed"])
        ed2 = np.where(rows["second_ed"] >= I16_BIG, editdist.INT_MAX,
                       rows["second_ed"])
        return {"ed": ed, "idx": rows["best_idx"], "ed2": ed2}

    def _redo_exact(self, bc: dict, idxs: np.ndarray, wins: np.ndarray):
        """Re-run the reads `idxs` (prefilter overflow: more than K
        candidates) through the exact sweep over their BC windows `wins`
        [len(idxs), bw]; in prefilter mode the results are masked to the
        search radius like the prefilter's own."""
        sub = bcsearch.bc_search(wins, self._peq_raw, self._n_valid,
                                 self.cfg.barcodes.cell_bc_length,
                                 device=self.device)
        if self._mode == "prefilter":
            r = self._radius
            sub["ed2"] = np.where(sub["ed2"] > r, editdist.INT_MAX,
                                  sub["ed2"])
            over = sub["ed"] > r
            sub["ed"] = np.where(over, bcsearch.BIG, sub["ed"])
            sub["idx"] = np.where(over, bcsearch.BIG, sub["idx"])
        for k in bc:
            bc[k][idxs] = sub[k]

    def finish_bc_sweep(self, handle):
        """-> bc dict {ed, idx, ed2} with the same not-found/overflow
        semantics as finish_search's fused rows."""
        hs, windows_tm = handle
        arr = _host_rows(hs).astype(np.int64)
        bc = self._bc_dict(dict(zip(SEARCH_ROW_NAMES, arr)))
        idxs = np.nonzero(arr[3])[0]
        if len(idxs):
            self._redo_exact(bc, idxs, windows_tm[:, idxs].T)
        return bc

    # -- fused scan + sweep (streaming pass 2, split-part rescans) -------

    def scan_search_async(self, seqs: list[bytes], quals: list[bytes]):
        """Launch the fused edge scan + whitelist sweep; force with
        finish_search. Requires prepare_search."""
        st = self._staged(seqs, quals)

        def run(dev, a, b):
            codes, lens, qv2, qsum = _encode(st, dev, a, b)
            return qv2, qsum, self._search_fn(codes, lens,
                                              *self._used_list(dev))

        hs = self._sharded(len(seqs), run)
        return hs, st.chunk.lens, seqs, quals

    def finish_search(self, handle):
        """Force a scan_search_async result -> (edge dict, best dict)."""
        hs, true_lens, seqs, quals = handle
        out = finalize_rows_np(_host_rows(hs, 2), P2_ROW_NAMES, true_lens,
                               self.cfg)
        # pass-2 emit consumes only x_qv (bc/read QV are pass-1 criteria)
        eg2.compute_qvs2_np(_host_rows(hs, 0, axis=0), true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            _host_rows(hs, 1), need_bc=False,
                            need_read=False)
        bc = self._bc_dict(out)
        idxs = np.nonzero(out["overflow"])[0]
        if len(idxs):
            # the fused rows carry no BC windows: scan those reads again
            inp = enc.chunk_inputs([seqs[i] for i in idxs],
                                   [quals[i] for i in idxs], self.device)
            _, wins = self._pass1_full_fn(enc.encode_two_half_dev(*inp)[0],
                                          inp.lens())
            self._redo_exact(bc, idxs, wins.t().cpu().numpy())
        return out, bc

    # -- v1: composite edge scan + bucketed chimera scan (synchronous) ---

    def scan_reads(self, seqs: list[bytes], quals: list[bytes]):
        """Composite edge scan of raw reads; coords remapped to true reads.
        The composite rows are encoded on the device from the reads' bytes
        (`encode_composite_dev`); the qualities come down for the QVs,
        which are computed on the host."""
        inp = enc.chunk_inputs(seqs, quals, self.device)
        codes, qv = enc.encode_composite_dev(*inp)
        qv_h = _to_host_async(qv)
        true_lens = np.diff(inp.host_soffs).astype(np.int32)
        out_d = self._edge_fn(codes, inp.lens().clamp(max=2 * EDGE))
        meta = torch.stack([out_d[k].to(torch.int32)
                            for k in EDGE_META_KEYS])
        out = unpack_edge_meta(meta.cpu().numpy())
        out["bc_windows"] = out_d["bc_windows"].cpu().numpy()
        compute_qvs_np(_host(qv_h), np.minimum(true_lens, 2 * EDGE), out,
                       self.cfg.barcodes.cell_bc_length, self.is5p)
        for key in ("ps", "pe", "ae", "x_start", "x_end"):
            out[key] = remap_composite(out[key], true_lens)
        out["true_lens"] = true_lens
        return out

    def scan_internal(self, seqs, lens):
        """Internal/chimera scan on full-length [B, L] int8 batches -> dict
        of numpy arrays (`unpack_internal_meta`)."""
        meta = self._internal_fn(
            torch.from_numpy(np.ascontiguousarray(seqs, dtype=np.int8)).to(
                self.device),
            torch.from_numpy(np.asarray(lens, dtype=np.int32)).to(
                self.device))
        return unpack_internal_meta(meta.cpu().numpy())

    # -- tiled internal/chimera scan -------------------------------------

    def internal_tiles_async(self, seqs: list[bytes]):
        """Launch the tiled chimera scan for a chunk; None when no read is
        long enough. Force with finish_internal_tiles."""
        rows, read_idx, g0s = build_tiles(seqs, self.cfg)
        if len(rows) == 0:
            return None
        # torch.tensor copies: the native tiler returns read-only buffers
        hs = self._sharded(len(rows), lambda dev, a, b: tile_scan(
            torch.tensor(rows[a:b], device=dev), self._tile_params))
        return hs, read_idx, g0s

    def finish_internal_tiles(self, handle):
        """-> (splits {read_idx: [global split pos]} for single-junction
        reads, discard set for multi-junction reads)."""
        if handle is None:
            return {}, set()
        hs, read_idx, g0s = handle
        arr = _host_rows(hs)
        n, s0, s1 = arr[0], arr[1], arr[2]
        return _collect_splits(
            (int(read_idx[t]), int(g0s[t]), int(n[t]), int(s0[t]),
             int(s1[t])) for t in np.nonzero(n > 0)[0])


def _collect_splits(tiles):
    """(read, g0, n, split0, split1) of each tile with n > 0, splits
    tile-local (-1 when absent) -> (splits {read: [g0 + split]} for
    single-junction reads, discard set for multi-junction reads: more than
    one distinct split over the read's tiles, or more than two in one
    tile)."""
    per_read: dict[int, set] = {}
    for r, g, n, s0, s1 in tiles:
        ps = per_read.setdefault(r, set())
        if n >= 1 and s0 >= 0:
            ps.add(g + s0)
        if n >= 2 and s1 >= 0:
            ps.add(g + s1)
        if n > 2:
            ps.add(-1)  # >2 distinct in one tile: multi-chimeric
    splits: dict[int, list[int]] = {}
    discard: set[int] = set()
    for r, ps in per_read.items():
        if -1 in ps or len(ps) > 1:
            discard.add(r)
        elif len(ps) == 1:
            splits[r] = sorted(ps)
    return splits, discard
