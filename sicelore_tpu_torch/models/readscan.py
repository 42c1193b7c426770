"""Read-scan model: the v2 two-half scan passes of `scanfastq` on a device.

Port of the v2 path of `sicelore_tpu/models/readscan.py::ReadScanModel` (the
one `ScanFastqPipeline.run` drives). Every read ships as N-safe int8 codes
(`ops.edgescan.encode_two_half`), so the device result is final for every
read: no read or tile re-runs on a second, exact path. Device outputs are
int32 rows named by the `*_ROW_NAMES` tuples and finalized on the host
(`finalize_rows_np`) into the same dicts the JAX model returns.

Kernels on this path (CUDA for CUDA tensors, plain torch for CPU tensors):
  * edge scan       ops.edgescan_cuda.edge_scan2   (pass 1, split rescans,
                                                    streaming pass 2)
  * whitelist sweep ops.bcsearch.bc_sweep          (pass 2)
  * chimera scan    ops.tilescan_cuda.tile_scan    (pass 2)

`*_async` methods launch on the device's current stream and start the
device->host copy; the matching `finish_*` waits for it, so the pipeline
overlaps one chunk's host work with the next chunk's device work.
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import PipelineConfig
from sicelore_tpu_torch.device import resolve
from sicelore_tpu_torch.ops import bcsearch, editdist
from sicelore_tpu_torch.ops import edgescan as eg2
from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
from sicelore_tpu_torch.ops.tilescan_cuda import (ROW_BYTES, TILE,
                                                  tile_params, tile_scan)

I16_BIG = 32000   # sweep EDs at or above it report not-found (bcsearch.BIG)

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
SEARCH_ROW_NAMES = ("best_ed", "best_idx", "second_ed")
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

def _sweep(wins_u8: torch.Tensor, peq_bc: torch.Tensor, nvalid: int,
           cfg: PipelineConfig) -> torch.Tensor:
    return bcsearch.bc_sweep(wins_u8, peq_bc, nvalid,
                             cfg.barcodes.cell_bc_length, track_pos=False)[:3]


def make_pass1_body2(cfg: PipelineConfig):
    """Pass-1 body: fn(codes_tm, lens) -> int32 [len(P1_ROWS), B]."""
    p = eg2.edge_params(cfg)
    sel = [r for _, r in P1_ROWS]

    def fn(codes_tm, lens):
        return edge_scan2(codes_tm, lens, p)[sel]

    return fn


def make_pass1_full_body(cfg: PipelineConfig):
    """Pass-1 FULL body of the cached pipeline: ONE edge scan emits the
    pass-1 rows, everything pass 2 emits from, and the BC search windows
    (uint8 [bw, B]) the pass-2 sweep reads. fn(codes_tm, lens) -> (rows
    int32 [len(P1F_ROWS), B], windows uint8 [bw, B])."""
    p = eg2.edge_params(cfg)
    sel = [r for _, r in P1F_ROWS]

    def fn(codes_tm, lens):
        meta = edge_scan2(codes_tm, lens, p)
        return meta[sel], meta[eg2.ROW_BC0:].to(torch.uint8)

    return fn


def make_scan_search2_body(cfg: PipelineConfig):
    """Fused edge scan + whitelist sweep: fn(codes_tm, lens, peq_bc, nvalid)
    -> int32 [len(P2_ROW_NAMES), B]."""
    p = eg2.edge_params(cfg)
    sel = [r for _, r in P2_META_ROWS]

    def fn(codes_tm, lens, peq_bc, nvalid):
        meta = edge_scan2(codes_tm, lens, p)
        wins = meta[eg2.ROW_BC0:].to(torch.uint8)
        return torch.cat([meta[sel], _sweep(wins, peq_bc, nvalid, cfg)])

    return fn


def make_sweep_only_body(cfg: PipelineConfig):
    """Whitelist sweep alone over cached BC windows (uint8 [bw, B]) — the
    cached pipeline's pass-2 device step. fn(wins, peq_bc, nvalid) -> int32
    [3, B]: best_ed, best_idx, second_ed."""

    def fn(wins_u8, peq_bc, nvalid):
        return _sweep(wins_u8, peq_bc, nvalid, cfg)

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


class ReadScanModel:
    """Host-side wrapper: owns the pattern bitmasks, the pass bodies and the
    bound used-barcode list on one device."""

    def __init__(self, cfg: PipelineConfig | None = None, device="cuda"):
        self.cfg = cfg or PipelineConfig()
        self.device = resolve(device)
        self.is5p = getattr(self.cfg, "chemistry", "3p") == "5p"
        self.peq_ad, self.peq_adc, self.peq_tso = \
            eg2.patterns_from_cfg(self.cfg)
        self._tile_params = tile_params(self.cfg)
        self._pass1_fn = make_pass1_body2(self.cfg)
        self._pass1_full_fn = make_pass1_full_body(self.cfg)

    @property
    def bc_window_width(self) -> int:
        return eg2.bc_window_width(self.cfg)

    def prepare_search(self, patterns: np.ndarray, n_valid: int,
                       radius: int = 2, mode: str | None = None,
                       K: int = 64):
        """Bind a used-barcode list ([N, m] int8 code matrix) for the sweep.
        `mode` None/"sweep" is the brute whitelist sweep (the kernel). The
        q-gram "prefilter" mode (the only user of `radius` and `K`) is not
        ported yet and raises NotImplementedError."""
        if mode == "prefilter":
            raise NotImplementedError(
                "the q-gram prefilter search is not ported yet (ROADMAP.md "
                "Queue 1, next slice (a))")
        if mode not in (None, "sweep"):
            raise ValueError(f"unknown search mode {mode!r}")
        used_peq = editdist.build_peq(patterns) if len(patterns) else \
            np.zeros((4, 1), np.uint32)
        self._peq_raw = used_peq
        self._peq_bc = bcsearch.peq_device(used_peq, self.device)
        self._n_valid = n_valid
        self._search_fn = make_scan_search2_body(self.cfg)
        self._sweep_only_fn = make_sweep_only_body(self.cfg)

    # -- uploads ---------------------------------------------------------

    def _upload(self, seqs: list[bytes], quals: list[bytes]):
        codes, qv2, true_lens, qsum = eg2.encode_two_half(seqs, quals)
        codes_tm = torch.from_numpy(codes).to(self.device).t().contiguous()
        lens = torch.from_numpy(true_lens).to(self.device)
        return codes_tm, lens, qv2, true_lens, qsum

    # -- pass 1 (streaming) ----------------------------------------------

    def scan_pass1_async(self, seqs: list[bytes], quals: list[bytes]):
        """Launch the pass-1 scan; force with finish_pass1."""
        codes_tm, lens, qv2, true_lens, qsum = self._upload(seqs, quals)
        rows = self._pass1_fn(codes_tm, lens)
        return _to_host_async(rows), qv2, true_lens, qsum

    def finish_pass1(self, handle):
        h, qv2, true_lens, qsum = handle
        out = finalize_rows_np(_host(h), P1_ROW_NAMES, true_lens, self.cfg)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum, need_x=False)
        return out

    # -- pass-1 FULL variant + sweep-only pass 2 (cached pipeline) -------

    def scan_pass1_full_async(self, seqs: list[bytes], quals: list[bytes]):
        """Launch the pass-1 FULL scan (edge rows + BC windows, see
        make_pass1_full_body); force with finish_pass1_full."""
        codes_tm, lens, qv2, true_lens, qsum = self._upload(seqs, quals)
        rows, wins = self._pass1_full_fn(codes_tm, lens)
        return (_to_host_async(rows), _to_host_async(wins), qv2, true_lens,
                qsum)

    def finish_pass1_full(self, handle):
        """-> (out dict with finalized ps/pe/ae/tso/x windows and all three
        QV means, the BC search windows uint8 [bw, B] for the pass-2
        sweep)."""
        h_rows, h_wins, qv2, true_lens, qsum = handle
        out = finalize_rows_np(_host(h_rows), P1F_ROW_NAMES, true_lens,
                               self.cfg)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum)
        return out, _host(h_wins)

    def bc_sweep_async(self, windows_tm: np.ndarray):
        """Launch the whitelist sweep alone on cached pass-1 BC windows
        (uint8 [bw, B]); force with finish_bc_sweep. Requires
        prepare_search."""
        wins = torch.from_numpy(np.ascontiguousarray(windows_tm)).to(
            self.device)
        res = self._sweep_only_fn(wins, self._peq_bc, self._n_valid)
        return _to_host_async(res)

    def finish_bc_sweep(self, handle):
        """-> bc dict {ed, idx, ed2}: ed at or above I16_BIG reports
        bcsearch BIG, ed2 there reports INT_MAX (no second barcode)."""
        arr = _host(handle).astype(np.int64)
        ed = np.where(arr[0] >= I16_BIG, bcsearch.BIG, arr[0])
        ed2 = np.where(arr[2] >= I16_BIG, editdist.INT_MAX, arr[2])
        return {"ed": ed, "idx": arr[1], "ed2": ed2}

    # -- fused scan + sweep (streaming pass 2, split-part rescans) -------

    def scan_search_async(self, seqs: list[bytes], quals: list[bytes]):
        """Launch the fused edge scan + whitelist sweep; force with
        finish_search. Requires prepare_search."""
        codes_tm, lens, qv2, true_lens, qsum = self._upload(seqs, quals)
        rows = self._search_fn(codes_tm, lens, self._peq_bc, self._n_valid)
        return _to_host_async(rows), qv2, true_lens, qsum

    def finish_search(self, handle):
        """Force a scan_search_async result -> (edge dict, best dict)."""
        h, qv2, true_lens, qsum = handle
        out = finalize_rows_np(_host(h), P2_ROW_NAMES, true_lens, self.cfg)
        # pass-2 emit consumes only x_qv (bc/read QV are pass-1 criteria)
        eg2.compute_qvs2_np(qv2, true_lens, out,
                            self.cfg.barcodes.cell_bc_length, self.is5p,
                            qsum, need_bc=False, need_read=False)
        ed = np.where(out["best_ed"] >= I16_BIG, bcsearch.BIG,
                      out["best_ed"])
        ed2 = np.where(out["second_ed"] >= I16_BIG, editdist.INT_MAX,
                       out["second_ed"])
        return out, {"ed": ed, "idx": out["best_idx"], "ed2": ed2}

    # -- tiled internal/chimera scan -------------------------------------

    def internal_tiles_async(self, seqs: list[bytes]):
        """Launch the tiled chimera scan for a chunk; None when no read is
        long enough. Force with finish_internal_tiles."""
        rows, read_idx, g0s = build_tiles(seqs, self.cfg)
        if len(rows) == 0:
            return None
        # torch.tensor copies: the native tiler returns read-only buffers
        res = tile_scan(torch.tensor(rows, device=self.device),
                        self._tile_params)
        return _to_host_async(res), read_idx, g0s

    def finish_internal_tiles(self, handle):
        """-> (splits {read_idx: [global split pos]} for single-junction
        reads, discard set for multi-junction reads)."""
        if handle is None:
            return {}, set()
        h, read_idx, g0s = handle
        arr = _host(h)
        n, s0, s1 = arr[0], arr[1], arr[2]
        per_read: dict[int, set] = {}
        for t in np.nonzero(n > 0)[0]:
            r = int(read_idx[t])
            g = int(g0s[t])
            ps = per_read.setdefault(r, set())
            if n[t] >= 1 and s0[t] >= 0:
                ps.add(g + int(s0[t]))
            if n[t] >= 2 and s1[t] >= 0:
                ps.add(g + int(s1[t]))
            if n[t] > 2:
                ps.add(-1)  # >2 distinct in one tile: multi-chimeric
        splits: dict[int, list[int]] = {}
        discard: set[int] = set()
        for r, ps in per_read.items():
            if -1 in ps or len(ps) > 1:
                discard.add(r)
            elif len(ps) == 1:
                splits[r] = sorted(ps)
        return splits, discard
