"""Two-half edge scan: constants, host encoder, plain PyTorch body, host
finalization.

Port of `sicelore_tpu/ops/edgescan.py`. Each read is kept as two independent
halves of E bases: the head (first min(L, E) bases, left-aligned) and the
tail (last min(L, E) bases, right-aligned, so the read end is always column
E-1). The port ships the halves as N-safe int8 codes (A,C,G,T,N,PAD =
0..5), the rows [B, 2E] of `encode_two_half` as they are: N and PAD match no
pattern base, so no read needs a second, exact pass (the TPU path packs 2
bits a base and re-runs reads with N through the jnp body).

The body emits [n_rows(cfg), B] int32 rows whose coordinates are HALF-LOCAL
(tail columns for FWD reads, head columns for REV reads);
`finalize_meta_np` maps them to true stranded read coordinates on the host.
The fused CUDA kernel (`ops.edgescan_cuda`) computes the same rows for the
configs inside its envelope, 3p and 5p chemistry. For the others (an adapter
window over 128 columns, say) `edge_scan2_composed` runs the same body as
torch ops with its three adapter searches through the window-search kernel,
as `make_edge_scan2_jnp` does in the JAX package; `edge_scan2_plain`
searches through the plain sweep on any device and is what both are
compared with.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils.config import PipelineConfig
from sicelore_tpu_torch.ops import editdist, scan

E = 304          # bases per half (>= polyA window 150 + adapter window 110)
BIG = 10**9
ED_SENTINEL = 16384  # not-found marker in ROW_AD_ED

# meta row indices of the body output ([n_rows(cfg), B] int32)
(ROW_IS_FWD, ROW_STRANDED, ROW_HAS_POLYAT, ROW_PS, ROW_PE, ROW_AE,
 ROW_AD_ED, ROW_ADC_ED, ROW_AD_RUN, ROW_TSO_END, ROW_TSO_ED,
 ROW_KMER_LO, ROW_KMER_HI, ROW_KMER_VALID) = range(14)
ROW_BC0 = 14


def bc_window_width(cfg: PipelineConfig) -> int:
    return (cfg.barcodes.cell_bc_length
            + 2 * cfg.readscanner.test_plus_minus_pos + 2)


def n_rows(cfg: PipelineConfig) -> int:
    return ROW_BC0 + bc_window_width(cfg)


def _chem(cfg: PipelineConfig):
    is5p = getattr(cfg, "chemistry", "3p") == "5p"
    return (is5p, cfg.adapter5p if is5p else cfg.adapter3p,
            cfg.tso5p if is5p else cfg.tso3p)


def patterns_from_cfg(cfg: PipelineConfig):
    """(peq_ad, peq_adc, peq_tso), each uint32 [4, 1] — the adapter,
    complete-adapter and TSO pattern bitmasks of the configured chemistry,
    exactly as `sicelore_tpu/models/readscan.py::ReadScanModel` builds them."""
    _, a, t = _chem(cfg)
    return tuple(editdist.build_peq(dna.encode(s)[None, :])
                 for s in (a.sequence, a.sequence_complete, t.sequence))


# ---------------------------------------------------------------------------
# Host-side encoding
# ---------------------------------------------------------------------------

_ENC_PAD0 = dna._ENC.copy()
_ENC_PAD0[0] = dna.PAD  # NUL byte = padding in the bulk-encode fast path


def encode_two_half(seqs: list[bytes], quals: list[bytes]):
    """N-safe int8 two-half encoding.

    Returns (codes [B, 2E] int8 — head in cols [0, E), right-aligned tail in
    [E, 2E), PAD outside the read — qv2 [B, 2E] int8 phred in the same
    layout, true_lens [B] int32, qsum [B] int32: the phred sum over the true
    read's head plus the tail part not already in the head)."""
    B = len(seqs)
    z = b"\x00"
    true_lens = np.fromiter((len(s) for s in seqs), dtype=np.int32, count=B)
    sbuf = b"".join(s[:E].ljust(E, z) + s[-E:].rjust(E, z) for s in seqs)
    codes = _ENC_PAD0[np.frombuffer(sbuf, np.uint8)].reshape(B, 2 * E)
    qbuf = b"".join(q[:E].ljust(E, z) + q[-E:].rjust(E, z) for q in quals)
    qarr = np.frombuffer(qbuf, np.uint8).reshape(B, 2 * E)
    qv2 = np.where(qarr >= 33, qarr.astype(np.int16) - 33, 0).astype(np.int8)
    cols = np.arange(2 * E, dtype=np.int32)[None, :]
    hl = np.minimum(true_lens, E)[:, None]
    codes = np.where((cols < hl) | (cols >= 2 * E - hl), codes,
                     np.int8(dna.PAD))
    tshift = np.maximum(true_lens - E, 0)[:, None]
    qs_m = (cols < hl) | (cols >= 2 * E - tshift)
    qsum = np.where(qs_m, qv2.astype(np.int32), 0).sum(axis=1)
    return codes, qv2, true_lens, qsum.astype(np.int32)


# ---------------------------------------------------------------------------
# Scan parameters (one object per PipelineConfig)
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class EdgeParams:
    """Everything the edge scan reads from the config, resolved once."""
    is5p: bool
    k: int
    mc: int
    win_p: int
    awin: int
    twin: int
    m_ad: int
    m_adc: int
    m_tso: int
    mm_ad: int
    mm_tso: int
    off_tso: int
    c1: int
    c2: int
    pad: int
    bc_len: int
    bw: int
    peq_ad: np.ndarray
    peq_adc: np.ndarray
    peq_tso: np.ndarray
    adc_codes: np.ndarray
    tso_codes: np.ndarray
    kernel_unsupported: str   # "" when the CUDA kernel covers this config


def edge_params(cfg: PipelineConfig) -> EdgeParams:
    p = cfg.polyat
    is5p, a, t = _chem(cfg)
    k = p.polyat_length
    mc = scan.min_count_for(k, p.fraction_at_in_polyat)
    peq_ad, peq_adc, peq_tso = patterns_from_cfg(cfg)
    bw = bc_window_width(cfg)
    m_ad, m_adc, m_tso = (len(a.sequence), len(a.sequence_complete),
                          len(t.sequence))
    c1 = t.min_tso_consecutive_matches
    c2 = t.min_tso_two_best_consecutive_matches
    # the kernel's envelope: sicelore_tpu/ops/edgescan_tpu.py::_supported
    # without its 3p-only rule (both chemistries run _edge_body)
    checks = (
        (2 <= k <= 16 and 1 <= mc <= k, "polyAT length/fraction"),
        (p.window_search_for_polya + k <= E - 8, "polyA window"),
        (1 <= m_ad <= 31 and 1 <= m_adc <= 31 and 1 <= m_tso <= 31,
         "pattern length"),
        (a.adapter_search_window <= 128, "adapter window"),
        (t.window_for_tso_search <= 160, "TSO window"),
        (2 <= cfg.readscanner.min_adapter3p_matches <= min(16, m_adc),
         "min adapter matches"),
        (2 <= c1 <= 16 and c2 >= c1, "TSO consecutive-match thresholds"),
        (bw <= 32, "BC window width"),
    )
    bad = [what for ok, what in checks if not ok]
    return EdgeParams(
        is5p=is5p, k=k, mc=mc, win_p=p.window_search_for_polya,
        awin=a.adapter_search_window, twin=t.window_for_tso_search,
        m_ad=m_ad, m_adc=m_adc, m_tso=m_tso,
        mm_ad=a.max_needleman_mismatches, mm_tso=t.max_needleman_mismatches,
        off_tso=t.offset_tso_end, c1=c1, c2=c2,
        pad=cfg.readscanner.test_plus_minus_pos,
        bc_len=cfg.barcodes.cell_bc_length, bw=bw,
        peq_ad=peq_ad, peq_adc=peq_adc, peq_tso=peq_tso,
        adc_codes=dna.encode(a.sequence_complete),
        tso_codes=dna.encode(t.sequence),
        kernel_unsupported=", ".join(bad))


# ---------------------------------------------------------------------------
# The two-half body in torch ops: plain (CPU path + the kernels' reference on
# the card) and composed (window-search kernel; configs outside the fused
# kernel's envelope)
# ---------------------------------------------------------------------------

def edge_scan2_plain(head: torch.Tensor, tail: torch.Tensor,
                     lens: torch.Tensor, p: EdgeParams) -> torch.Tensor:
    """Two-half edge scan of make_edge_scan2_jnp: head/tail [B, E] int8
    (PAD outside the read), lens [B] -> meta [14 + bw, B] int32. Searches
    through the plain Myers sweep on any device, never through a kernel."""
    edge_scan2_plain.launches += 1
    return _edge_body(head, tail, lens, p, scan.adapter_search_plain)


edge_scan2_plain.launches = 0


def edge_scan2_composed(head: torch.Tensor, tail: torch.Tensor,
                        lens: torch.Tensor, p: EdgeParams) -> torch.Tensor:
    """The same rows as `edge_scan2_plain`, with the three adapter searches
    (adapter [2B, awin], complete adapter [B, awin], TSO [B, twin]) through
    `scan.adapter_search`: the window-search kernel for CUDA tensors. The
    edge scan of every config the fused kernel does not cover."""
    edge_scan2_composed.launches += 1
    return _edge_body(head, tail, lens, p, scan.adapter_search)


edge_scan2_composed.launches = 0


def _edge_body(head, tail, lens, p: EdgeParams, search) -> torch.Tensor:
    from sicelore_tpu_torch.models.readscan import gather_window

    B = head.shape[0]
    dev = head.device
    lens = lens.to(device=dev, dtype=torch.int32)
    head_len = torch.clamp(lens, max=E)
    tail_start = E - head_len
    elen = torch.full((B,), E, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(lens)

    rev_found, rev_ts, rev_te = scan.polyat_find(
        head, head_len, base=dna.T, k=p.k, min_count=p.mc,
        window=p.win_p, from_end=False)
    fwd_found, fwd_ps, fwd_pe = scan.polyat_find(
        tail, elen, base=dna.A, k=p.k, min_count=p.mc,
        window=p.win_p, from_end=True, start_min=tail_start)

    awin, twin = p.awin, p.twin
    if p.is5p:
        w_fwd = gather_window(head, head_len, zeros, awin)
        w_rev = gather_window(tail, elen, elen - awin, awin, rc=True)
    else:
        w_fwd = gather_window(tail, elen, fwd_pe + 1, awin, rc=True)
        w_rev = gather_window(head, head_len, rev_ts - awin, awin)
    ed2, pos2 = search(torch.cat([w_fwd, w_rev], dim=0), p.peq_ad, p.m_ad)
    ed_f = torch.where(fwd_found, ed2[:B], BIG)
    ed_r = torch.where(rev_found, ed2[B:], BIG)
    pos_f, pos_r = pos2[:B], pos2[B:]

    ok_f = fwd_found & (ed_f <= p.mm_ad)
    ok_r = rev_found & (ed_r <= p.mm_ad)
    stranded = ok_f | ok_r
    is_fwd = torch.where(stranded, ok_f & (~ok_r | (ed_f <= ed_r)), fwd_found)

    has_pat = torch.where(is_fwd, fwd_found, rev_found)
    ps_loc = torch.where(is_fwd, fwd_ps, rev_te)
    pe_loc = torch.where(is_fwd, fwd_pe, rev_ts)
    if p.is5p:
        ae_loc = torch.where(is_fwd, pos_f, pos_r)     # already stranded
    else:
        ae_loc = torch.where(is_fwd, fwd_pe + awin - pos_f,
                             rev_ts - awin + pos_r)
    ad_ed = torch.where(is_fwd, ed_f, ed_r)
    ad_pos_local = torch.where(is_fwd, pos_f, pos_r)

    w_used = torch.where(is_fwd[:, None], w_fwd, w_rev)
    edc, _ = search(w_used, p.peq_adc, p.m_adc)
    ad_runs, _ = scan.match_run_stats(w_used, p.adc_codes, p.m_adc)
    bc_windows = gather_window(w_used, torch.full_like(lens, awin),
                               ad_pos_local + 1 - p.pad, p.bw)

    # TSO: 3p searches the stranded read start; 5p starts after the BC,
    # from the stranded-masked ae (unstranded reads: ae = -1)
    t0 = (torch.where(stranded, ae_loc, -1) + 1 + p.bc_len) if p.is5p \
        else zeros
    w5_f = gather_window(head, head_len, t0, twin)
    w5_r = gather_window(tail, elen, elen - twin - t0, twin, rc=True)
    w5 = torch.where(is_fwd[:, None], w5_f, w5_r)
    tso_ed, tso_pos = search(w5, p.peq_tso, p.m_tso)
    bail = scan.run_bailout(w5, p.tso_codes, p.m_tso, p.c1, p.c2)
    tso_found = (tso_ed <= p.mm_tso) | bail
    tso_end = torch.where(tso_found, t0 + tso_pos + (p.off_tso - 1), -1)

    codes = bc_windows[:, p.pad:p.pad + p.bc_len].to(torch.int64)
    kvalid = (codes < 4).all(dim=1)
    kmer = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(p.bc_len):
        kmer = ((kmer << 2) | codes[:, i].clamp(max=3)) & 0xFFFFFFFF

    rows = [None] * ROW_BC0
    rows[ROW_IS_FWD] = is_fwd
    rows[ROW_STRANDED] = stranded
    rows[ROW_HAS_POLYAT] = has_pat
    rows[ROW_PS] = ps_loc
    rows[ROW_PE] = pe_loc
    rows[ROW_AE] = ae_loc
    rows[ROW_AD_ED] = torch.where(stranded, ad_ed.clamp(max=ED_SENTINEL),
                                  ED_SENTINEL)
    rows[ROW_ADC_ED] = edc
    rows[ROW_AD_RUN] = ad_runs
    rows[ROW_TSO_END] = tso_end
    rows[ROW_TSO_ED] = tso_ed
    rows[ROW_KMER_LO] = kmer & 0xFFFF
    rows[ROW_KMER_HI] = kmer >> 16
    rows[ROW_KMER_VALID] = kvalid
    meta = torch.stack([r.to(torch.int32) for r in rows], dim=0)
    return torch.cat([meta, bc_windows.t().to(torch.int32)], dim=0)


# ---------------------------------------------------------------------------
# Host finalization (numpy)
# ---------------------------------------------------------------------------

def finalize_meta_np(meta: np.ndarray, true_lens: np.ndarray,
                     cfg: PipelineConfig) -> dict:
    """[n_rows, B] i32 half-local rows -> the edge dict in TRUE STRANDED
    coordinates (host side, vectorized).

    FWD coordinate rows are tail-half columns (true = col + L - E); REV
    rows are head columns q (stranded = L - 1 - q)."""
    L = np.asarray(true_lens).astype(np.int64)
    is_fwd = meta[ROW_IS_FWD] != 0
    stranded = meta[ROW_STRANDED] != 0
    has_pat = meta[ROW_HAS_POLYAT] != 0
    shift = L - E
    is5p = getattr(cfg, "chemistry", "3p") == "5p"

    def fin(loc, flip_rev=True):
        loc = loc.astype(np.int64)
        return np.where(is_fwd, loc + shift,
                        (L - 1 - loc) if flip_rev else loc)

    ps = np.where(has_pat, fin(meta[ROW_PS]), -1)
    pe = np.where(has_pat, fin(meta[ROW_PE]), -1)
    if is5p:
        ae = np.where(stranded, meta[ROW_AE].astype(np.int64), -1)
    else:
        ae = np.where(stranded, fin(meta[ROW_AE]), -1)
    nbases = cfg.readscanner.nbases_of_adapter_seq_in_readname
    x_len = 40 + nbases
    if is5p:
        xs = ae - nbases + 1
        xe = ae + (x_len - nbases)
    else:
        xs = ae - (x_len - nbases)
        xe = ae + nbases - 1
    ad_ed = meta[ROW_AD_ED].astype(np.int64)
    out = {
        "is_fwd": is_fwd, "stranded": stranded, "has_polyat": has_pat,
        "ps": ps, "pe": pe, "ae": ae,
        "adapter_ed": np.where(ad_ed >= ED_SENTINEL, BIG, ad_ed),
        "adapter_complete_ed": meta[ROW_ADC_ED],
        "adapter_run": meta[ROW_AD_RUN],
        "tso_end": meta[ROW_TSO_END], "tso_ed": meta[ROW_TSO_ED],
        "x_start": xs, "x_end": xe,
        "bc_kmer": ((meta[ROW_KMER_HI].astype(np.int64) << 16)
                    | (meta[ROW_KMER_LO].astype(np.int64) & 0xFFFF)
                    ).astype(np.uint32),
        "bc_kmer_valid": meta[ROW_KMER_VALID] != 0,
        "true_lens": np.asarray(true_lens),
    }
    out["bc_windows"] = meta[ROW_BC0:].T.astype(np.int8)
    return out


def compute_qvs2_np(qv2: np.ndarray, true_lens: np.ndarray, out: dict,
                    bc_len: int, is5p: bool = False,
                    qsum: np.ndarray | None = None,
                    need_bc: bool = True, need_x: bool = True,
                    need_read: bool = True) -> None:
    """Host-side QV means over the two-half qual matrix (true stranded
    coordinates in `out`): read_qv, x_qv and bc_qv. True coord q sits at
    head col q (q < E) or tail col q - L + 2E. The need_* flags skip windows
    a pass never consumes."""
    B = qv2.shape[0]
    L2 = 2 * E
    lens = np.asarray(true_lens).astype(np.int64)
    if qsum is None:
        cols = np.arange(L2, dtype=np.int32)[None, :]
        hl = np.minimum(lens, E)[:, None]
        tshift = np.maximum(lens - E, 0)[:, None]
        qs_m = (cols < hl) | (cols >= L2 - tshift)
        qsum = np.where(qs_m, qv2.astype(np.int32), 0).sum(axis=1)
    # mean over the min(L, 2E) distinct composite positions
    if need_read:
        out["read_qv"] = (qsum / np.maximum(np.minimum(lens, L2), 1)
                          ).astype(np.float32)
    is_fwd = out["is_fwd"]
    ae = out["ae"]
    rows = np.arange(B)[:, None]

    def window_mean(s_str, e_str):
        s = np.where(is_fwd, s_str, lens - 1 - e_str).astype(np.int64)
        e = np.where(is_fwd, e_str, lens - 1 - s_str).astype(np.int64)
        from sicelore_tpu_torch.io import native as _native
        ext = _native.get_hostenc()
        if ext is not None and hasattr(ext, "window_qv_means"):
            buf = ext.window_qv_means(
                np.ascontiguousarray(qv2, dtype=np.int8), B, E,
                np.ascontiguousarray(lens), np.ascontiguousarray(s),
                np.ascontiguousarray(e))
            return np.frombuffer(buf, np.float32).copy()
        s = np.clip(s, 0, None)
        e1 = np.minimum(e + 1, lens)
        n = np.maximum(e1 - s, 1)
        Wm = max(int(np.max(n, initial=1)), 1)
        q = s[:, None] + np.arange(Wm, dtype=np.int64)       # true coords
        m = q < e1[:, None]
        col = np.where(q < E, q, q - lens[:, None] + L2)
        col = np.clip(col, 0, L2 - 1)
        w = qv2[rows, col].astype(np.int32)
        return ((w * m).sum(axis=1) / n).astype(np.float32)

    if need_x and "x_start" in out:
        out["x_qv"] = window_mean(out["x_start"], out["x_end"])
    if need_bc:
        if is5p:
            out["bc_qv"] = window_mean(ae + 1, ae + bc_len)
        else:
            out["bc_qv"] = window_mean(ae - bc_len, ae - 1)
