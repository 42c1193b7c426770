"""Cell-barcode whitelist sweep: CUDA kernel (csrc/bcsweep.cu), its plain
PyTorch version and the `bc_search` host wrapper.

Port of `sicelore_tpu/ops/bcsearch.py`: every read's BC window against every
used barcode (Myers semi-global ED), reduced to [4, B] int32 rows best_ed,
best_idx (first argmin), second_ed (BIG when no second barcode) and the best
match's end position (-1 unless track_pos). Barcode lanes >= nvalid count as
BIG. The q-gram prefilter search is not ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.ops import _build, editdist

BIG = 2**30  # masked lanes / no second barcode
PLAIN_CHUNK = 1 << 26   # max (read, barcode) pairs per plain sweep step


def bc_sweep_plain(wins_tm: torch.Tensor, peq: torch.Tensor, nvalid: int,
                   m: int, track_pos: bool = True) -> torch.Tensor:
    """Plain PyTorch sweep: wins_tm [W, B] codes, peq [4, N] Peq (int32 bit
    pattern) -> [4, B] int32. Runs in read chunks of <= PLAIN_CHUNK pairs."""
    bc_sweep_plain.launches += 1
    W, B = wins_tm.shape
    N = peq.shape[1]
    dev = wins_tm.device
    peq64 = peq.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    cols = torch.arange(N, device=dev)[None, :]
    step = max(1, PLAIN_CHUNK // max(N, 1))
    for b0 in range(0, B, step):
        w = wins_tm[:, b0:b0 + step].t()
        ed, pos = editdist.myers_sweep(w, peq64, m)
        ed = torch.where(cols < nvalid, ed, BIG)
        b1, i1 = torch.min(ed, dim=1)
        b2 = torch.where(cols == i1[:, None], BIG, ed).min(dim=1).values
        if track_pos:
            p1 = pos.gather(1, i1[:, None])[:, 0]
            p1 = torch.where(b1 >= BIG, -1, p1)   # nothing valid was seen
        else:
            p1 = torch.full_like(b1, -1)
        out[:, b0:b0 + step] = torch.stack([b1, i1.to(torch.int32), b2, p1])
    return out


bc_sweep_plain.launches = 0


def bc_sweep(wins_tm: torch.Tensor, peq: torch.Tensor, nvalid: int, m: int,
             track_pos: bool = True) -> torch.Tensor:
    """Whitelist sweep of text-major BC windows wins_tm [W, B] uint8 against
    peq [4, N] int32 (uint32 Peq bit patterns) -> [4, B] int32 rows."""
    if wins_tm.device.type == "cpu":
        return bc_sweep_plain(wins_tm, peq, nvalid, m, track_pos)
    W, B = wins_tm.shape
    if wins_tm.dtype != torch.uint8 or not wins_tm.is_contiguous():
        raise ValueError("wins_tm must be contiguous uint8 [W, B]")
    if (peq.dtype != torch.int32 or peq.dim() != 2 or peq.shape[0] != 4
            or peq.device != wins_tm.device or not peq.is_contiguous()):
        raise ValueError("peq must be contiguous int32 [4, N] on wins' device")
    if W > 32 or not 1 <= m <= 31:
        raise ValueError(f"sweep kernel takes W <= 32 and m <= 31 "
                         f"(got W={W}, m={m})")
    out = torch.empty((4, B), dtype=torch.int32, device=wins_tm.device)
    if B == 0:
        return out
    fn = _build.bind("bcsweep", "bcsweep_launch", 3, 6)
    _build.check(fn(wins_tm.data_ptr(), peq.data_ptr(), out.data_ptr(),
                    B, W, peq.shape[1], int(nvalid), m, int(track_pos),
                    _build.stream_handle(wins_tm.device)), "bcsweep")
    bc_sweep.launches += 1
    return out


bc_sweep.launches = 0


def peq_device(peq: np.ndarray, device) -> torch.Tensor:
    """uint32 Peq [4, N] -> contiguous int32 bit-pattern tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(
        peq, dtype=np.uint32).view(np.int32)).to(device)


def bc_search(windows: np.ndarray, patterns_peq: np.ndarray, n_patterns: int,
              m: int, device="cpu"):
    """Host wrapper: windows [B, W] codes against the first n_patterns
    columns of patterns_peq [4, N] uint32.

    Returns dict of int64 numpy arrays (len B): ed, idx, ed2, end_pos.
    idx/end_pos are valid only where ed < m; ed2 == editdist.INT_MAX when no
    second candidate exists (mirrors the reference's ed_sec=INTMAX)."""
    wins = torch.from_numpy(np.ascontiguousarray(
        np.asarray(windows).T, dtype=np.uint8)).to(device)
    peq = peq_device(patterns_peq[:, :max(n_patterns, 1)], device)
    out = bc_sweep(wins, peq, n_patterns, m, track_pos=True).cpu().numpy()
    out = out.astype(np.int64)
    ed2 = np.where(out[2] >= BIG, editdist.INT_MAX, out[2])
    return {"ed": out[0], "idx": out[1], "ed2": ed2, "end_pos": out[3]}
