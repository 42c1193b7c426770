"""The yardstick of the kernels' roofline shares: the card's peaks and the
work of a launch, reckoned from the arguments of the Python wrapper that
makes it. The unit of work is the problem's: input bytes read once, output
bytes written once, int32 operations a DP word or cell, so the same work
reads the same whatever implements it. Frozen from `chip_smoke.py` (its
`bound`, sweep and band counts) at commit 7793f5b; a later change to a
kernel does not move these counts.

Only kernels that run for milliseconds are reckoned: a launch's interval
runs from an event queued before it, so it holds the host's launch gap,
which is a few microseconds but most of a short kernel's interval (the
encode, the tile feed). Kernels whose work depends on the data beyond the
arguments' sizes (the edge scan, the tile scan) are not reckoned either.
Every launch counts in the device's busy time and in the breakdown.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, the published rate
# 132 SMs x 128 int32 lanes a clock (the ALU and FMA pipes, 16 lanes each of
# four schedulers) x 1.98 GHz, the card's top SM clock: fixed, so the
# yardstick does not move with the clock a run reads
INT32_OPS_PER_S = 132 * 128 * 1.98e9
MYERS_OPS = 18                      # a Myers bit-vector column
BAND_CELL_OPS = 13                  # a banded NW cell with its walk
K_INS = 4                           # insertion slots a band column


def bound_s(work: dict) -> float:
    """The least seconds the card could take for the work."""
    return max(work.get("bytes", 0) / HBM_BYTES_PER_S,
               work.get("ops", 0) / INT32_OPS_PER_S)


def bc_sweep(wins_tm, peq, nvalid, m, track_pos=True):
    """csrc/bcsweep.cu: every window column of every read against every
    valid barcode (a Myers column each); the windows and Peq read, the
    [4, B] rows written."""
    W, B = wins_tm.shape
    return {"ops": int(B) * int(nvalid) * int(W) * MYERS_OPS,
            "bytes": wins_tm.numel() * wins_tm.element_size()
            + peq.numel() * peq.element_size() + 4 * B * 4}


def band_align(reads, rlens, mids, centers_mol, clens_mol, Lc, W):
    """csrc/bandalign.cu: W band cells a center column of every pair; the
    pairs' reads, lengths and molecule rows, the centers read; the aligned
    rows, insertion slots and feasibility written."""
    P = int(reads.shape[0])
    if P == 0:
        return None
    n_in = sum(t.numel() * t.element_size()
               for t in (reads, rlens, mids, centers_mol, clens_mol))
    return {"ops": clens_mol.long()[mids.long()].sum() * W * BAND_CELL_OPS,
            "bytes": n_in + P * (Lc + 1) * (1 + 4 * K_INS) + 4 * P}


# kernel name at the launch site -> (wrapper where its callers look it up,
# work of one call)
WORK = {
    "bcsweep": ("sicelore_tpu_torch.ops.bcsearch:bc_sweep", bc_sweep),
    "bandalign": ("sicelore_tpu_torch.ops.poa_cuda:band_align", band_align),
}
