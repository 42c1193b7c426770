"""Cell-barcode whitelist sweep: CUDA kernels (csrc/bcsweep.cu: the sweep
over a reads x barcode-slices grid and the merge of the slices), their plain
PyTorch versions and the `bc_search` host wrapper.

Port of `sicelore_tpu/ops/bcsearch.py`: every read's BC window against every
used barcode (Myers semi-global ED), reduced to [4, B] int32 rows best_ed,
best_idx (first argmin), second_ed (BIG when no second barcode) and the best
match's end position (-1 unless track_pos). Barcode lanes >= nvalid count as
BIG. `qgram_prefilter_search` is the candidate-pruned search for very large
used lists: one matrix product, a top-K and a Myers verify of the K
candidates, all torch ops (it runs no Pallas kernel in the JAX package
either).
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch import device as _device
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


def merge_sweep_partials_plain(parts: torch.Tensor) -> torch.Tensor:
    """Fold per-slice sweep partials [S, 4, B] (rows best_ed, best_idx with
    global barcode indices, second_ed, end position) into [4, B], slices in
    ascending order, by the rule of the sweep kernel's merge (the JAX
    kernel's between its barcode tiles): the earlier slice keeps a tie; the
    second best is the least of the losing best and both second bests. The
    oracle of the merge kernel; never on the main path."""
    b1, i1, b2, p1 = parts[0].unbind(0)
    for s in range(1, parts.shape[0]):
        nb1, ni1, nb2, np1 = parts[s].unbind(0)
        take = nb1 < b1
        b2 = torch.minimum(torch.maximum(b1, nb1), torch.minimum(b2, nb2))
        i1 = torch.where(take, ni1, i1)
        p1 = torch.where(take, np1, p1)
        b1 = torch.minimum(b1, nb1)
    return torch.stack([b1, i1, b2, p1])


def merge_sweep_partials(parts: torch.Tensor) -> torch.Tensor:
    """`merge_sweep_partials_plain` for CPU tensors; for CUDA tensors the
    merge kernel of csrc/bcsweep.cu alone (the sweep launches it itself)."""
    if parts.device.type == "cpu":
        return merge_sweep_partials_plain(parts)
    if (parts.dtype != torch.int32 or parts.dim() != 3 or parts.shape[1] != 4
            or parts.shape[0] < 1 or not parts.is_contiguous()):
        raise ValueError("parts must be contiguous int32 [S >= 1, 4, B]")
    S, _, B = parts.shape
    out = torch.empty((4, B), dtype=torch.int32, device=parts.device)
    fn = _build.bind("bcsweep", "bcsweep_merge_launch", 2, 2)
    _build.launch(fn, "bcsweep merge", parts.device, parts.data_ptr(),
                  out.data_ptr(), S, B)
    return out


SWEEP_THREADS = 128      # reads a block (csrc/bcsweep.cu THREADS)
SWEEP_CHAINS = 4         # barcodes a thread at a time (CH)
SWEEP_BLOCKS_PER_SM = 24  # blocks a launch aims at: ~3 waves of 8 an SM
SWEEP_MIN_SLICE = 128    # fewer barcodes a block are not worth a slice


def _slice_grid(nvalid: int, N: int, slices: int) -> tuple[int, int]:
    """(S, L) for a wanted slice count: it is cut to what the list can fill,
    L is a multiple of 4, the last slice may be short and none is empty."""
    nv = min(max(int(nvalid), 0), N)
    S = max(1, min(int(slices), -(-nv // SWEEP_CHAINS), 65535))
    L = -(-max(nv, 1) // S)
    L = -(-L // SWEEP_CHAINS) * SWEEP_CHAINS
    return max(1, -(-nv // L)), L


def sweep_slices(B: int, nvalid: int, N: int, sms: int) -> tuple[int, int]:
    """(S, L): the sweep's grid is ceil(B / 128) read blocks x S slices of L
    barcodes. S is chosen so that the launch holds ~24 blocks an SM whatever
    B is, and is 1 where the reads alone give that many."""
    nv = min(max(int(nvalid), 0), N)
    read_blocks = -(-B // SWEEP_THREADS)
    return _slice_grid(
        nvalid, N, min(-(-SWEEP_BLOCKS_PER_SM * sms // max(read_blocks, 1)),
                       nv // SWEEP_MIN_SLICE))


def _bc_sweep_sliced(wins_tm: torch.Tensor, peq: torch.Tensor, nvalid: int,
                     m: int, track_pos: bool, slices: int | None
                     ) -> torch.Tensor:
    """`bc_sweep` on CUDA tensors with the number of barcode slices of the
    kernel's grid asked for (None: chosen from B, N and the card). The result
    does not depend on it, which is what the kernel's tests hold."""
    W, B = wins_tm.shape
    if wins_tm.dtype != torch.uint8 or not wins_tm.is_contiguous():
        raise ValueError("wins_tm must be contiguous uint8 [W, B]")
    if (peq.dtype != torch.int32 or peq.dim() != 2 or peq.shape[0] != 4
            or peq.shape[1] < 1 or peq.device != wins_tm.device
            or not peq.is_contiguous()):
        raise ValueError("peq must be contiguous int32 [4, N >= 1] on wins' "
                         "device")
    if not 1 <= W <= 32 or not 1 <= m <= 31:
        raise ValueError(f"sweep kernel takes 1 <= W <= 32 and 1 <= m <= 31 "
                         f"(got W={W}, m={m})")
    dev = wins_tm.device
    out = torch.empty((4, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    N = peq.shape[1]
    if slices is None:
        S, L = sweep_slices(B, nvalid, N, torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    else:
        S, L = _slice_grid(nvalid, N, slices)
    scratch = (torch.empty((S, 4, B), dtype=torch.int32, device=dev)
               if S > 1 else out)
    fn = _build.bind("bcsweep", "bcsweep_launch", 4, 8)
    _build.launch(fn, "bcsweep", dev, wins_tm.data_ptr(), peq.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), B, W, N, int(nvalid), m,
                  int(track_pos), S, L)
    bc_sweep.launches += 1
    return out


def bc_sweep(wins_tm: torch.Tensor, peq: torch.Tensor, nvalid: int, m: int,
             track_pos: bool = True) -> torch.Tensor:
    """Whitelist sweep of text-major BC windows wins_tm [W, B] uint8 against
    peq [4, N] int32 (uint32 Peq bit patterns) -> [4, B] int32 rows."""
    if wins_tm.device.type == "cpu":
        return bc_sweep_plain(wins_tm, peq, nvalid, m, track_pos)
    return _bc_sweep_sliced(wins_tm, peq, nvalid, m, track_pos, None)


bc_sweep.launches = 0


def peq_device(peq: np.ndarray, device) -> torch.Tensor:
    """uint32 Peq [4, N] -> contiguous int32 bit-pattern tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(
        peq, dtype=np.uint32).view(np.int32)).to(device)


def bc_search(windows: np.ndarray, patterns_peq: np.ndarray, n_patterns: int,
              m: int, device="cuda"):
    """Host wrapper: windows [B, W] codes against the first n_patterns
    columns of patterns_peq [4, N] uint32, on `device` ("cuda" without a
    GPU raises).

    Returns dict of int64 numpy arrays (len B): ed, idx, ed2, end_pos.
    idx/end_pos are valid only where ed < m; ed2 == editdist.INT_MAX when no
    second candidate exists (mirrors the reference's ed_sec=INTMAX)."""
    device = _device.resolve(device)
    wins = torch.from_numpy(np.ascontiguousarray(
        np.asarray(windows).T, dtype=np.uint8)).to(device)
    peq = peq_device(patterns_peq[:, :max(n_patterns, 1)], device)
    out = bc_sweep(wins, peq, n_patterns, m, track_pos=True).cpu().numpy()
    out = out.astype(np.int64)
    ed2 = np.where(out[2] >= BIG, editdist.INT_MAX, out[2])
    return {"ed": out[0], "idx": out[1], "ed2": ed2, "end_pos": out[3]}


# ---------------------------------------------------------------------------
# q-gram prefilter search (large used lists)
# ---------------------------------------------------------------------------
#
# By the q-gram lemma (Ukkonen), ED(pattern, s) <= k implies that pattern and
# s share at least (m - q + 1) - q*k q-grams. With q = 4 the 256-dim 4-gram
# count vectors of the read window and of every barcode turn "shared >= T"
# into one [B, 256] x [256, N] product: dot(counts_w, counts_b) >= the bag
# intersection, so dot < T proves ED > k (no false negatives; false
# positives are verified). Only the K best-scoring candidates of a read run
# the exact Myers verify: results are exact within `radius`, and ed/ed2
# beyond it report not-found.
QGRAM_Q = 4


def build_qgram_table(patterns: np.ndarray) -> np.ndarray:
    """[N, m] int8 barcode codes (all < 4) -> [256, N] float32 4-gram
    counts, the right operand of the prefilter product."""
    N, m = patterns.shape
    ng = m - QGRAM_Q + 1
    out = np.zeros((256, N), np.float32)
    ids = np.zeros((N, ng), np.int32)
    for i in range(QGRAM_Q):
        ids = (ids << 2) | np.minimum(patterns[:, i:ng + i], 3).astype(np.int32)
    cols = np.broadcast_to(np.arange(N)[:, None], ids.shape)
    np.add.at(out, (ids.ravel(), cols.ravel()), 1.0)
    return out


def qgram_threshold(m: int, radius: int) -> int:
    """Minimal shared-4-gram count compatible with ED <= radius."""
    return (m - QGRAM_Q + 1) - QGRAM_Q * radius


def qgram_prefilter_search(windows: torch.Tensor, qgram_t: torch.Tensor,
                           peq: torch.Tensor, nvalid: int, m: int,
                           radius: int, K: int = 64) -> torch.Tensor:
    """Candidate-pruned barcode search, exact within `radius`.

    windows [B, W] int8; qgram_t [256, N] float32 (build_qgram_table); peq
    [4, N] Peq bit patterns (int32 or int64); lanes >= nvalid never match.
    Returns [5, B] int32 (best_ed, best_idx, second_ed, best_end_pos,
    overflow): best/second are BIG when no barcode lies within `radius`;
    ties pick the lowest index (as the brute sweep does). overflow[b] = 1
    when more than K candidates passed the q-gram threshold: the caller must
    re-run those reads through the exact sweep.

    The scores are float32 products of small integer counts (a window holds
    at most W - 3 4-grams, a barcode m - 3), so every score is an integer
    far below 2^24 and exact, as it is in the JAX package's bfloat16 x
    bfloat16 -> float32 product. The K candidates are the top-K of an int32
    key that orders by score and then by the lower index, so which
    candidates are verified does not depend on `torch.topk`'s tie order."""
    B, W = windows.shape
    N = qgram_t.shape[1]
    dev = windows.device
    T = qgram_threshold(m, radius)
    Kk = min(K, N)
    if (W - QGRAM_Q + 2) * (m - QGRAM_Q + 2) * N >= 2**31:
        raise ValueError(f"used list of {N} barcodes overflows the int32 "
                         f"candidate key")
    if isinstance(peq, np.ndarray):
        peq = torch.from_numpy(peq.astype(np.int64))
    peq64 = peq.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    peq6 = editdist.peq_tensor(peq64, dev)                      # [6, N]
    lane = torch.arange(N, device=dev, dtype=torch.int32)[None, :]
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    step = max(1, PLAIN_CHUNK // max(N, 1))
    for b0 in range(0, B, step):
        w = windows[b0:b0 + step].long()
        nb = w.shape[0]
        ng = W - QGRAM_Q + 1
        ids = torch.zeros((nb, ng), dtype=torch.int64, device=dev)
        ok = torch.ones((nb, ng), dtype=torch.bool, device=dev)
        for i in range(QGRAM_Q):
            c = w[:, i:ng + i]
            ok &= c < 4
            ids = (ids << 2) | c.clamp(max=3)
        counts = torch.zeros((nb, 256), dtype=torch.float32, device=dev)
        counts.scatter_add_(1, ids, ok.to(torch.float32))
        scores = torch.matmul(counts, qgram_t).to(torch.int32)  # [nb, N]
        scores = torch.where(lane < nvalid, scores, -1)
        overflow = ((scores >= T).sum(dim=1) > K).to(torch.int32)
        key = scores * N + (N - 1 - lane)
        top_i = torch.topk(key, Kk, dim=1).indices              # [nb, Kk]
        cand_ok = scores.gather(1, top_i) >= T

        # exact Myers verify of the candidates (a pattern set per read)
        peq_c = peq6[:, top_i].permute(1, 0, 2)                 # [nb, 6, Kk]
        rows = torch.arange(nb, device=dev)
        PV = torch.full((nb, Kk), (1 << m) - 1, dtype=torch.int64,
                        device=dev)
        MV = torch.zeros_like(PV)
        score = torch.full((nb, Kk), m, dtype=torch.int32, device=dev)
        ed = score.clone()
        pos = torch.full_like(score, -1)
        for t in range(W):
            eq = peq_c[rows, w[:, t]]
            PV, MV, score = editdist.hyyro_step(PV, MV, score, eq, m - 1, 0)
            improved = score < ed
            ed = torch.where(improved, score, ed)
            pos = torch.where(improved, t, pos)

        inrad = cand_ok & (ed <= radius)
        ed = torch.where(inrad, ed, BIG)
        gidx = torch.where(inrad, top_i.to(torch.int32), BIG)
        b1 = ed.min(dim=1).values
        i1 = torch.where(ed == b1[:, None], gidx, BIG).min(dim=1).values
        b2 = torch.where(gidx == i1[:, None], BIG, ed).min(dim=1).values
        p1 = torch.where(gidx == i1[:, None], pos, -1).max(dim=1).values
        out[:, b0:b0 + step] = torch.stack([b1, i1, b2, p1, overflow])
    return out
