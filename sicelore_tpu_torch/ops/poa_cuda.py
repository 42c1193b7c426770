"""Batched consensus engine: the band-alignment CUDA kernel's wrapper
(csrc/bandalign.cu), its plain PyTorch version, the per-molecule vote and
assembly steps, and the engine that buckets molecules and routes them.

Port of `sicelore_tpu/ops/poa_tpu.py`. Per molecule the center is the
longest cDNA and every other read forms a (center, read) pair; each pair is
aligned with banded Needleman-Wunsch (match +5 / mismatch -4 / gap -8) over
a diagonal band of W cells and walked back greedily (diag > vert > horiz)
into one aligned code per center column plus insertion votes; votes sum per
molecule and the majority assembly (ConsensusMsa semantics: agreement QV,
gap stripping) runs on the device.

`band_align` replaces the Pallas kernel `_band_align_kernel` together with
the record decoding `extract_alignments`. It runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises. The
contract per pair p (center = centers_mol[mids[p]]):

  aligned  [P, Lc+1] int8         0..3 read base on a diagonal move into
                                  column j (slot j-1), 4 deletion, 5 none
  ins      [P, Lc+1, K_INS, 4] i8 row j = insertions before center position
                                  j; offset o counts from the run's END; a
                                  run longer than K_INS piles its excess
                                  into the last offset
  feasible [P] int32              the pair's end cell lies in the band and
                                  was reached on a valid path

The routing of molecules is that of the JAX engine's production path and is
part of the result: 1- and 2-read molecules, centers over `max_center_len`,
molecules with a non-ACGT byte (when maxps <= 63), buckets with no surviving
pair and assemblies longer than Lc + Lc/8 + 16 (when maxps <= 63) get the
host engine's answer (`ops.poa.consensus_reads`); maxps > 63 runs band W =
`band` with no N screen and keeps every assembly, however long. Every
bucket assembles on the engine's device (`assemble_votes`: its QV is a
uint8 tensor of its own, so maxps has no 6-bit limit here). The 1- and
2-read molecules call the host engine; for the rest its pairwise alignments
run on the engine's device (`ops.hostnw_cuda`: csrc/hostnw.cu on the card)
and its merge and majority on the host, with the same bytes.

A mesh (a list of devices, `parallel.shard`) lives in the engine: each
sub-batch's pairs are cut at molecule boundaries into one run a device,
aligned and voted there, and the votes summed on the first device before
the assembly (`BatchedConsensusEngine._votes`); one device is a mesh of one.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from sicelore_tpu_torch import device as _device
from sicelore_tpu_torch.ops import _build, hostnw_cuda, poa
from sicelore_tpu_torch.parallel import shard
from sicelore_tpu_torch.utils import dna, trace

MATCH, MISMATCH, GAP = poa.MATCH, poa.MISMATCH, poa.GAP
NEG = -(10**7)
K_INS = 4
PAIRS_PER_CALL = 8192   # pairs per device sub-batch of one bucket
_ACGT = b"ACGTacgt"     # delete-set for the N/ambiguity screen
_ACGT_NP = np.frombuffer(b"ACGT", np.uint8)


def w_for(Lc: int) -> int:
    """Band width per center-length bucket: alignment drift grows ~sqrt(L),
    so short molecules ride a 32-cell band and longer ones a 64-cell band."""
    return 32 if Lc <= 512 else 64


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU tests, and the yardstick the kernel is held to)
# ---------------------------------------------------------------------------

def _align_pairs_plain(center: torch.Tensor, clens: torch.Tensor,
                       reads: torch.Tensor, rlens: torch.Tensor, W: int):
    """Banded forward pass + greedy traceback for P pairs, plain PyTorch.

    center [P, Lc] int8, clens [P], reads [P, Lr] int8, rlens [P]. Returns
    (aligned [P, Lc+1] int8, ins [P, Lc+1, K_INS, 4] int8, feasible [P]
    int32). All score arithmetic is int32 with the same clamp at NEG as the
    kernel, so the traceback's score equalities hold in the same cells."""
    P, Lc = center.shape
    Lr = reads.shape[1]
    dev = center.device
    W2 = W // 2
    clens = clens.to(torch.int64)
    rlens = rlens.to(torch.int64)
    aligned = torch.full((P, Lc + 1), 5, dtype=torch.int8, device=dev)
    ins = torch.zeros((P, Lc + 1, K_INS, 4), dtype=torch.int8, device=dev)
    if P == 0:
        return aligned, ins, torch.zeros(0, dtype=torch.int32, device=dev)
    bidx = torch.arange(W, device=dev)
    bg = (bidx * GAP).to(torch.int32)[None, :]
    neg_col = torch.full((P, 1), NEG, dtype=torch.int32, device=dev)

    # ---- forward ----
    i0 = bidx - W2
    f = torch.where((i0 >= 0)[None, :] & (i0[None, :] <= rlens[:, None]),
                    (i0 * GAP)[None, :], NEG).to(torch.int32)
    F = torch.empty((P, Lc + 1, W), dtype=torch.int32, device=dev)
    F[:, 0] = f
    jmax = min(int(clens.max()), Lc)
    for j in range(1, jmax + 1):
        i = j + bidx - W2
        cb = center[:, j - 1][:, None]
        rb = reads[:, (i - 1).clamp(0, Lr - 1)]
        s = torch.where((cb == rb) & (cb < 4), MATCH, MISMATCH)
        valid = (i >= 1)[None, :] & (i[None, :] <= rlens[:, None])
        s = torch.where(valid, s, NEG).to(torch.int32)
        fn = torch.maximum(f + s, torch.cat([f[:, 1:], neg_col], 1) + GAP)
        # within-column closure: f[b] = max_k<=b f[k] + (b-k)*GAP
        t = torch.cummax(fn - bg, dim=1).values
        fn = torch.maximum(fn, t + bg).clamp_min(NEG)
        # columns beyond this pair's center length keep the previous state
        f = torch.where(j <= clens[:, None], fn, f)
        F[:, j] = f
    F[:, jmax + 1:] = f[:, None, :]

    # ---- greedy traceback, one move a step (diag > vert > horiz) ----
    bt = rlens - clens + W2
    pidx = torch.arange(P, device=dev)
    b = bt.clamp(0, W - 1)
    total = F[pidx, clens.clamp(0, Lc), b]
    feasible = (bt >= 0) & (bt < W) & (total > NEG // 2)
    j = clens.clone()
    run = torch.zeros(P, dtype=torch.int64, device=dev)
    stuck = torch.zeros(P, dtype=torch.bool, device=dev)
    # a path has clen column moves and at most clen + W horizontal ones
    for step in range(2 * Lc + W + 8):
        active = feasible & ~stuck & ((j > 0) | (b > W2))
        if step % 32 == 0 and not bool(active.any()):
            break
        i = j + b - W2
        F_cur = F[pidx, j, b]
        jm = (j - 1).clamp(0, Lc)
        cb = center[pidx, (j - 1).clamp(0, Lc - 1)]
        inread = (i >= 1) & (i <= rlens)
        rb = reads[pidx, (i - 1).clamp(0, Lr - 1)]
        sub = torch.where((cb == rb) & (cb < 4), MATCH, MISMATCH)
        # the voted base: N counts as T, a char outside the read as T
        rb = torch.where(inread, rb.clamp(0, 3), 3).to(torch.int64)
        diag = (active & (j > 0) & inread
                & (F_cur == F[pidx, jm, b] + sub))
        vert = (active & ~diag & (j > 0) & (b + 1 < W)
                & (F_cur == F[pidx, jm, (b + 1).clamp(0, W - 1)] + GAP))
        horiz = active & ~diag & ~vert & (b > 0)
        col = diag | vert
        aligned[pidx[col], jm[col]] = torch.where(
            diag, rb, 4).to(torch.int8)[col]
        # a horizontal move consumes read char i (insertion before center
        # position j); offsets count from the run's end
        o = run.clamp(max=K_INS - 1)
        ins[pidx[horiz], j[horiz], o[horiz], rb[horiz]] += 1
        stuck = stuck | (active & ~col & ~horiz)
        j = j - col.to(torch.int64)
        b = b + vert.to(torch.int64) - horiz.to(torch.int64)
        run = torch.where(horiz, run + 1, 0)
    return aligned, ins, feasible.to(torch.int32)


def band_align_plain(reads, rlens, mids, centers_mol, clens_mol, Lc: int,
                     W: int):
    """`band_align` in plain PyTorch (gathers each pair's center by mids)."""
    band_align_plain.launches += 1
    m = mids.to(torch.int64)
    return _align_pairs_plain(centers_mol[m], clens_mol[m], reads, rlens, W)


band_align_plain.launches = 0


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def band_align(reads: torch.Tensor, rlens: torch.Tensor, mids: torch.Tensor,
               centers_mol: torch.Tensor, clens_mol: torch.Tensor, Lc: int,
               W: int):
    """Align P (center, read) pairs. reads [P, Lc+W] int8 codes (anything
    beyond rlens is ignored), rlens [P] int32, mids [P] int32 molecule row of
    each pair, centers_mol [M, Lc] int8, clens_mol [M] int32. Returns
    (aligned, ins, feasible) as the module docstring sets out."""
    P = reads.shape[0]
    if (reads.dim() != 2 or reads.shape[1] != Lc + W or centers_mol.dim() != 2
            or centers_mol.shape[1] != Lc):
        raise ValueError(f"reads must be [P, {Lc + W}] and centers_mol "
                         f"[M, {Lc}], got {tuple(reads.shape)} and "
                         f"{tuple(centers_mol.shape)}")
    if rlens.shape != (P,) or mids.shape != (P,) or \
            clens_mol.shape != (centers_mol.shape[0],):
        raise ValueError("rlens and mids must be [P], clens_mol [M]")
    if reads.device.type == "cpu":
        return band_align_plain(reads, rlens, mids, centers_mol, clens_mol,
                                Lc, W)
    dev = reads.device
    if W not in (32, 64) or Lc % 16 or Lc < 16:
        raise NotImplementedError(
            f"band kernel takes W in (32, 64) and Lc a multiple of 16 "
            f"(W={W}, Lc={Lc})")
    for name, t, dt in (("reads", reads, torch.int8),
                        ("centers_mol", centers_mol, torch.int8),
                        ("rlens", rlens, torch.int32),
                        ("mids", mids, torch.int32),
                        ("clens_mol", clens_mol, torch.int32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")
    if reads.data_ptr() % 16 or centers_mol.data_ptr() % 16:
        raise ValueError("reads and centers_mol must be 16-byte aligned")
    aligned = torch.empty((P, Lc + 1), dtype=torch.int8, device=dev)
    ins = torch.empty((P, Lc + 1, K_INS, 4), dtype=torch.int8, device=dev)
    feasible = torch.empty((P,), dtype=torch.int32, device=dev)
    if P == 0:
        return aligned, ins, feasible
    fn = _build.bind("bandalign", "bandalign_launch", 8, 4)
    _build.launch(fn, "bandalign", dev, reads.data_ptr(), rlens.data_ptr(),
                  mids.data_ptr(), centers_mol.data_ptr(),
                  clens_mol.data_ptr(), aligned.data_ptr(), ins.data_ptr(),
                  feasible.data_ptr(), P, centers_mol.shape[0], Lc, W)
    band_align.launches += 1
    return aligned, ins, feasible


band_align.launches = 0


# ---------------------------------------------------------------------------
# votes and assembly (plain PyTorch on the device, as XLA code in the JAX
# package)
# ---------------------------------------------------------------------------

def segment_votes(aligned, ins, feasible, mids, M: int):
    """Per-pair alignments -> per-molecule votes.

    aligned [P, Lc+1] (0..3 base / 4 del / 5 none), ins [P, Lc+1, K_INS, 4],
    feasible [P], mids [P] segment ids < M. Returns (cv [M, Lc, 5] int32,
    iv [M, Lc+1, K_INS, 4] int32, pc [M] int32)."""
    P, Lc1 = aligned.shape
    Lc = Lc1 - 1
    dev = aligned.device
    m = mids.to(torch.int64)
    ch5 = torch.arange(5, dtype=aligned.dtype, device=dev)
    cv = torch.zeros((M, Lc, 5), dtype=torch.int32, device=dev)
    cv.index_add_(0, m, (aligned[:, :Lc, None] == ch5).to(torch.int32))
    iv = torch.zeros((M, Lc1, K_INS, 4), dtype=torch.int32, device=dev)
    iv.index_add_(0, m, ins.to(torch.int32))
    pc = torch.zeros((M,), dtype=torch.int32, device=dev)
    pc.index_add_(0, m, feasible.to(torch.int32))
    return cv, iv, pc


def qv_table(maxps: int, rmax: int) -> np.ndarray:
    """Agreement QV of `win` votes out of `R`, as a [rmax+1, rmax+1] uint8
    table indexed [win, R]: rint(-10 log10(1 - win/R)) capped at maxps, and
    maxps at full agreement. Built on the host so that no device log10
    decides a rounding."""
    win = np.arange(rmax + 1, dtype=np.float64)[:, None]
    R = np.maximum(np.arange(rmax + 1, dtype=np.float64), 1.0)[None, :]
    frac = win / R
    q = np.rint(-10 * np.log10(np.maximum(1.0 - frac, 1e-9)))
    q = np.where(frac >= 1.0, maxps, np.minimum(q, maxps))
    return q.astype(np.uint8)


def assemble_votes(cv, iv, pc, centers_mol, clens_mol, maxps: int):
    """Per-molecule votes -> compacted consensus, on the device.

    cv [M, Lc, 5] int32, iv [M, Lc+1, K_INS, 4] int32, pc [M] (from
    segment_votes), centers_mol [M, Lc] int8, clens_mol [M]. Returns
    (codes uint8 [sum(out_len)], qv uint8 [sum(out_len)], out_len [M]
    int64): the kept slots of all molecules one after the other. Slot order
    per center row j: the K_INS insertion slots (offset descending), then
    the base slot; majority-deletion columns are dropped."""
    M, Lc = cv.shape[:2]
    dev = cv.device
    K = K_INS
    clen = clens_mol.to(torch.int64)
    R = pc.to(torch.int64) + 1                     # the center votes too
    cmask = torch.arange(Lc, device=dev)[None, :] < clen[:, None]
    ch5 = torch.arange(5, device=dev)
    conh = ((centers_mol.to(torch.int64).clamp(max=4)[..., None] == ch5)
            & cmask[..., None])
    cv = cv + conh.to(torch.int32)
    bw, bb = cv.max(dim=2)                         # first maximum wins
    keep_base = (bb != 4) & cmask
    # insertion slots: the top base wins iff it beats the gap votes
    ivw, ib = iv.max(dim=3)                        # [M, Lc+1, K]
    rmask = torch.arange(Lc + 1, device=dev)[None, :] <= clen[:, None]
    ikeep = ((ivw > (R[:, None, None] - iv.sum(dim=3))) & (ivw > 0)
             & rmask[..., None])
    zcol = torch.zeros((M, 1), dtype=torch.int64, device=dev)
    code = torch.cat([ib.flip(2), torch.cat([bb, zcol], 1)[..., None]], 2)
    win = torch.cat([ivw.flip(2).to(torch.int64),
                     torch.cat([bw.to(torch.int64), zcol], 1)[..., None]], 2)
    keep = torch.cat([ikeep.flip(2),
                      torch.cat([keep_base, zcol.bool()], 1)[..., None]], 2)
    rmax = int(R.max()) if M else 1
    table = torch.from_numpy(qv_table(maxps, rmax)).to(dev)
    q = table[win.clamp(max=rmax), R[:, None, None].expand_as(win)]
    keep = keep.reshape(M, -1)
    out_len = keep.sum(dim=1)
    # row-major boolean selection keeps each molecule's slots in order
    codes = code.reshape(M, -1)[keep].clamp(max=3).to(torch.uint8)
    return codes, q.reshape(M, -1)[keep], out_len


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class BatchedConsensusEngine:
    """Bucketed molecule batches -> device alignment + assembly -> strings.

    Call with a list of per-molecule read lists; returns [(cons, qv)] in
    order, matching ops.poa.consensus_reads dispatch (1 read -> itself,
    2 -> longest, >= 3 -> MSA consensus)."""

    def __init__(self, maxreads: int = 20, band: int = 64,
                 max_center_len: int = 2048, device="cuda", mesh=None):
        """`band` only affects the maxps > 63 route; otherwise the band
        derives from the center-length bucket (w_for). `mesh`: a list of
        devices (`parallel.shard`): each sub-batch's pairs are split across
        it at molecule boundaries, and the votes are summed on its first
        device before the assembly (`_votes`); the results are those of one
        device."""
        self.band = band
        self.maxreads = maxreads
        self.max_center_len = max_center_len
        self.mesh = None if mesh is None else shard.resolve_mesh(mesh, device)
        self.device = self.mesh[0] if self.mesh else _device.resolve(device)

    def __call__(self, molecules: list[list[bytes]], minps: int = 3,
                 maxps: int = 20, refine: bool = False):
        """refine=True runs a second alignment pass with the first-pass
        consensus as the center (every read realigns to it and re-votes)."""
        results = self._one_pass(molecules, minps, maxps, None)
        if not refine:
            return results
        centers_map = {}
        for mi, seqs in enumerate(molecules):
            if len(seqs) > 2 and results[mi] is not None:
                c = results[mi][0]
                if len(c) and len(c) <= self.max_center_len:
                    centers_map[mi] = c
        if centers_map:
            refined = self._one_pass(molecules, minps, maxps, centers_map)
            for mi in centers_map:
                results[mi] = refined[mi]
        return results

    def _one_pass(self, molecules, minps, maxps, centers_map):
        """One alignment pass. Each molecule first gets its route, then
        the host engine's answer is made for each host route at once (the
        short route by the host engine itself, routes n and long through
        one launch of the host engine's alignment, `_host_aligned`), and
        the rest go through the buckets (their nopair and overflow
        molecules through one more such launch); results are stored by
        molecule, so the order of the routes does not change them. Routes
        (the `consensus.molecules` counter of the program's tracer, by
        `route`; `refine` in the second pass): short (1-2 reads), long (a
        center over max_center_len), n (a non-ACGT byte, when maxps <= 63),
        nopair (a bucket with no pair left), overflow (an assembly longer
        than the device route's output row, when maxps <= 63) and device.
        Counter `consensus.pairs` by `Lc`: the pairs each bucket sends to the
        device (those the band's length rule keeps)."""
        results: list = [None] * len(molecules)
        # maxps <= 63 (the JAX engine's Pallas route): band by bucket, N
        # screen, overflow to the host engine; above (its jnp route): band
        # = self.band, no N screen, every assembly kept
        bucketed = maxps <= 63
        tag = {} if centers_map is None else {"refine": True}
        host: dict[str, list[int]] = {r: [] for r in (
            "short", "n", "long", "nopair", "overflow")}
        buckets: dict[int, list[int]] = defaultdict(list)
        with trace.span("consensus.route", **tag):
            for mi, seqs in enumerate(molecules):
                if centers_map is not None and mi not in centers_map:
                    continue
                if len(seqs) <= 2:
                    host["short"].append(mi)
                    continue
                c = (len(centers_map[mi]) if centers_map is not None
                     else max(len(s) for s in seqs))
                # centers beyond the largest bucket and N-containing
                # molecules take the host engine
                if c > self.max_center_len:
                    host["long"].append(mi)
                elif bucketed and any(s.translate(None, _ACGT) for s in seqs):
                    host["n"].append(mi)
                else:
                    buckets[max(256, 1 << (c - 1).bit_length())].append(mi)
        self._host(molecules, results, host["short"], "short", minps, maxps,
                   tag)
        self._host_aligned(molecules, results, host, ("n", "long"), maxps,
                           tag)
        batch = 0
        for Lc, idxs in buckets.items():
            W = w_for(Lc) if bucketed else self.band
            with trace.span("consensus.pack", Lc=Lc, W=W,
                            molecules=len(idxs), **tag) as sp:
                built = self._build_bucket(molecules, idxs, Lc, W,
                                           centers_map)
                info, centers, clens, reads, rlens, mol_ids = built
                cuts = list(self._sub_batches(mol_ids, len(info)))
                if trace.ON:
                    sp.set(pairs=len(centers))
                    offered = sum(R for _, _, R in info) - (
                        0 if centers_map is not None else len(info))
                    trace.count("consensus.pairs_dropped",
                                offered - len(centers), **tag)
                    trace.count("consensus.pairs", len(centers), Lc=Lc,
                                **tag)
            if not centers:
                host["nopair"] += [mi for mi, _, _ in info]
                continue
            for m0, m1, p0, p1 in cuts:
                host["overflow"] += self._run_batch(
                    results, info[m0:m1], reads[p0:p1], rlens[p0:p1],
                    mol_ids[p0:p1], m0, Lc, W, maxps, bucketed, batch, tag)
                batch += 1
        self._host_aligned(molecules, results, host, ("nopair", "overflow"),
                           maxps, tag)
        if trace.ON:
            for route, idxs in host.items():
                trace.count("consensus.molecules", len(idxs), route=route,
                            **tag)
            trace.count("consensus.molecules", sum(map(len, buckets.values()))
                        - len(host["nopair"]) - len(host["overflow"]),
                        route="device", **tag)
        return results

    @staticmethod
    def _host(molecules, results, idxs, route, minps, maxps, tag):
        """The host engine on the molecules `idxs` of one route (the 1- and
        2-read molecules): one `consensus.host` span."""
        if not idxs:
            return
        reads = 0
        with trace.span("consensus.host", route=route, molecules=len(idxs),
                        **tag) as sp:
            for mi in idxs:
                results[mi] = poa.consensus_reads(molecules[mi], minps,
                                                  maxps)
                reads += len(molecules[mi])
            sp.set(reads=reads)

    def _host_aligned(self, molecules, results, host, routes, maxps, tag):
        """The host engine's answer for the molecules of `routes` (three or
        more reads each): their center-star rows from pairwise alignments on
        this engine's device, all routes' pairs in one launch
        (`hostnw_cuda.CenterStar`), then the host's majority
        (`poa.consensus_from_msa`). One `consensus.host` span a route; the
        pack, the launch, the download and the rows lie in the first
        route's. Counter `consensus.host_pairs` by `route` and `where`
        (`card`, or `host` on a CPU device)."""
        routes = [r for r in routes if host[r]]
        star = None
        m = 0
        for route in routes:
            idxs = host[route]
            reads = 0
            with trace.span("consensus.host", route=route,
                            molecules=len(idxs), **tag) as sp:
                if star is None:
                    star = hostnw_cuda.CenterStar(
                        [molecules[mi] for r in routes for mi in host[r]],
                        self.device)
                for mi in idxs:
                    results[mi] = poa.consensus_from_msa(star.rows(m), maxps)
                    reads += len(molecules[mi])
                    m += 1
                sp.set(reads=reads)
                if trace.ON:
                    p0, p1 = np.searchsorted(star.pair_mol,
                                             [m - len(idxs), m])
                    trace.count("consensus.host_pairs", int(p1 - p0),
                                route=route, where=star.where, **tag)

    def _build_bucket(self, molecules, idxs, Lc, W, centers_map=None):
        """Pack one bucket's pair batch.

        With centers_map the given consensus is the center and EVERY read
        forms a pair (refine pass); otherwise the longest read is the
        center and the others pair against it."""
        centers, clens, reads, rlens, mol_ids = [], [], [], [], []
        info = []  # per molecule in bucket: (mi, center_seq, R)
        for m_local, mi in enumerate(idxs):
            seqs = molecules[mi]
            if centers_map is not None:
                cseq = centers_map[mi]
                ci = -1
            else:
                ci = max(range(len(seqs)), key=lambda i: len(seqs[i]))
                cseq = seqs[ci]
            info.append((mi, cseq, len(seqs)))
            for r, s in enumerate(seqs):
                if r == ci:
                    continue
                # drop reads whose length diff exceeds the band
                if abs(len(s) - len(cseq)) >= W // 2 - 4:
                    continue
                centers.append(cseq)
                clens.append(len(cseq))
                reads.append(s[:Lc + W])
                rlens.append(len(s[:Lc + W]))
                mol_ids.append(m_local)
        return info, centers, clens, reads, rlens, mol_ids

    @staticmethod
    def _sub_batches(mol_ids, n_mol, per_call: int | None = None):
        """Cut a bucket (pairs ordered by molecule) into runs of at least
        `per_call` (default PAIRS_PER_CALL) pairs, the last may hold fewer,
        at molecule boundaries: (m0, m1, p0, p1). Molecules without a pair
        ride in a run, so the runs cover every molecule."""
        per_call = per_call or PAIRS_PER_CALL
        first = np.searchsorted(np.asarray(mol_ids), np.arange(n_mol + 1))
        m0 = 0
        while m0 < n_mol:
            m1 = int(np.searchsorted(first, first[m0] + per_call))
            m1 = min(max(m1, m0 + 1), n_mol)
            if int(first[m1]) == len(mol_ids):
                m1 = n_mol          # trailing molecules without a pair
            yield m0, m1, int(first[m0]), int(first[m1])
            m0 = m1

    def _run_batch(self, results, info, reads, rlens, mol_ids, m0, Lc, W,
                   maxps, bucketed, batch, tag):
        """One sub-batch (its pairs' molecule ids count from m0): pack,
        upload, align and vote (`_votes`), wait for the card, assemble,
        download, decode. Returns the molecules whose assembly is longer
        than the device route's output row when `bucketed`, for the host
        engine. Its spans (`consensus.pack`, `.upload`, `.device`, `.wait`,
        `.decode`) open one after another."""
        dev = self.device
        P, M = len(reads), len(info)
        attrs = dict(sub_batch=batch, **tag)
        with trace.span("consensus.pack", pairs=P, molecules=M, **attrs):
            r_arr = np.full((P, Lc + W), dna.PAD, np.int8)
            for p, s in enumerate(reads):
                r_arr[p, :len(s)] = dna.encode(s)
            c_arr = np.full((M, Lc), dna.PAD, np.int8)
            for m, (_, cseq, _) in enumerate(info):
                c_arr[m, :len(cseq)] = dna.encode(cseq)
            cl_arr = np.array([len(c) for _, c, _ in info], np.int32)
            rl_arr = np.asarray(rlens, np.int32)
            mid_arr = np.asarray(mol_ids, np.int32) - np.int32(m0)
        with trace.span("consensus.upload", **attrs):
            c_dev = torch.from_numpy(c_arr).to(dev)
            cl_dev = torch.from_numpy(cl_arr).to(dev)
            trace.count("consensus.h2d_bytes", c_arr.nbytes + cl_arr.nbytes,
                        **tag)
        cv, iv, pc = self._votes(r_arr, rl_arr, mid_arr, c_dev, cl_dev, Lc, W,
                                 batch, tag)
        with trace.span("consensus.wait", **attrs):
            # the alignment and the votes done: the assembly reads its
            # largest vote count and its kept slots back from the card
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        with trace.span("consensus.device", **attrs):
            codes, qv, out_len = assemble_votes(cv, iv, pc, c_dev, cl_dev,
                                                maxps)
        with trace.span("consensus.wait", **attrs):
            codes, qv = codes.cpu().numpy(), qv.cpu().numpy()
            out_len = out_len.cpu().numpy()
            trace.count("consensus.d2h_bytes",
                        codes.nbytes + qv.nbytes + out_len.nbytes, **tag)
        with trace.span("consensus.decode", **attrs):
            cons_all = _ACGT_NP[codes].tobytes()
            qv_all = (qv + 33).astype(np.uint8).tobytes()
            ends = np.cumsum(out_len)
            starts = np.concatenate([[0], ends[:-1]])
            out_cols = Lc + Lc // 8 + 16
            overflow = []
            for m, (mi, cseq, _) in enumerate(info):
                s, e = int(starts[m]), int(ends[m])
                if bucketed and e - s > out_cols:
                    # longer than the device route's output row: host engine
                    overflow.append(mi)
                else:
                    results[mi] = (cons_all[s:e], qv_all[s:e])
        return overflow

    def _votes(self, reads, rlens, mids, centers, clens, Lc, W, batch, tag):
        """(cv, iv, pc) of `segment_votes` for all M molecules of a
        sub-batch, on the engine's device. reads, rlens and mids (counted
        from the sub-batch's first molecule, pairs ordered by molecule) are
        host arrays; centers [M, Lc] and clens [M] are tensors on the
        engine's device, where the assembly reads them. The pairs are cut at
        molecule boundaries into one run a device of the mesh
        (`_sub_batches`); each run is uploaded, aligned (`band_align`) and
        voted on its device, with its molecules' centers and ids counted
        from its first molecule, and the runs' votes are summed on the
        engine's device. Each molecule's votes come from one run, so the sum
        is that of one device byte for byte."""
        devs = self.mesh or [self.device]
        attrs = dict(sub_batch=batch, **tag)
        P, M = len(mids), len(clens)
        runs = list(self._sub_batches(mids, M, -(-P // len(devs))))

        def run(dev, m0, m1, p0, p1):
            with trace.span("consensus.upload", **attrs):
                host = [np.ascontiguousarray(a) for a in (
                    reads[p0:p1], rlens[p0:p1], mids[p0:p1] - m0)]
                r, rl, mid = (torch.from_numpy(a).to(dev) for a in host)
                c, cl = centers[m0:m1].to(dev), clens[m0:m1].to(dev)
                trace.count("consensus.h2d_bytes",
                            sum(a.nbytes for a in host), **tag)
            with trace.span("consensus.device", **attrs):
                al, ins, feas = band_align(r, rl, mid, c, cl, Lc, W)
                return segment_votes(al, ins, feas, mid, m1 - m0)

        parts = shard.map_shards(devs, runs, run)
        if len(parts) == 1:
            return parts[0]
        with trace.span("consensus.device", **attrs):
            tot = [torch.zeros((M,) + t.shape[1:], dtype=t.dtype,
                               device=self.device) for t in parts[0]]
            for (m0, m1, _, _), part in zip(runs, parts):
                for acc, t in zip(tot, part):
                    acc[m0:m1] += t.to(self.device)
        return tuple(tot)
