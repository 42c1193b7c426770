"""UMI clustering: ED-graph clustering of UMI candidates per (cell, region).

Reimplements the behavior of the reference jar's UmiClustering /
ClusterOneHierarchical / com.rw.clustering.* + Aliasi complete-link
dendrograms (binary only; behavior spec: the reference README.md:576-597
and Jar/config.xml:244-278):

  * reads of one (cell, genomic region) group cluster by UMI sequence
  * complete-link hierarchical clustering cut at ED <= 2
    (umi_completelinkclusteringED); above
    complexity_threshold_for_switch_to_single_link (3000) reads: single-link
    at ED <= 1; above maxComplexityForUMIclustering (100k): no clustering
  * identical UMIs are pre-grouped (always; pregroup threshold only affects
    when the reference bothers) — here we always dedupe first
  * cluster center: >2 reads -> least-square-sum-ED member; ==2 reads ->
    highest mean UMI QV; singleton -> the raw read sequence stands
    (UZ flag; README.md:588-593)

Edit distances use scalar Myers bit-parallel (host) for small groups; groups
of DEVICE_ED_THRESHOLD unique UMIs or more batch through
ops.editdist.myers_global_group on the given device (csrc/pairwise.cu on
the card from the group's raw bytes, one launch a group; its plain torch
body on the CPU). The route is
chosen by the unique-UMI count and never by the device, and each row is
filled by the same route as in the JAX package: the host rows compare bytes
(N matches N), the batched rows compare codes (N matches nothing), so a
group's matrix is the same on both devices and in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sicelore_tpu_torch import device as _device


def myers_ed(a: bytes, b: bytes) -> int:
    """Scalar Myers/Hyyrö bit-parallel Levenshtein (python ints)."""
    m = len(a)
    if m == 0:
        return len(b)
    if len(b) == 0:
        return m
    peq = {}
    for i, c in enumerate(a):
        peq[c] = peq.get(c, 0) | (1 << i)
    PV = (1 << m) - 1
    MV = 0
    score = m
    mask = 1 << (m - 1)
    full = (1 << m) - 1
    for c in b:
        eq = peq.get(c, 0)
        xv = eq | MV
        xh = (((eq & PV) + PV) ^ PV) | eq
        ph = MV | (~(xh | PV) & full)
        mh = PV & xh
        if ph & mask:
            score += 1
        if mh & mask:
            score -= 1
        ph = ((ph << 1) | 1) & full
        mh = (mh << 1) & full
        PV = (mh | (~(xv | ph) & full))
        MV = ph & xv
    return score


DEVICE_ED_THRESHOLD = 48  # unique UMIs above this go through the device


def pairwise_ed(umis: list[bytes], use_device: bool | None = None,
                device="cuda") -> np.ndarray:
    """[K, K] Levenshtein matrix (int32).

    Small groups run scalar Myers on the host; from DEVICE_ED_THRESHOLD
    unique UMIs the batched route runs on `device`, all pattern lengths
    at once (the analog of the jar's DistanceMatrix). `use_device` forces
    the route either way."""
    K = len(umis)
    if use_device is None:
        use_device = K >= DEVICE_ED_THRESHOLD
    if not use_device:
        d = np.zeros((K, K), dtype=np.int32)
        for i in range(K):
            for j in range(i + 1, K):
                d[i, j] = d[j, i] = myers_ed(umis[i], umis[j])
        return d
    return _pairwise_ed_device(umis, device)


def _pairwise_ed_device(umis: list[bytes], device="cuda") -> np.ndarray:
    """Batched route: the global ED of every UMI of 1 <= m <= 32 nt (as a
    pattern) against ALL UMIs (as texts) in one myers_global_group call on
    the group's raw bytes (on the card: one upload, one csrc/pairwise.cu
    launch, one download a group); rows of length 0 or over 32 take the
    host myers_ed."""
    import torch

    from sicelore_tpu_torch.ops import editdist

    dev = _device.resolve(device)
    K = len(umis)
    buf = editdist.group_buffer(umis)
    d = editdist.myers_global_group(*editdist.group_views(
        torch.from_numpy(buf).to(dev), K, int(buf[K])), buf[:K + 1])
    return host_rows(to_host(d), umis, np.diff(buf[:K + 1]))


# the largest pinned block a download takes: the matrix of 8,192 UMIs
PINNED_BYTES = 256 << 20


def to_host(d):
    """The matrix as a numpy array; a CPU tensor as it is. From the card
    through pinned memory (a pageable copy ran at ~2.3 GB/s on the H100's
    host, ~48 GB/s into a pinned block): a matrix of up to PINNED_BYTES in
    a pinned block of its own, which PyTorch's caching host allocator keeps
    for the next group of its size class; a larger one a run of rows at a
    time through one such block (`copy_rows`; the new pageable pages take
    most of its time, as in a pageable copy). The pinned memory a process
    keeps stays under 2 x PINNED_BYTES whatever the group's size."""
    if d.device.type == "cpu":
        return d.numpy()
    import torch
    esize = d.element_size()
    if d.numel() * esize <= PINNED_BYTES:
        h = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
        h.copy_(d)
        return h.numpy()
    stage = torch.empty(max(PINNED_BYTES // esize, d.shape[1]),
                        dtype=d.dtype, pin_memory=True)
    return copy_rows(d, stage)


def copy_rows(d, stage) -> np.ndarray:
    """d [K, N] as a numpy array in pageable host memory, copied through
    `stage` (a 1-D host tensor of d's dtype, at least N long) a run of
    whole rows at a time."""
    import torch
    K, N = d.shape
    out = torch.empty((K, N), dtype=d.dtype)
    rows = stage.numel() // max(N, 1)
    for r0 in range(0, K, rows):
        n = min(rows, K - r0)
        s = stage[:n * N].view(n, N)
        s.copy_(d[r0:r0 + n])
        out[r0:r0 + n].copy_(s)
    return out.numpy()


def host_rows(d: np.ndarray, umis: list[bytes], lens) -> np.ndarray:
    """Fill the rows of d of the UMIs of 0 or over 32 nt (lens: their
    lengths) with the host myers_ed (bytes: N matches N), as the JAX route
    does; returns d."""
    for i in np.nonzero((lens == 0) | (lens > 32))[0].tolist():
        d[i] = [myers_ed(umis[i], v) for v in umis]
    return d


def complete_link_clusters(d: np.ndarray, max_ed: int) -> list[list[int]]:
    """Agglomerative complete-link cut at max_ed — NN-chain algorithm.

    O(K^2) instead of the naive global-min loop's O(K^3): complete linkage
    is reducible, so following nearest-neighbor chains to a reciprocal
    pair yields the same dendrogram (up to tie order); heights are
    monotone, so cutting = applying every merge with height <= max_ed.
    Every pair inside a returned cluster is within max_ed (complete-link
    diameter bound), matching the jar's Aliasi dendrogram cut
    (config.xml:244-278)."""
    K = d.shape[0]
    if K == 0:
        return []
    if K == 1:
        return [[0]]
    D = d.astype(np.float64).copy()
    np.fill_diagonal(D, np.inf)
    active = np.ones(K, bool)
    merges: list[tuple[int, int, float]] = []  # (rep kept, rep merged, h)
    chain: list[int] = []
    n_active = K
    while n_active > 1:
        if not chain:
            chain.append(int(np.argmax(active)))
        x = chain[-1]
        row = np.where(active, D[x], np.inf)
        row[x] = np.inf
        y = int(np.argmin(row))
        if len(chain) >= 2 and y == chain[-2]:
            merges.append((x, y, float(row[y])))
            D[x] = np.maximum(D[x], D[y])
            D[:, x] = D[x]
            D[x, x] = np.inf
            active[y] = False
            chain.pop()
            chain.pop()
            n_active -= 1
        else:
            chain.append(y)
    parent = list(range(K))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for x, y, h in merges:
        if h <= max_ed:
            parent[find(y)] = find(x)
    groups: dict[int, list[int]] = {}
    for i in range(K):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def single_link_clusters(d: np.ndarray, max_ed: int) -> list[list[int]]:
    """Connected components of the ED <= max_ed graph (union-find)."""
    K = d.shape[0]
    parent = list(range(K))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ii, jj = np.nonzero(np.triu(d <= max_ed, 1))
    for i, j in zip(ii.tolist(), jj.tolist()):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri
    groups: dict[int, list[int]] = {}
    for i in range(K):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


@dataclass
class UmiCluster:
    center: bytes         # assigned UMI sequence
    members: list[int]    # indices into the group's read list
    from_clustering: bool  # UC flag: center came from multi-read clustering
    is_readseq: bool      # UZ flag: singleton, raw read seq stands


def cluster_group(umi_seqs: list[bytes], umi_quals: list[float],
                  complete_link_ed: int = 2, single_link_ed: int = 1,
                  single_link_threshold: int = 3000,
                  max_complexity: int = 100_000,
                  device="cuda") -> list[UmiCluster]:
    """Cluster one (cell, region) group of UMI candidate sequences.

    umi_seqs/umi_quals are per READ (duplicates expected); returns clusters
    over read indices with the assigned center sequence. `device` runs the
    batched distance route of large groups (pairwise_ed).
    """
    device = _device.resolve(device)
    n = len(umi_seqs)
    if n == 0:
        return []
    if n > max_complexity:  # reject oversized jobs (config.xml:269)
        return [UmiCluster(umi_seqs[i], [i], False, True) for i in range(n)]
    # pre-group identical UMIs
    uniq: dict[bytes, list[int]] = {}
    for i, s in enumerate(umi_seqs):
        uniq.setdefault(s, []).append(i)
    useqs = list(uniq.keys())
    d = pairwise_ed(useqs, device=device)
    if n > single_link_threshold:
        uclusters = single_link_clusters(d, single_link_ed)
    else:
        uclusters = complete_link_clusters(d, complete_link_ed)
    out = []
    for uc in uclusters:
        members = [i for u in uc for i in uniq[useqs[u]]]
        if len(members) == 1:
            out.append(UmiCluster(umi_seqs[members[0]], members, False, True))
        elif len(members) == 2:
            # highest mean UMI QV wins (README.md:585)
            best = max(members, key=lambda i: umi_quals[i])
            out.append(UmiCluster(umi_seqs[best], members, True, False))
        else:
            # least square-sum ED center among unique members, weighted by
            # read multiplicity (README.md:587)
            sub = d[np.ix_(uc, uc)].astype(np.int64)
            w = np.array([len(uniq[useqs[u]]) for u in uc], dtype=np.int64)
            cost = (sub.astype(np.int64) ** 2 * w[None, :]).sum(axis=1)
            center = useqs[uc[int(np.argmin(cost))]]
            out.append(UmiCluster(center, members, True, False))
    return out
