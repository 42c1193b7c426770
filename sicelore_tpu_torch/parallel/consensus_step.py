"""Consensus pair batches split across a mesh (port of
`sicelore_tpu/parallel/consensus_step.py`).

Consensus pairs (center, read) are data-parallel: each shard aligns its
pairs, the per-molecule vote tensors are summed, and the assembly runs once
on the sum. Each molecule's pairs lie on one shard, so its votes come from
that shard and are zero on every other: the sum is exact, and the result is
that of one device byte for byte.

  make_sharded_bucket_fn       the engine's path: `ops.poa_cuda.band_align`
                               (the CUDA kernel on a card, its plain version
                               on the CPU) and `segment_votes` a shard.
  make_sharded_consensus_step  the plain route, `consensus_votes_plain` a
                               shard, for CPU meshes (the counterpart of the
                               JAX package's jnp step).
"""
from __future__ import annotations

import numpy as np
import torch

from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.parallel import shard
from sicelore_tpu_torch.utils import trace


def make_sharded_bucket_fn(mesh, Lc: int, W: int):
    """fn(reads [P, Lc+W] int8, rlens [P] int32, mids [P] int32, centers
    [M, Lc] int8, clens [M] int32), with the pairs ordered by molecule ->
    (cv, iv, pc) of `poa_cuda.segment_votes` for all M molecules, summed
    on the mesh's first device; the engine assembles them. reads, rlens
    and mids are host arrays; centers and clens are host arrays or tensors
    on the first device, where the engine keeps them for the assembly, so
    that they are uploaded once. The pairs are cut at molecule boundaries
    into one run a shard (`BatchedConsensusEngine._sub_batches`); a shard
    gets its molecules' centers and ids counted from its first molecule."""
    devices = list(mesh)
    dev0 = devices[0]

    def fn(reads, rlens, mids, centers, clens):
        P, M = len(mids), len(clens)
        centers = torch.as_tensor(centers, device=dev0)
        clens = torch.as_tensor(clens, device=dev0)
        groups = list(poa_cuda.BatchedConsensusEngine._sub_batches(
            mids, M, -(-P // len(devices))))

        def votes(dev, m0, m1, p0, p1):
            with trace.span("consensus.upload"):
                host = [np.ascontiguousarray(a) for a in (
                    reads[p0:p1], rlens[p0:p1], mids[p0:p1] - m0)]
                r, rl, mid = (torch.from_numpy(a).to(dev) for a in host)
                c, cl = centers[m0:m1].to(dev), clens[m0:m1].to(dev)
                trace.count("consensus.h2d_bytes",
                            sum(a.nbytes for a in host))
            with trace.span("consensus.device"):
                al, ins, feas = poa_cuda.band_align(r, rl, mid, c, cl, Lc, W)
                return poa_cuda.segment_votes(al, ins, feas, mid, m1 - m0)

        parts = shard.map_shards(devices, groups, votes)
        if len(parts) == 1:
            return parts[0]
        with trace.span("consensus.device"):
            tot = [torch.zeros((M,) + t.shape[1:], dtype=t.dtype,
                               device=dev0) for t in parts[0]]
            for (m0, m1, _, _), part in zip(groups, parts):
                for acc, t in zip(tot, part):
                    acc[m0:m1] += t.to(dev0)
        return tuple(tot)

    return fn


def make_sharded_consensus_step(mesh, W: int, M: int):
    """(step, shards): step(center [P, Lc], clens [P], reads [P, Lr], rlens
    [P], mol_ids [P]) -> (col_votes [M, Lc+1, 5], ins_votes, pair_counts)
    of `poa_cuda.consensus_votes_plain`, the pairs cut into contiguous
    spans, one a shard, and the votes summed on the first device. mol_ids
    are global molecule indices < M, so a molecule may span shards: the
    sum is exact either way. CPU meshes only: on the card, the engine's
    route is `make_sharded_bucket_fn`."""
    devices = shard.resolve_mesh(mesh)
    if devices[0].type != "cpu":
        raise ValueError("make_sharded_consensus_step is the plain route of "
                         "CPU meshes; a card's is make_sharded_bucket_fn")

    def step(center, clens, reads, rlens, mol_ids):
        arrs = [np.asarray(a) for a in (center, clens, reads, rlens,
                                        mol_ids)]
        parts = shard.map_shards(
            devices, shard.cuts(len(arrs[4]), len(devices)),
            lambda dev, a, b: poa_cuda.consensus_votes_plain(
                *(torch.from_numpy(np.ascontiguousarray(x[a:b])).to(dev)
                  for x in arrs), W, M))
        return tuple(sum(p[k] for p in parts) for k in range(3))

    return step, len(devices)
