"""Multi-process scan over one run's fastq files, joined by torch.distributed.

The reference scales across hosts with Nextflow/SGE: each node runs the jar
over a subset of the fastq files and `MergeReadScannerStats` merges the
serialized stats. Here every process owns the files
`sorted(files)[rank::world_size]` and scans them on its own device; the
small cross-process state (the pass-1 whitelist hit counts, one int64 a
whitelist entry, and the scan stats and per-barcode histograms at the end)
is summed with an all-reduce. Pass 2 then runs in each process against the
same merged used list, so the processes' outputs together are those of one
process (tests/test_torch_multihost.py).

Every collective is a small int64 host vector, so the group runs the gloo
backend on CPU tensors: it needs no card, and two ranks may share one card
(NCCL refuses two ranks on one device).

Port of `sicelore_tpu/parallel/multihost.py` (jax.distributed there).
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None,
         timeout: datetime.timedelta = datetime.timedelta(minutes=30)):
    """Join the process group (idempotent): gloo over TCP at `coordinator`
    ("host:port", rank 0 listens there) with `num_processes` and this
    process's `process_id`; with no arguments, `env://` (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as `torchrun` sets them). A collective
    that waits longer than `timeout` on a peer raises, so a lost rank fails
    the run instead of hanging it."""
    if dist.is_initialized():
        return
    if coordinator is None:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


_rank, _world = process_index, process_count   # shadowed below


def shard_files(files: list, process_index: int | None = None,
                process_count: int | None = None) -> list:
    """This process's files: sorted(files)[pid::nproc]."""
    pid = _rank() if process_index is None else process_index
    n = _world() if process_count is None else process_count
    return sorted(files)[pid::n]


def allreduce_counts(counts: np.ndarray) -> np.ndarray:
    """Sum an int64 host vector across all processes. One process: the
    vector as it is. Several: every process contributes its counts and all
    receive the exact int64 sums."""
    if process_count() == 1:
        return counts
    t = torch.from_numpy(np.array(counts, dtype=np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def merge_scalar_stats(values: dict) -> dict:
    """Sum a {name: int} stats dict across processes (over its sorted keys,
    which every process holds)."""
    if process_count() == 1:
        return dict(values)
    keys = sorted(values)
    tot = allreduce_counts(np.array([int(values[k]) for k in keys],
                                    np.int64))
    return {k: int(v) for k, v in zip(keys, tot)}
