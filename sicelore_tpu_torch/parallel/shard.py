"""A mesh in the port: a plain sequence of devices with the data split
across them, the counterpart of a `jax.sharding.Mesh` with one "data" axis.

`mesh=["cuda:0", "cuda:1"]` (or torch.devices) runs one shard a card. A
device may repeat: `["cuda:0", "cuda:0"]` gives two shards on one card (they
share its stream, so they are right but run one after the other), and
`["cpu"] * 8` eight shards of the plain bodies. Per-read work needs no
collective: each shard takes a contiguous span of rows, and the host puts
the rows that come back in read order.
"""
from __future__ import annotations

import torch

from sicelore_tpu_torch.device import resolve


def resolve_mesh(mesh, device=None) -> list[torch.device]:
    """Each entry of `mesh` through `device.resolve` (a card that is not
    visible raises). A mesh must be one device type, and that of `device`
    when it is given."""
    devs = [resolve(d) for d in mesh]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"a mesh of one device type, got {sorted(kinds)}")
    if device is not None and resolve(device).type not in kinds:
        raise ValueError(f"mesh on {kinds.pop()} but device={str(device)!r}")
    return devs


def cuts(n: int, shards: int) -> list[tuple[int, int]]:
    """Row spans [a, b) of ceil(n / shards) rows, in order, the empty ones
    left out: fewer rows than shards leaves the last shards without work.
    n == 0 gives one empty span, so that the first shard runs the call a
    single device would make."""
    if n == 0:
        return [(0, 0)]
    step = -(-n // shards)
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def map_shards(devices, spans, fn) -> list:
    """[fn(devices[i], *spans[i])] for each span in order. `fn` uploads its
    span and issues its device work without waiting on it, so shards on
    different cards overlap; the caller waits on the results."""
    if len(spans) > len(devices):
        raise ValueError(f"{len(spans)} spans for {len(devices)} shards")
    return [fn(dev, *span) for dev, span in zip(devices, spans)]
