"""Step 4b traffic of full-length cDNA: molecules whose truths lie in length
bands, in bulk with NumPy, as a `molecules.Molecules` that
`molecules.write_molecules` and the reference take unchanged.

A long-cDNA traffic file sets the molecule count, the bands ([share, first
length, end length) each; the first band takes what the others' rounded
shares leave), the range of depths, the error rate, the share of molecules
whose second read carries an N and the molecules a cell. Each band's
molecules are spread evenly over its depths and, within each depth, over
its lengths (a golden-ratio sequence, as `molecules.make_molecules` does);
the N molecules evenly over the whole set. Every seed gives the same set of
(depth, truth length, N) molecules: the seed draws the order, the bases,
the errors, the `de` tags, the barcodes and the UMIs, not the amount of
work."""
from __future__ import annotations

import numpy as np

from benchmark.gen.molecules import GOLDEN, Molecules
from benchmark.gen.reads import ACGT, mutate, unpack


def design(mix: dict):
    """(depth, truth length, N) of every molecule, before the seed's order:
    int64 [n], int64 [n], bool [n]."""
    n = mix["molecules"]
    shares = [s for s, _, _ in mix["bands"]]
    counts = [round(s * n) for s in shares]
    counts[0] = n - sum(counts[1:])
    lo, hi = mix["depth_range"]
    depth, length = [], []
    for (_, l0, l1), c in zip(mix["bands"], counts):
        depth.append(np.sort(lo + np.arange(c) % (hi - lo)))
        length.append(l0 + (np.arange(c) * GOLDEN % 1.0 * (l1 - l0))
                      .astype(np.int64))
    depth, length = np.concatenate(depth), np.concatenate(length)
    k = round(mix["n_share"] * n)
    with_n = np.zeros(n, bool)
    if k:
        with_n[np.linspace(0, n - 1, k).round().astype(np.int64)] = True
    return depth, length, with_n


def band_of(length: np.ndarray, mix: dict) -> np.ndarray:
    """The index of each truth length's band."""
    ends = np.array([l1 for _, _, l1 in mix["bands"]])
    return np.searchsorted(ends, length, "right")


def make_molecules(rng: np.random.Generator, mix: dict) -> Molecules:
    depth, length, with_n = design(mix)
    n = len(depth)
    perm = rng.permutation(n)
    depth, length, with_n = depth[perm], length[perm], with_n[perm]
    truth = ACGT[rng.integers(0, 4, int(length.sum()), dtype=np.uint8)]
    tstart = np.cumsum(length) - length
    mol_of = np.repeat(np.arange(n), depth)
    rl = length[mol_of]
    first = np.repeat(np.cumsum(rl) - rl, rl)
    src = np.repeat(tstart[mol_of], rl) + np.arange(int(rl.sum())) - first
    buf, rlens = mutate(rng, truth[src], rl, mix["error"])
    ends = np.cumsum(rlens)
    withn = np.nonzero(with_n)[0]
    second = np.cumsum(depth)[withn] - depth[withn] + 1
    buf[ends[second] - rlens[second] + (rng.random(len(withn))
                                        * rlens[second]).astype(np.int64)] \
        = ord("N")
    de = (rng.integers(0, 1000, len(rlens)) / 10000.0).astype(np.float32)
    bc_codes = rng.integers(0, 1 << 32, n // mix["cells_every"] + 1,
                            dtype=np.uint64).astype(np.uint32)
    block = np.arange(n) // mix["cells_every"]
    umi = rng.integers(0, 1 << 24, n, dtype=np.uint32)
    while True:     # one UMI a (cell, UMI) pair: redraw repeats
        key = block.astype(np.uint64) << np.uint64(24) | umi
        _, first_at = np.unique(key, return_index=True)
        dup = np.setdiff1d(np.arange(n), first_at)
        if not len(dup):
            break
        umi[dup] = rng.integers(0, 1 << 24, len(dup), dtype=np.uint32)
    bcs = [b.tobytes().decode() for b in unpack(bc_codes)]
    umis = [b.tobytes().decode() for b in unpack(umi, 12)]
    sb = buf.tobytes()
    reads = [[] for _ in range(n)]
    des = [[] for _ in range(n)]
    for m, e, L, d in zip(mol_of.tolist(), ends.tolist(), rlens.tolist(),
                          de.tolist()):
        reads[m].append(sb[e - L:e])
        des[m].append(d)
    tb = truth.tobytes()
    truths = [tb[a:a + L] for a, L in zip(tstart.tolist(), length.tolist())]
    return Molecules([bcs[b] for b in block.tolist()], umis, reads, des,
                     truths)
