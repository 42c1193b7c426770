"""Step 4b traffic: molecules of noisy reads of random truths, in bulk with
NumPy, and their tagged BAM.

A consensus traffic file sets the molecule count, the share of each fixed
depth and the range that the rest cover evenly, the truth lengths, the
error rate, the share of molecules of three or more reads whose second read
carries an N, and a few long molecules at the end. Every seed gives the same
set of (depth, truth length, N) molecules, in an order drawn from it: the
seed draws the order, the bases and the errors, not the amount of work. Every read is one mapped record tagged
BC (a cell every `cells_every` molecules), U8 (one UMI a molecule), de (a
divergence drawn per read) and CS (the read as its cDNA)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.gen import bam
from benchmark.gen.reads import ACGT, exact_counts, mutate, unpack

GOLDEN = (5 ** 0.5 - 1) / 2


@dataclass
class Molecules:
    bcs: list            # str a molecule
    umis: list           # str a molecule
    reads: list          # list[bytes] a molecule, in record order
    des: list            # list[float] a molecule (the float32 the BAM holds)
    truths: list         # bytes a molecule: the sequence its reads were drawn from

    @property
    def n_records(self) -> int:
        return sum(len(r) for r in self.reads)


def make_molecules(rng: np.random.Generator, mix: dict) -> Molecules:
    n = mix["molecules"]
    lg = mix["long"]
    nr = n - lg["count"]            # the regular molecules; the long come last
    fixed = [d for d, _ in mix["depth_shares"]]
    counts = exact_counts(nr, [x for _, x in mix["depth_shares"]])
    lo, hi = mix["depth_range"]
    # the set, sorted by depth: exact counts of each depth, truth lengths
    # spread evenly over each depth's molecules (a golden-ratio sequence)
    depth = np.sort(np.concatenate(
        [lo + np.arange(counts[0]) % (hi - lo)]
        + [np.full(c, d) for d, c in zip(fixed, counts[1:])]))
    l0, l1 = mix["length"]
    length = l0 + (np.arange(nr) * GOLDEN % 1.0 * (l1 - l0)).astype(np.int64)
    # an N in the second read of n_share of the molecules of 3+ reads,
    # evenly over the depths: the host engine takes these molecules
    deep = np.nonzero(depth > 2)[0]
    k = round(mix["n_share"] * len(deep))
    chosen = deep[np.linspace(0, len(deep) - 1, k).round().astype(np.int64)
                  ] if k else deep[:0]
    # the order, drawn from the seed; the long molecules last
    perm = rng.permutation(nr)
    withn = np.sort(np.nonzero(np.isin(perm, chosen))[0])
    la, lb = lg["length"]
    depth = np.concatenate([depth[perm], np.full(lg["count"], lg["depth"])])
    length = np.concatenate([length[perm], la + np.arange(lg["count"])
                             * (lb - la) // max(lg["count"], 1)])
    truth = ACGT[rng.integers(0, 4, int(length.sum()), dtype=np.uint8)]
    tstart = np.cumsum(length) - length
    mol_of = np.repeat(np.arange(n), depth)
    rl = length[mol_of]
    first = np.repeat(np.cumsum(rl) - rl, rl)
    src = np.repeat(tstart[mol_of], rl) + np.arange(int(rl.sum())) - first
    buf, rlens = mutate(rng, truth[src], rl, mix["error"])
    ends = np.cumsum(rlens)
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


def write_molecules(path, mols: Molecules, level: int = 1) -> int:
    """The molecules as a tagged BAM, read r of molecule m named m<m>r<r> at
    position 1000 + m. Returns the bytes written."""
    recs = []
    for m, (bc, umi, reads, des) in enumerate(zip(mols.bcs, mols.umis,
                                                  mols.reads, mols.des)):
        for r, (s, d) in enumerate(zip(reads, des)):
            recs.append(bam.record(f"m{m}r{r}", 1000 + m,
                                   [("BC", "Z", bc), ("U8", "Z", umi),
                                    ("de", "f", d), ("CS", "Z", s.decode())]))
    return bam.write_bam(path, recs, level=level)
