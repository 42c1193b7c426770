"""Step 1 traffic: 10x Nanopore reads in bulk with NumPy.

The mix of a scan traffic file (shares of long molecules, chimeras, garbage
and reads with N; the reversed share; the error rate) holds exactly in every
set of reads, in an order drawn from the seed; lengths, bases and errors are
drawn per read. The 3' layout (stranded, before errors):

  TSO . cDNA . polyA . rc(UMI) . rc(BC) . rc(adapter)

Errors are uniform substitutions, insertions and deletions at `error` per
base. A reversed read is the reverse complement of its molecule. A chimera
is two unreversed molecules end to end. Garbage is random
bases with random qualities; every other read has quality 'I'. Read names
carry the truth: r<i>c<cell> (one molecule), x<i> (chimera), g<i> (garbage).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
ADAPTER = b"CTACACGACGCTCTTCCGATCT"          # 10x R1 (config.xml:112-114)
TSO = b"AACGCAGAGTACATGG"                   # config.xml:158
POLYA = 20
UMI = 12
BC = 16
_COMP = np.arange(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)


def revcomp(a: np.ndarray) -> np.ndarray:
    return _COMP[a[..., ::-1]]


def whitelist(rng: np.random.Generator, n: int) -> np.ndarray:
    """n distinct random 16-mers as sorted uint32 codes (2 bits a base,
    A=0 C=1 G=2 T=3, first base in the top bits)."""
    out = np.empty(0, np.uint32)
    while len(out) < n:
        draw = rng.integers(0, 1 << 32, int((n - len(out)) * 1.01) + 64,
                            dtype=np.uint64).astype(np.uint32)
        out = np.sort(np.concatenate([out, draw]))
        out = out[np.concatenate([[True], out[1:] != out[:-1]])]
    # drop a random set of the extra codes: the rest stay sorted
    return np.delete(out, rng.choice(len(out), len(out) - n, replace=False))


def unpack(words: np.ndarray, k: int = BC) -> np.ndarray:
    """uint32 codes -> [n, k] ASCII bases."""
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint32)
    return ACGT[(np.asarray(words, np.uint32)[:, None] >> shifts) & 3]


def exact_counts(n: int, shares) -> list[int]:
    """[n - sum, round(share * n) for each share]: the counts of a mix
    whose first class takes what the shares leave."""
    counts = [round(x * n) for x in shares]
    return [n - sum(counts)] + counts


def mutate(rng, buf, lens, rate, skip=None):
    """Uniform substitution / insertion / deletion noise over the segments
    of buf (consecutive, of lengths lens): a hit base is replaced, dropped,
    or kept with a random base after it, a third each. Segments where skip
    is True keep their bases. Returns (new buf, new lens)."""
    starts = np.cumsum(lens) - lens
    idx = np.nonzero(rng.random(len(buf), dtype=np.float32) < rate)[0]
    seg = np.searchsorted(starts, idx, "right") - 1
    if skip is not None:
        idx, seg = idx[~skip[seg]], seg[~skip[seg]]
    kind = rng.integers(0, 3, len(idx), dtype=np.uint8)
    out = buf.copy()
    sub = idx[kind == 0]
    out[sub] = ACGT[rng.integers(0, 4, len(sub), dtype=np.uint8)]
    ins, dele = idx[kind == 1], idx[kind == 2]
    out = np.insert(out, ins + 1,
                    ACGT[rng.integers(0, 4, len(ins), dtype=np.uint8)])
    out = np.delete(out, dele + np.searchsorted(ins + 1, dele, "right"))
    n = len(lens)
    return out, (lens + np.bincount(seg[kind == 1], minlength=n)
                 - np.bincount(seg[kind == 2], minlength=n))


def molecules(rng, chem: str, bcs: np.ndarray, cdna: np.ndarray,
              raw: np.ndarray):
    """Stranded molecules before errors: one per row of bcs ([n, 16] ASCII)
    with cdna[i] random cDNA bases each; a row where raw is True is cdna[i]
    random bases alone. Returns (buf, lens)."""
    if chem != "3p":
        raise ValueError(f"no layout for chemistry {chem!r}")
    parts = [TSO, None, b"A" * POLYA, "umi", "bc", revcomp(
        np.frombuffer(ADAPTER, np.uint8)).tobytes()]
    sizes = [len(p) if isinstance(p, bytes) else
             (UMI if p == "umi" else BC if p == "bc" else 0) for p in parts]
    lens = np.where(raw, cdna, cdna + sum(sizes))
    starts = (np.cumsum(lens) - lens)[~raw]
    buf = ACGT[rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)]
    off = np.zeros(len(starts), np.int64)
    bcs = bcs[~raw]
    for p, size in zip(parts, sizes):
        if p is None:
            off += cdna[~raw]
            continue
        at = (starts + off)[:, None] + np.arange(size)[None, :]
        if p == "bc":
            buf[at] = revcomp(bcs)
        elif p != "umi":
            buf[at] = np.frombuffer(p, np.uint8)[None, :]
        off += size
    return buf, lens


_REVCOMP = bytes(_COMP)


@dataclass
class Truth:
    """What each read is, by its index: kind (0 one molecule, 1 long, 2
    chimera, 3 garbage), the cell of its (first) molecule, the cell of a
    chimera's second molecule (-1 otherwise), and whether it is the
    reverse complement of its molecule. Cells index the cells' codes."""
    kind: np.ndarray
    cell: np.ndarray
    cell2: np.ndarray
    rev: np.ndarray


def make_reads(rng: np.random.Generator, n: int, cells: np.ndarray,
               mix: dict, chem: str, with_truth: bool = False):
    """n reads of the mix over cells (uint32 codes). Returns (names,
    seqs, quals) as lists of bytes, and with_truth the reads' `Truth`."""
    s = mix["shares"]
    # 0 one molecule, 1 long, 2 chimera, 3 garbage: exact counts in a drawn
    # order, so that every seed gives the same work
    kind = rng.permutation(np.repeat(np.arange(4), exact_counts(
        n, [s["long"], s["chimera"], s["garbage"]])))
    ci = rng.integers(0, len(cells), n)
    ci2 = rng.integers(0, len(cells), n)
    rev = (rng.random(n) < mix["reversed"]) & (kind < 2)
    lo, hi = mix["cdna"]
    cdna = np.select([kind == 1, kind == 3],
                     [rng.integers(*mix["long_cdna"], n),
                      rng.integers(*mix["garbage_len"], n)],
                     rng.integers(lo, hi, n))
    # molecules in read order, a chimera's two side by side
    nm = 1 + (kind == 2)
    read_of = np.repeat(np.arange(n), nm)
    second = np.zeros(len(read_of), bool)
    second[np.cumsum(nm)[kind == 2] - 1] = True
    raw = kind[read_of] == 3
    m_cdna = np.where(second, rng.integers(lo, hi, len(read_of)),
                      cdna[read_of])
    bcs = unpack(cells[np.where(second, ci2[read_of], ci[read_of])])
    buf, mlens = molecules(rng, chem, bcs, m_cdna, raw)
    buf, mlens = mutate(rng, buf, mlens, mix["error"], skip=raw)
    rlens = np.bincount(read_of, weights=mlens, minlength=n).astype(np.int64)
    ends = np.cumsum(rlens)
    # 1-3 N within n_window of one end
    withn = rng.choice(n, round(mix["n_share"] * n), replace=False)
    r = np.repeat(withn, rng.integers(1, 4, len(withn)))
    p = (rng.random(len(r)) * np.minimum(mix["n_window"], rlens[r])).astype(
        np.int64)
    at_end = rng.random(len(r)) < 0.5
    buf[ends[r] - rlens[r] + np.where(at_end, rlens[r] - 1 - p, p)] = ord("N")
    gq = (33 + rng.integers(2, 30, int(rlens[kind == 3].sum()),
                            dtype=np.uint8)).tobytes()
    sb = buf.tobytes()
    names, seqs, quals = [], [], []
    g = 0
    for i, (k, c, rv, b, L) in enumerate(zip(
            kind.tolist(), ci.tolist(), rev.tolist(), ends.tolist(),
            rlens.tolist())):
        sq = sb[b - L:b]
        seqs.append(sq[::-1].translate(_REVCOMP) if rv else sq)
        if k == 3:
            quals.append(gq[g:g + L])
            g += L
            names.append(b"g%d" % i)
        else:
            quals.append(b"I" * L)
            names.append(b"x%d" % i if k == 2 else b"r%dc%d" % (i, c))
    if with_truth:
        return names, seqs, quals, Truth(kind, ci, np.where(kind == 2, ci2,
                                                            -1), rev)
    return names, seqs, quals


def write_fastq(path, names, seqs, quals) -> int:
    """Write the reads; returns the bytes written."""
    data = b"".join(b"@%s\n%s\n+\n%s\n" % t for t in zip(names, seqs, quals))
    with open(path, "wb") as fh:
        fh.write(data)
    return len(data)
