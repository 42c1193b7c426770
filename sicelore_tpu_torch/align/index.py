"""Minimizer index over a fasta reference.

minimap2's sketch (Li 2016): for every window of w consecutive k-mers keep
the one with the smallest invertible hash; index maps hash -> sorted
positions. Canonical k-mers (min of kmer, revcomp) with a strand bit, so
one index serves both genome strands. The sketch runs in the native
extension (hostenc.build_minimizers, 52x the numpy fallback, GIL released
— contigs build in parallel; ~0.5 s / 20 Mb, whole-genome in well under a
minute) and serializes to one .npz (save/load — the .mmi analog).
"""
from __future__ import annotations

import numpy as np

K = 15
W = 10
# contigs are spaced this far apart in global coordinates so the chain DP
# (whose max ref gap is chain.MAX_INTRON < GUARD) can never chain anchors
# across a contig boundary (minimap2 chains per reference sequence)
GUARD = 2_000_000

_ENC = np.full(256, 255, np.uint8)
for i, c in enumerate(b"ACGT"):
    _ENC[c] = i
    _ENC[ord(chr(c).lower())] = i

MASK = np.uint64((1 << (2 * K)) - 1)


def load_fasta(path) -> dict[str, bytes]:
    """Plain/bgzip fasta -> {name: seq} (uppercased)."""
    import gzip
    out: dict[str, bytes] = {}
    opener = gzip.open if str(path).endswith(".gz") else open
    name, parts = None, []
    with opener(str(path), "rb") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    out[name] = b"".join(parts).upper()
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line)
    if name is not None:
        out[name] = b"".join(parts).upper()
    return out


def _mix(h: np.ndarray) -> np.ndarray:
    """Invertible 64-bit finalizer (murmur3-style), vectorized."""
    h = h.astype(np.uint64)
    h = (~h + (h << np.uint64(21))) & np.uint64(0xFFFFFFFFFFFFFFFF)
    h = h ^ (h >> np.uint64(24))
    h = (h + (h << np.uint64(3)) + (h << np.uint64(8))) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    h = h ^ (h >> np.uint64(14))
    h = (h + (h << np.uint64(2)) + (h << np.uint64(4))) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    h = h ^ (h >> np.uint64(28))
    h = (h + (h << np.uint64(31))) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return h


def seq_kmers(seq: bytes):
    """-> (kmer codes fwd [n] u64, rc codes [n] u64, valid [n] bool) for
    every k-mer start position (n = len - K + 1)."""
    codes = _ENC[np.frombuffer(seq, np.uint8)]
    L = len(codes)
    n = L - K + 1
    if n <= 0:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, bool)
    c = codes.astype(np.uint64)
    bad = codes > 3
    c = np.where(bad, 0, c)
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for i in range(K):
        fwd = (fwd << np.uint64(2)) | c[i:n + i]
        rev = rev | ((np.uint64(3) ^ c[i:n + i]) << np.uint64(2 * i))
    # valid = window has no non-ACGT base
    badc = np.concatenate([[0], np.cumsum(bad.astype(np.int32))])
    valid = (badc[K:] - badc[:-K]) == 0
    return fwd, rev, valid


def minimizers(seq: bytes, k: int = K, w: int = W):
    """-> (hash [m] u64, pos [m] u32, strand [m] u8) minimizers of seq.

    strand 0: the canonical k-mer is the forward strand's; 1: revcomp.
    Runs in the native extension when present (single-pass monotonic
    deque, GIL released — whole-genome index builds thread across
    contigs; the numpy build below is the fallback and the parity
    oracle, tests/test_align.py)."""
    from sicelore_tpu_torch.io import native as _native
    ext = _native.get_hostenc()
    if ext is not None and hasattr(ext, "build_minimizers"):
        hb, pb, sb = ext.build_minimizers(seq, k, w)
        return (np.frombuffer(hb, np.uint64),
                np.frombuffer(pb, np.uint32),
                np.frombuffer(sb, np.uint8))
    fwd, rev, valid = seq_kmers(seq)
    n = len(fwd)
    if n < w:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                np.zeros(0, np.uint8))
    use_rc = rev < fwd
    canon = np.where(use_rc, rev, fwd)
    h = _mix(canon)
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    # sliding argmin over w consecutive kmers
    sw = np.lib.stride_tricks.sliding_window_view(h, w)
    am = np.argmin(sw, axis=1)
    pos = (np.arange(n - w + 1) + am).astype(np.uint32)
    keep = np.ones(len(pos), bool)
    keep[1:] = pos[1:] != pos[:-1]
    pos = pos[keep]
    hh = h[pos]
    ok = hh != np.uint64(0xFFFFFFFFFFFFFFFF)
    pos = pos[ok]
    return h[pos], pos, use_rc[pos].astype(np.uint8)


class MinimizerIndex:
    """Sorted-array minimizer index over a multi-contig reference."""

    def __init__(self, contigs: dict[str, bytes], k: int = K, w: int = W,
                 max_occ: int = 400):
        self.k, self.w = k, w
        self.names = list(contigs)
        self.lengths = [len(contigs[n]) for n in self.names]
        self.seqs = contigs
        offs = (np.cumsum([0] + self.lengths)
                + GUARD * np.arange(len(self.lengths) + 1))
        self.offsets = offs
        # the native builder releases the GIL: contigs sketch in parallel
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, max(1, len(contigs)))
                                ) as pool:
            sk = list(pool.map(
                lambda n: minimizers(contigs[n], k, w), self.names))
        hs, ps, ss = [], [], []
        for i, (h, p, s) in enumerate(sk):
            hs.append(h)
            ps.append(p.astype(np.int64) + offs[i])
            ss.append(s)
        h = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
        p = np.concatenate(ps) if ps else np.zeros(0, np.int64)
        s = np.concatenate(ss) if ss else np.zeros(0, np.uint8)
        order = np.argsort(h, kind="stable")
        self.h = h[order]
        self.p = p[order]
        self.s = s[order]
        # drop over-represented minimizers (repeats), minimap2 -f analog
        starts = np.searchsorted(self.h, self.h, side="left")
        ends = np.searchsorted(self.h, self.h, side="right")
        keep = (ends - starts) <= max_occ
        self.h, self.p, self.s = self.h[keep], self.p[keep], self.s[keep]

    def save(self, path) -> None:
        """Serialize to one .npz (minimap2 .mmi analog): sketch arrays +
        contig sequences, so whole-genome indexes build once."""
        arrs = {
            "h": self.h, "p": self.p, "s": self.s,
            "offsets": np.asarray(self.offsets, np.int64),
            "lengths": np.asarray(self.lengths, np.int64),
            "names": np.array(self.names),
            "kw": np.array([self.k, self.w], np.int64),
        }
        for i, n in enumerate(self.names):
            arrs[f"seq{i}"] = np.frombuffer(self.seqs[n], np.uint8)
        np.savez(str(path), **arrs)

    @classmethod
    def load(cls, path) -> "MinimizerIndex":
        z = np.load(str(path), allow_pickle=False)
        obj = cls.__new__(cls)
        obj.k, obj.w = (int(x) for x in z["kw"])
        obj.names = [str(n) for n in z["names"]]
        obj.lengths = [int(x) for x in z["lengths"]]
        obj.offsets = z["offsets"]
        obj.h, obj.p, obj.s = z["h"], z["p"], z["s"]
        obj.seqs = {n: z[f"seq{i}"].tobytes()
                    for i, n in enumerate(obj.names)}
        return obj

    def contig_of(self, gpos: int) -> tuple[int, int]:
        """global pos -> (contig idx, local pos)."""
        ci = int(np.searchsorted(self.offsets, gpos, side="right")) - 1
        return ci, int(gpos - self.offsets[ci])

    def lookup(self, hashes: np.ndarray):
        """hashes [m] u64 -> (qi [t], gpos [t], strand [t]): for query
        minimizer i every indexed occurrence (qi = i)."""
        lo = np.searchsorted(self.h, hashes, side="left")
        hi = np.searchsorted(self.h, hashes, side="right")
        cnt = hi - lo
        t = int(cnt.sum())
        qi = np.repeat(np.arange(len(hashes)), cnt)
        if t == 0:
            return (qi, np.zeros(0, np.int64), np.zeros(0, np.uint8))
        idx = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)
                              if b > a])
        return qi, self.p[idx], self.s[idx]
