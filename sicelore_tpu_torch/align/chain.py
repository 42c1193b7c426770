"""Anchor chaining with intron-tolerant gap costs (minimap2 `-x splice`).

Anchors are (query_pos, global_ref_pos) minimizer matches per strand; the
chain DP scores colinear sets, charging small query/diagonal gaps linearly
and reference gaps up to max_intron logarithmically (so a 10 kb intron
does not break a chain). Vectorized over a bounded predecessor window per
anchor (minimap2's max_chain_iter analog).
"""
from __future__ import annotations

import numpy as np

from sicelore_tpu_torch.align import index as idx

MAX_INTRON = 200_000
assert MAX_INTRON < idx.GUARD  # never chain across a contig boundary
PRED_WINDOW = 48        # predecessors examined per anchor
MIN_CHAIN_SCORE = 40
MIN_ANCHORS = 3


def read_anchors(seq: bytes, mindex: "idx.MinimizerIndex"):
    """-> {strand: (q [n], g [n])} anchors per alignment strand.

    Read minimizer strand s_q vs indexed strand s_g: equal -> the read
    aligns to the forward genome strand, different -> reverse."""
    h, qpos, qstr = idx.minimizers(seq, mindex.k, mindex.w)
    qi, gpos, gstr = mindex.lookup(h)
    if len(gpos) == 0:
        return {}
    q = qpos[qi].astype(np.int64)
    same = (qstr[qi] == gstr)
    out = {}
    for strand, m in ((0, same), (1, ~same)):
        if m.any():
            qq, gg = q[m], gpos[m]
            if strand == 1:
                # reverse alignment: anchor query coords flip so colinear
                # anchors stay increasing in both q and g
                qq = (len(seq) - mindex.k) - qq
            order = np.lexsort((qq, gg))
            out[strand] = (qq[order], gg[order])
    return out


def _chain_dp(q: np.ndarray, g: np.ndarray, k: int):
    """Score every anchor as a chain end -> (f float[n], parent int[n]).
    Native single-pass C when available (the per-read Python loop was the
    aligner's scaling bottleneck — measured 71x);
    numpy fallback is the parity oracle."""
    n = len(q)
    from sicelore_tpu_torch.io import native as _native
    ext = _native.get_hostenc()
    if ext is not None and hasattr(ext, "chain_dp") and n:
        fb, pb = ext.chain_dp(
            np.ascontiguousarray(q, np.int64),
            np.ascontiguousarray(g, np.int64), n, k, PRED_WINDOW,
            MAX_INTRON)
        return (np.frombuffer(fb, np.float32).astype(np.float64),
                np.frombuffer(pb, np.int32).astype(np.int64))
    f = np.full(n, float(k))
    parent = np.full(n, -1, np.int64)
    for i in range(1, n):
        j0 = max(0, i - PRED_WINDOW)
        dq = q[i] - q[j0:i]
        dg = g[i] - g[j0:i]
        ok = (dq > 0) & (dg > 0) & (dg < MAX_INTRON)
        if not ok.any():
            continue
        gap = np.abs(dg - dq)
        # splice-tolerant: big ref gaps cost log, small diagonal gaps
        # cost linearly
        cost = np.where(gap < 64, 0.5 * gap,
                        16.0 + 2.0 * np.log2(np.maximum(gap, 1)))
        match = np.minimum(np.minimum(dq, dg), k).astype(float)
        cand = f[j0:i] + match - cost
        cand = np.where(ok, cand, -1e18)
        b = int(np.argmax(cand))
        if cand[b] > f[i]:
            f[i] = cand[b]
            parent[i] = j0 + b
    return f, parent


def chain_anchors(q: np.ndarray, g: np.ndarray, k: int = idx.K):
    """Single best chain; returns (best_score, anchor indices,
    second_best_score)."""
    n = len(q)
    if n == 0:
        return 0.0, np.zeros(0, np.int64), 0.0
    f, parent = _chain_dp(q, g, k)
    best = int(np.argmax(f))
    chain = []
    node = best
    while node >= 0:
        chain.append(node)
        node = parent[node]
    chain.reverse()
    # second best over anchors OUTSIDE the primary chain's span (a prefix
    # of the primary scores nearly as high and would zero the mapq)
    qlo, qhi = q[chain[0]], q[chain[-1]]
    glo, ghi = g[chain[0]], g[chain[-1]]
    outside = ((q < qlo) | (q > qhi)) & ((g < glo - 1000) | (g > ghi + 1000))
    second = float(f[outside].max()) if outside.any() else 0.0
    return float(f[best]), np.asarray(chain, np.int64), second


def extract_chains(f: np.ndarray, parent: np.ndarray, max_chains: int = 3):
    """Peel the top chains from a scored DP (minimap2's used-anchor
    marking): repeatedly trace from the highest unused end score,
    stopping at anchors already claimed — so a fusion read's two loci
    (or a secondary locus) come out as separate chains."""
    n = len(f)
    used = np.zeros(n, bool)
    chains = []
    order = np.argsort(-f, kind="stable")
    for start in order:
        start = int(start)
        if used[start] or f[start] < MIN_CHAIN_SCORE:
            continue
        node, chain = start, []
        while node >= 0 and not used[node]:
            chain.append(node)
            node = int(parent[node])
        if len(chain) < MIN_ANCHORS:
            for c in chain:
                used[c] = True
            continue
        chain.reverse()
        used[np.asarray(chain)] = True
        # truncated trace (ran into a used anchor): score only the part
        base = float(f[node]) if node >= 0 else 0.0
        chains.append((float(f[start]) - base,
                       np.asarray(chain, np.int64)))
        if len(chains) >= max_chains:
            break
    return chains


def best_chains(seq: bytes, mindex: "idx.MinimizerIndex",
                max_chains: int = 3):
    """-> list of (score, second, strand, q [c], g [c]) sorted by score
    desc (primary first; later entries are distinct loci/parts — the
    aligner emits them as secondary/supplementary records); empty when
    the read has no chainable anchors."""
    res = []
    for strand, (q, g) in read_anchors(seq, mindex).items():
        if not len(q):
            continue
        f, parent = _chain_dp(q, g, mindex.k)
        for score, chain in extract_chains(f, parent, max_chains):
            qlo, qhi = q[chain[0]], q[chain[-1]]
            glo, ghi = g[chain[0]], g[chain[-1]]
            outside = (((q < qlo) | (q > qhi))
                       & ((g < glo - 1000) | (g > ghi + 1000)))
            second = float(f[outside].max()) if outside.any() else 0.0
            res.append((score, second, strand, q[chain], g[chain]))
    res.sort(key=lambda r: -r[0])
    return res


def mapq(score: float, second: float) -> int:
    """minimap2-style mapq from the primary/secondary score gap."""
    if score <= 0:
        return 0
    r = max(0.0, 1.0 - max(second, 0.0) / score)
    return int(min(60, 40 * r * min(1.0, score / 100) + 20 * r))
