"""A numpy model of csrc/edgescan.cu, held to the plain scans and to the JAX
package with exact equality: the word-form polyA/T scans, the bit-sliced
longest run and the threshold-word TSO bailout, the window walk four codes
a word, the staging of a block's rows (the tail half reversed) and the
split of a read between two threads; and `chip_smoke.edge_scan_work`, the
count behind the kernel's bound, against a direct count.

The model follows the kernel's arithmetic on uint32 words (held in int64
arrays), lane by lane as arrays over reads, so a fault of the kernel's logic
shows here on the CPU; what only the card can show (that it compiles and
what it costs) is left to tests/test_torch_kernels_gpu.py and
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sicelore_tpu.models import readscan as jax_readscan
from sicelore_tpu.ops import edgescan as jax_eg
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.ops import edgescan as eg
from sicelore_tpu_torch.ops import edgescan_cuda as ec
from sicelore_tpu_torch.ops import scan
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig

M32 = 0xFFFFFFFF
E = eg.E
ROWB = 2 * E
RS = ROWB + 16                       # csrc/edgescan.cu RS
NR = 64                              # reads a block
THREADS = 2 * NR                     # two threads a read
NV = -(-NR * ROWB // 16 // THREADS)
NW = (E + 31) // 32
BIG = 10**9
KEY = 1 << 16
PAD = 5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _u(x):
    return np.asarray(x, np.int64) & M32


def fsl(p, d, s):
    """__funnelshift_l(p, d, s): the high word of (d:p) << s."""
    if s == 0:
        return _u(d)
    return ((d << s) | (p >> (32 - s))) & M32


def fsr(lo, hi, s):
    """__funnelshift_r(lo, hi, s): the low word of (hi:lo) >> s."""
    if s == 0:
        return _u(lo)
    return ((lo >> s) | (hi << (32 - s))) & M32


def low_bits(n):
    """Words with bits 0..n-1 set (n an array in 0..32)."""
    n = np.asarray(n, np.int64)
    return np.where(n >= 32, M32, (np.int64(1) << np.minimum(n, 31)) - 1)


def span_mask(lo, hi, w):
    a = np.clip(np.asarray(lo) - 32 * w, 0, 32)
    b = np.clip(np.asarray(hi) - 32 * w, 0, 32)
    return low_bits(b) & ~low_bits(a) & M32


def ffs(x):
    """1 + index of the lowest set bit, 0 for 0 (CUDA __ffs)."""
    x = np.asarray(x, np.int64)
    low = x & -x
    return np.where(x == 0, 0, np.log2(np.maximum(low, 1)).astype(np.int64)
                    + 1)


def top_bit(x):
    """Index of the highest set bit (31 - __clz); -1 for 0."""
    x = np.asarray(x, np.int64)
    return np.where(x == 0, -1, np.floor(np.log2(np.maximum(x, 1))
                                         ).astype(np.int64))


def words_at(rows, off):
    """Little-endian uint32 of bytes off..off+3 of every row (off [B])."""
    idx = np.asarray(off)[:, None] + np.arange(4)
    b = np.take_along_axis(rows, idx, axis=1).astype(np.int64)
    return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24


def differs4(v, base4):
    return (((((v ^ base4) + 0x7F7F7F7F) & 0x80808080) * 0x00204081)
            & M32) >> 28


def mask_word(rows, h0, w, base4, hl):
    nz = np.zeros(rows.shape[0], np.int64)
    for i in range(8):
        v = words_at(rows, np.full(rows.shape[0], h0 + 32 * w + 4 * i))
        nz |= differs4(v, base4) << (4 * i)
    return ~nz & M32 & span_mask(0, hl, w)


def dbl(d, p, s):
    c = 0
    r = []
    for x, pp in zip(d, p):
        y = fsl(pp, x, s)
        r.append(x ^ y ^ c)
        c = (x & y) | (c & (x ^ y))
    return r + [c]


def acc_add(acc, d, p, o):
    c = 0
    for i in range(5):
        x = acc[i]
        y = fsl(p[i], d[i], o) if i < len(d) else 0
        acc[i] = x ^ y ^ c
        c = (x & y) | (c & (x ^ y))


def pass_end(x, T, k, mc):
    """Bit i: the k columns ending at column i of this word hold >= mc set
    bits. T: the previous word's planes [p0, p1, p2, p3], updated."""
    z = np.zeros_like(x)
    d0 = [x]
    d1 = dbl(d0, T[0], 1) if k >= 2 else [z] * 2
    d2 = dbl(d1, T[1], 2) if k >= 4 else [z] * 3
    d3 = dbl(d2, T[2], 4) if k >= 8 else [z] * 4
    d4 = dbl(d3, T[3], 8) if k >= 16 else [z] * 5
    acc = [z] * 5
    o = 0
    if k & 16:
        acc_add(acc, d4, d4, 0)
        o = 16
    if k & 8:
        acc_add(acc, d3, T[3], o)
        o += 8
    if k & 4:
        acc_add(acc, d2, T[2], o)
        o += 4
    if k & 2:
        acc_add(acc, d1, T[1], o)
        o += 2
    if k & 1:
        acc_add(acc, d0, T[0], o)
    T[:] = [d0, d1[:2], d2[:3], d3[:4]]
    c = 32 - mc
    carry = z
    for i in range(5):
        carry = (acc[i] | carry) if (c >> i) & 1 else (acc[i] & carry)
    return carry


def polyscan(rows, h0, base, hl, p, stats=None):
    """The kernel's polyscan on the half at byte h0 of each staged row:
    (first, last) of the base codes of the run, -1 where none. `stats`
    collects the column where each lane stopped deciding."""
    B = rows.shape[0]
    k, mc, win_p = p.k, p.mc, p.win_p
    base4 = base * 0x01010101
    hl = np.asarray(hl, np.int64)
    first = np.full(B, -1, np.int64)
    last = np.full(B, -1, np.int64)
    lim_p = hl - k + 1
    live = lim_p > 0
    stop = np.zeros(B, np.int64)            # columns the scan decided on
    z = np.zeros(B, np.int64)
    T = [[z], [z] * 2, [z] * 3, [z] * 4]
    Mm1 = z
    M0 = mask_word(rows, h0, 0, base4, hl)
    pe0 = pass_end(M0, T, k, mc)
    j = np.full(B, -1, np.int64)
    for w in range(NW):
        M1 = mask_word(rows, h0, w + 1, base4, hl) if w + 1 < NW else z
        pe1 = pass_end(M1, T, k, mc)
        Pw = fsr(pe0, pe1, k - 1) & span_mask(0, lim_p, w)
        searching = live & (j < 0)
        cand = Pw & span_mask(0, win_p, w)
        give_up = searching & (cand == 0) & (32 * (w + 1) >= win_p)
        stop = np.where(give_up, np.minimum(win_p, lim_p) - 1 + k, stop)
        live &= ~give_up
        hit = searching & (cand != 0)
        jb = ffs(cand) - 1
        a = M0 & ((M32 << np.maximum(jb, 0)) & M32)
        first = np.where(hit, np.where(a != 0, 32 * w + ffs(a) - 1,
                                       32 * (w + 1) + ffs(M1) - 1), first)
        j = np.where(hit, 32 * w + jb, j)
        np_ = np.where(hit, ~Pw & ((M32 << np.maximum(jb, 0)) << 1) & M32,
                       ~Pw & M32)
        done = live & (j >= 0) & (np_ != 0)
        end = 32 * w + ffs(np_) - 2 + k - 1
        e1, e0 = end - 32 * (w + 1), end - 32 * w
        c1 = np.where(e1 < 0, 0, M1 & low_bits(np.clip(e1, 0, 31) + 1))
        c0 = M0 & low_bits(np.clip(e0, 0, 31) + 1)
        lst = np.where(c1 != 0, 32 * (w + 1) + top_bit(c1),
                       np.where(c0 != 0, 32 * w + top_bit(c0),
                                32 * (w - 1) + top_bit(Mm1)))
        last = np.where(done, lst, last)
        stop = np.where(done, end + 1, stop)
        live &= ~done
        Mm1, M0, pe0 = M0, M1, pe1
    assert not live.any()
    if stats is not None:
        stats.append(np.minimum(stop, hl))
    return first, last


def pair_table(peq, m, comp):
    """The kernel's 64-entry pair table of one pattern (complemented codes
    for the reversed tail): [64, 2] match masks, the pattern in the top m
    bits."""
    t = np.zeros((64, 2), np.int64)
    for e in range(64):
        for n, c in enumerate((e & 7, e >> 3)):
            if comp and c < 4:
                c = 3 - c
            t[e, n] = (int(peq[c, 0]) << (32 - m)) & M32 if c < 4 else 0
    return t


class Chain:
    def __init__(self, B, m):
        self.m = m
        self.PV = np.full(B, M32, np.int64)
        self.MV = np.zeros(B, np.int64)
        self.score = np.full(B, m, np.int64)
        self.best = np.full(B, m * KEY, np.int64)

    def step(self, eq, on):
        PV, MV = self.PV, self.MV
        Xv = eq | MV
        Xh = ((((eq & PV) + PV) & M32) ^ PV) | eq
        Ph = (MV | ~(Xh | PV)) & M32
        Mh = PV & Xh
        score = self.score + (Ph >> 31) - (Mh >> 31)
        Ph = (Ph << 1) & M32
        Mh = (Mh << 1) & M32
        self.PV = np.where(on, (Mh | ~(Xv | Ph)) & M32, PV)
        self.MV = np.where(on, Ph & Xv, MV)
        self.score = np.where(on, score, self.score)
        return self.score * KEY

    def ed(self):
        return np.where(self.best == self.m * KEY, self.m, self.best // KEY)

    def pos(self):
        return np.where(self.best == self.m * KEY, -1, self.best % KEY)


class SearchPass:
    def __init__(self, B, m):
        self.ch = Chain(B, m)

    def cols(self, eq, t, on):
        g = np.minimum.reduce([self.ch.step(eq[i], on) + i for i in range(4)])
        self.ch.best = np.where(on, np.minimum(self.ch.best, g + t),
                                self.ch.best)


class RunPass(SearchPass):
    """Myers and the longest run: counter planes c[0..4], the bits of
    31 - best as masks k[0..4]."""

    def __init__(self, B, m):
        super().__init__(B, m)
        self.c = [np.zeros(B, np.int64) for _ in range(5)]
        self.k = [np.full(B, M32, np.int64) for _ in range(5)]

    def run(self, eq, on):
        s = [(x << 1) & M32 for x in self.c]
        cy = s[0]
        c = [eq & ~s[0] & M32]
        for i in range(1, 5):
            c.append(eq & (s[i] ^ cy))
            cy = cy & s[i]
        g = c[0] & self.k[0]
        for i in range(1, 5):
            g = (c[i] & self.k[i]) | (g & (c[i] | self.k[i]))
        b = np.where(g != 0, M32, 0)
        k = []
        for i in range(5):
            k.append(self.k[i] ^ b)
            b = b & k[i]
        self.c = [np.where(on, x, y) for x, y in zip(c, self.c)]
        self.k = [np.where(on, x, y) for x, y in zip(k, self.k)]

    def best_run(self):
        K = sum(self.k[i] & (1 << i) for i in range(5))
        return 31 - K

    def cols(self, eq, t, on):
        g = []
        for i in range(4):
            g.append(self.ch.step(eq[i], on) + i)
            self.run(eq[i], on)
        self.ch.best = np.where(on, np.minimum(self.ch.best,
                                               np.minimum.reduce(g) + t),
                                self.ch.best)


class LevelRun:
    """The threshold-word longest run (the bound's form): levels R_l, the
    best = the highest level ever reached; `levels` are what the data
    needed (best + 1, at most m)."""

    def __init__(self, B, m):
        self.m = m
        self.R = [np.zeros(B, np.int64) for _ in range(m)]
        self.best = np.zeros(B, np.int64)

    def col(self, eq):
        for l in range(self.m - 1, 0, -1):
            self.R[l] = eq & (self.R[l - 1] << 1) & M32
        self.R[0] = eq
        for l in range(self.m):
            self.best = np.where(self.R[l] != 0, np.maximum(self.best, l + 1),
                                 self.best)

    def levels(self):
        return np.minimum(self.best + 1, self.m)


def bail_y(c1, c2, y):
    for a in range((c2 + 1) // 2, min(c1, c2)):
        b = c2 - a
        if b >= 1 and y in (a, b):
            return True
    return False


class BailPass(SearchPass):
    """Myers and the bailout; compiled: the form with c1, c2 compiled in
    (flags straight from the levels), else the general form (the column's
    best run counted from MAXL levels)."""

    def __init__(self, B, m, c1, c2, compiled):
        super().__init__(B, m)
        self.c1, self.c2, self.compiled = c1, c2, compiled
        self.L = c1 if compiled else 16
        self.R = [np.zeros(B, np.int64) for _ in range(self.L)]
        self.fge = [np.full(B, BIG, np.int64) for _ in range(16)]
        self.ok = np.zeros(B, bool)
        self.pairs = scan.bail_pairs(c1, c2)

    def bail(self, eq, t, on):
        R = [eq] + [eq & (self.R[l - 1] << 1) & M32
                    for l in range(1, self.L)]
        ok, fge = self.ok.copy(), [f.copy() for f in self.fge]
        if self.compiled:
            c1, c2 = self.c1, self.c2
            ok |= R[c1 - 1] != 0
            for y in range(1, c1):
                if bail_y(c1, c2, y):
                    fge[y - 1] = np.minimum(fge[y - 1],
                                            np.where(R[y - 1] != 0, t, BIG))
            for a in range((c2 + 1) // 2, min(c1, c2)):
                b = c2 - a
                if b < 1:
                    continue
                ok |= (R[a - 1] != 0) & (fge[b - 1] <= t - a)
                if b != a:
                    ok |= (R[b - 1] != 0) & (fge[a - 1] <= t - b)
        else:
            be = sum((r != 0).astype(np.int64) for r in R)
            ok |= be >= self.c1
            for q, (x, y) in enumerate(self.pairs):
                ok |= (be >= x) & (fge[q] <= t - x)
                fge[q] = np.where((fge[q] == BIG) & (be >= y), t, fge[q])
        self.R = [np.where(on, a, b) for a, b in zip(R, self.R)]
        self.fge = [np.where(on, a, b) for a, b in zip(fge, self.fge)]
        self.ok = np.where(on, ok, self.ok)

    def cols(self, eq, t, on):
        g = []
        for i in range(4):
            g.append(self.ch.step(eq[i], on) + i)
            self.bail(eq[i], t + i, on)
        self.ch.best = np.where(on, np.minimum(self.ch.best,
                                               np.minimum.reduce(g) + t),
                                self.ch.best)


def walk(rows, h0, s, lim, W, table, f, cols=None):
    """The kernel's walk of the sense windows (half at byte h0 of each row,
    column t at byte s + t, PAD outside [0, lim)) over the columns inside
    [lo, hi), four codes a group; rows with no such column take none.
    `cols` collects each window's column count."""
    B = rows.shape[0]
    s = np.asarray(s, np.int64)
    lim = np.broadcast_to(np.asarray(lim, np.int64), (B,))
    t0 = np.maximum(0, -s)
    n = np.minimum(W, lim - s) - t0
    if cols is not None:
        cols.append(np.maximum(n, 0))
    b = h0 + s + t0
    for i in range(0, max(int(n.max(initial=0)), 0), 4):
        on = n > i
        x = words_at(rows, np.where(on, b + i, 0))
        left = n - i
        keep = np.where(left < 4, (np.int64(1) << (8 * np.clip(left, 0, 4)))
                        - 1, M32)
        x = (x & keep) | (0x07070707 & ~keep & M32)
        e01 = table[(x | (x >> 5)) & 63]
        e23 = table[((x >> 16) | (x >> 21)) & 63]
        eq = (np.where(on, e01[:, 0], 0), np.where(on, e01[:, 1], 0),
              np.where(on, e23[:, 0], 0), np.where(on, e23[:, 1], 0))
        f.cols(eq, t0 + i, on)


def stage(codes, b0, nr, slack):
    """A block's staging: thread tid's j-th 16-byte load and store, the tail
    chunks mirrored and byte-reversed. Returns (rows [NR, RS] uint8,
    how often each byte of the block's span was loaded). `slack` fills the
    bytes no chunk stores."""
    flat = np.ascontiguousarray(codes).reshape(-1).view(np.uint8)
    sm = slack.copy()
    loads = np.zeros(max(nr, 0) * ROWB, np.int64)
    nv = nr * (ROWB // 16)
    for tid in range(THREADS):
        for j in range(NV):
            i = tid + j * THREADS
            if i >= nv:
                continue
            g = (b0 * ROWB + 16 * i)
            x = flat[g:g + 16]
            loads[16 * i:16 * i + 16] += 1
            r, c = divmod(i, ROWB // 16)
            d = c
            if c >= E // 16:
                d = E // 16 + (2 * E // 16 - 1 - c)
                x = x[::-1]
            sm[r, 16 * d:16 * d + 16] = x
    return sm, loads


def sides(nr):
    """(side, read) of every thread of a block that works: side 0 REV, 1
    FWD; thread tid takes side tid // NR of read tid % NR."""
    return [(tid // NR, tid % NR) for tid in range(THREADS)
            if tid % NR < nr]


def model_rows(codes, lens, p, stats=None, seed=0):
    """The kernel's rows [14 + bw, B] from the model, block by block."""
    B = codes.shape[0]
    rng = np.random.default_rng(seed)
    outs = []
    for b0 in range(0, B, NR):
        nr = min(NR, B - b0)
        slack = rng.integers(0, 8, (NR, RS)).astype(np.uint8)
        sm, _ = stage(codes, b0, nr, slack)
        outs.append(_block_rows(sm[:nr], lens[b0:b0 + nr], p, stats))
    if not outs:
        return np.zeros((eg.ROW_BC0 + p.bw, 0), np.int32)
    return np.concatenate(outs, axis=1)


def _block_rows(rows, lens, p, stats):
    B = rows.shape[0]
    five = p.is5p
    hl = np.minimum(np.asarray(lens, np.int64), E)
    st = {} if stats is not None else None
    tabs = {(n, h): pair_table(pq, m, h) for n, (pq, m) in
            enumerate(((p.peq_ad, p.m_ad), (p.peq_adc, p.m_adc),
                       (p.peq_tso, p.m_tso))) for h in (0, 1)}
    lims = {0: hl, 1: np.full(B, E, np.int64)}
    scan_cols = []
    first = [None, None]
    last = [None, None]
    res = [None, None]
    win_cols = {}
    for side in (0, 1):
        first[side], last[side] = polyscan(rows, side * E, 3 if side == 0
                                           else 0, hl, p, scan_cols)
        found = first[side] >= 0
        half = 1 - side if five else side
        s = np.zeros(B, np.int64) if five else first[side] - p.awin
        need = found | (five and side == 0)
        sp = SearchPass(B, p.m_ad)
        c = []
        walk(rows, half * E, np.where(need, s, -10 * E), lims[half], p.awin,
             tabs[(0, half)], sp, c)
        win_cols[f"adapter{side}"] = c[0]
        res[side] = (found, np.where(found, sp.ch.ed(), BIG), sp.ch.pos())
    rev_found, ed_r, pos_r = res[0]
    fwd_found, ed_f, pos_f = res[1]
    ok_f = fwd_found & (ed_f <= p.mm_ad)
    ok_r = rev_found & (ed_r <= p.mm_ad)
    stranded = ok_f | ok_r
    is_fwd = np.where(stranded, ok_f & (~ok_r | (ed_f <= ed_r)), fwd_found)
    us = is_fwd.astype(np.int64)
    uhalf = 1 - us if five else us
    ufirst = np.where(is_fwd, first[1], first[0])
    ad_pos = np.where(is_fwd, pos_f, pos_r)
    us_start = np.zeros(B, np.int64) if five else ufirst - p.awin
    out = np.zeros((eg.ROW_BC0 + p.bw, B), np.int64)
    rp = {h: RunPass(B, p.m_adc) for h in (0, 1)}
    c_used = np.zeros(B, np.int64)
    for h in (0, 1):            # each lane walks one half: split by half
        sel = uhalf == h
        c = []
        walk(rows, h * E, np.where(sel, us_start, -10 * E), lims[h], p.awin,
             tabs[(1, h)], rp[h], c)
        c_used += np.where(sel, c[0], 0)
    edc = np.where(uhalf == 1, rp[1].ch.ed(), rp[0].ch.ed())
    run = np.where(uhalf == 1, rp[1].best_run(), rp[0].best_run())
    out[7], out[8] = edc, run
    bcs = ad_pos + 1 - p.pad
    kmer = np.zeros(B, np.int64)
    kvalid = np.ones(B, bool)
    for i in range(p.bw):
        t = bcs + i
        q = us_start + t
        lim_u = np.where(uhalf == 1, E, hl)
        inside = (t >= 0) & (t < p.awin) & (q >= 0) & (q < lim_u)
        byte = rows[np.arange(B), np.clip(uhalf * E + q, 0, RS - 1)]
        c = np.where(inside, byte, PAD).astype(np.int64)
        c = np.where((uhalf == 1) & (c < 4), 3 - c, c)
        out[eg.ROW_BC0 + i] = c
        if p.pad <= i < p.pad + p.bc_len:
            kvalid &= c < 4
            kmer = ((kmer << 2) | np.minimum(c, 3)) & M32
    out[11], out[12], out[13] = kmer & 0xFFFF, kmer >> 16, kvalid
    ae5 = np.where(stranded, ad_pos, -1)
    t0 = ae5 + 1 + p.bc_len if five else np.zeros(B, np.int64)
    thalf = np.where(is_fwd, 0, 1)
    tso_ed = np.zeros(B, np.int64)
    tso_pos = np.zeros(B, np.int64)
    ok = np.zeros(B, bool)
    c_tso = np.zeros(B, np.int64)
    compiled = (p.k, p.mc, p.c1, p.c2) == (15, 12, 8, 12)
    for h in (0, 1):
        sel = thalf == h
        bp = BailPass(B, p.m_tso, p.c1, p.c2, compiled)
        c = []
        walk(rows, h * E, np.where(sel, t0, -10 * E), lims[h], p.twin,
             tabs[(2, h)], bp, c)
        tso_ed = np.where(sel, bp.ch.ed(), tso_ed)
        tso_pos = np.where(sel, bp.ch.pos(), tso_pos)
        ok = np.where(sel, bp.ok, ok)
        c_tso += np.where(sel, c[0], 0)
    tso_found = (tso_ed <= p.mm_tso) | ok
    rev_ts, rev_te = first[0], last[0]
    fwd_ps = np.where(fwd_found, E - 1 - last[1], -1)
    fwd_pe = np.where(fwd_found, E - 1 - first[1], -1)
    ad_ed = np.where(is_fwd, ed_f, ed_r)
    ae = ad_pos if five else np.where(is_fwd, fwd_pe + p.awin - pos_f,
                                      rev_ts - p.awin + pos_r)
    out[0], out[1] = is_fwd, stranded
    out[2] = np.where(is_fwd, fwd_found, rev_found)
    out[3] = np.where(is_fwd, fwd_ps, rev_te)
    out[4] = np.where(is_fwd, fwd_pe, rev_ts)
    out[5] = ae
    out[6] = np.where(stranded, np.minimum(ad_ed, eg.ED_SENTINEL),
                      eg.ED_SENTINEL)
    out[9] = np.where(tso_found, t0 + tso_pos + (p.off_tso - 1), -1)
    out[10] = tso_ed
    if stats is not None:
        stats.append({"scan_cols": scan_cols, "adapter_cols":
                      [win_cols["adapter0"], win_cols["adapter1"]],
                      "used_cols": c_used, "tso_cols": c_tso,
                      "ad_run": run})
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _cfgs(chem):
    cfg, tcfg = PipelineConfig(), TorchConfig()
    cfg.chemistry = tcfg.chemistry = chem
    return cfg, tcfg


def _params(chem, **kw):
    cfg = TorchConfig()
    cfg.chemistry = chem
    for key, val in kw.items():
        obj, name = key.split("__")
        setattr(getattr(cfg, obj), name, val)
    return eg.edge_params(cfg)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,frac,win_p", [(15, 0.75, 150), (9, 0.7, 60),
                                          (16, 0.5, 200), (2, 1.0, 31),
                                          (13, 0.9, 33)])
def test_word_scans_match_polyat_find(k, frac, win_p):
    """The word-form scans of the head (T) and of the reversed tail (A),
    against scan.polyat_find on the head and on the tail as the plain body
    calls it: runs at win_p, at tail_start, across word borders."""
    rng = np.random.default_rng(k + win_p)
    p = _params("3p", polyat__polyat_length=k,
                polyat__fraction_at_in_polyat=frac,
                polyat__window_search_for_polya=win_p)
    seqs, quals = chip_smoke.edge_set_reads(rng, "3p")
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    B = len(seqs)
    rows = np.zeros((B, RS), np.uint8)
    rows[:, :E] = codes[:, :E]
    rows[:, E:2 * E] = codes[:, E:][:, ::-1]
    rows[:, 2 * E:] = rng.integers(0, 8, (B, 16))
    hl = np.minimum(lens, E)
    h_first, h_last = polyscan(rows, 0, 3, hl, p)
    t_first, t_last = polyscan(rows, E, 0, hl, p)
    head, tail = torch.from_numpy(codes[:, :E]), torch.from_numpy(codes[:, E:])
    f, s, e = scan.polyat_find(head, torch.from_numpy(hl), base=3, k=k,
                               min_count=p.mc, window=win_p, from_end=False)
    np.testing.assert_array_equal(h_first, s.numpy())
    np.testing.assert_array_equal(h_last, e.numpy())
    np.testing.assert_array_equal(h_first >= 0, f.numpy())
    f, s, e = scan.polyat_find(tail, torch.full((B,), E, dtype=torch.int32),
                               base=0, k=k, min_count=p.mc, window=win_p,
                               from_end=True,
                               start_min=torch.from_numpy(E - hl))
    np.testing.assert_array_equal(np.where(t_first >= 0, E - 1 - t_last, -1),
                                  s.numpy())
    np.testing.assert_array_equal(np.where(t_first >= 0, E - 1 - t_first, -1),
                                  e.numpy())
    assert (h_first >= 0).sum() > 10 and (t_first >= 0).sum() > 10


def _run_windows(rng, m, B=96, W=110):
    """Windows [B, W] with planted exact runs of a random pattern of m
    bases (several lengths, one at each window edge), N and PAD, and rows
    of N only."""
    pat = rng.integers(0, 4, m).astype(np.int8)
    w = rng.integers(0, 4, (B, W)).astype(np.int8)
    for i in range(B):
        for _ in range(int(rng.integers(0, 3))):
            L = int(rng.integers(1, m + 1))
            a = int(rng.integers(0, m - L + 1))
            o = [0, W - L][i % 2] if i % 5 == 0 else int(rng.integers(0,
                                                                 W - L + 1))
            w[i, o:o + L] = pat[a:a + L]
    w[::7, 30] = 4
    w[::11, -20:] = PAD
    w[3::9] = 4                      # rows that match nothing
    return pat, w


def _walk_windows(windows, pat, f, comp=False):
    """Feed windows [B, W] to a pass as head windows of their own rows."""
    B, W = windows.shape
    rows = np.full((B, W + 16), 7, np.uint8)
    rows[:, :W] = windows
    peq = np.zeros((4, 1), np.uint32)
    for i, c in enumerate(pat):
        peq[c, 0] |= np.uint32(1 << i)
    walk(rows, 0, np.zeros(B, np.int64), W, W,
         pair_table(peq, len(pat), comp), f)


@pytest.mark.parametrize("m", range(1, 32))
def test_longest_run_words_match_match_run_stats(m):
    """The bit-sliced counter (the kernel's) and the threshold words (the
    bound's) against match_run_stats' best, m = 1..31."""
    rng = np.random.default_rng(m)
    pat, w = _run_windows(rng, m)
    ref, _ = scan.match_run_stats(torch.from_numpy(w), pat, m)
    rp = RunPass(len(w), m)
    _walk_windows(w, pat, rp)
    np.testing.assert_array_equal(rp.best_run(), ref.numpy())
    lr = LevelRun(len(w), m)
    peq_rows = [(int(sum(1 << i for i, c in enumerate(pat) if c == b))
                 << (32 - m)) & M32 for b in range(4)]
    for j in range(w.shape[1]):
        lr.col(np.asarray([peq_rows[c] if c < 4 else 0 for c in w[:, j]],
                          np.int64))
    np.testing.assert_array_equal(lr.best, ref.numpy())
    assert (ref.numpy() == m).any() or m > 20


@pytest.mark.parametrize("c1", range(2, 17))
def test_bailout_threshold_words_match_run_bailout(c1):
    """Both forms of the bailout (c1, c2 compiled in; the general one)
    against run_bailout for every pair set bail_pairs(c1, c2) takes,
    c2 = c1 .. 2 c1 (no pair beyond), with the TSO's own pattern and m 16,
    and with m 31."""
    rng = np.random.default_rng(100 + c1)
    mixed = 0
    for m in (16, 31):
        pat, w = _run_windows(rng, m, B=64, W=90)
        for c2 in range(c1, 2 * c1 + 1):
            ref = scan.run_bailout(torch.from_numpy(w), pat, m, c1, c2).numpy()
            for compiled in (True, False):
                bp = BailPass(len(w), m, c1, c2, compiled)
                _walk_windows(w, pat, bp)
                np.testing.assert_array_equal(bp.ok, ref,
                                              err_msg=f"{c1} {c2} {compiled}")
            mixed += 0 < ref.sum() < len(ref)
    assert mixed


@pytest.mark.parametrize("B", [0, 1, 37, 129])
def test_staging_and_sides_cover_every_byte_once(B):
    """Every byte of a block's span is loaded once and lands where the
    kernel reads it (the head as it is, the tail reversed at byte E); every
    read is taken by one thread a side."""
    rng = np.random.default_rng(B)
    codes = rng.integers(0, 6, (B, ROWB)).astype(np.int8)
    for b0 in range(0, max(B, 1), NR):
        nr = max(0, min(NR, B - b0))
        slack = np.full((NR, RS), 255, np.uint8)
        sm, loads = stage(codes, b0, nr, slack)
        assert (loads == 1).all()
        for r in range(nr):
            np.testing.assert_array_equal(sm[r, :E], codes[b0 + r, :E])
            np.testing.assert_array_equal(sm[r, E:2 * E],
                                          codes[b0 + r, E:][::-1])
        assert (sm[nr:] == 255).all() and (sm[:, 2 * E:] == 255).all()
        got = sides(nr)
        assert sorted(got) == [(s, r) for s in (0, 1) for r in range(nr)]


@pytest.mark.parametrize("chem", ["3p", "5p"])
@pytest.mark.parametrize("B", [0, 1, 37, 129])
def test_kernel_model_matches_plain_body(chem, B):
    """The model's rows, block by block with random slack bytes, equal
    edge_scan2 on CPU tensors (the plain body), at B = 0, 1, 37, 129."""
    rng = np.random.default_rng(B + (chem == "5p"))
    seqs, quals = chip_smoke.edge_set_reads(rng, chem, n=max(B, 40))
    idx = rng.permutation(len(seqs))[:B]
    seqs, quals = [seqs[i] for i in idx], [quals[i] for i in idx]
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    p = _params(chem)
    assert p.kernel_unsupported == ""
    ref = ec.edge_scan2(torch.from_numpy(codes), torch.from_numpy(lens),
                        p).numpy()
    got = model_rows(codes, lens, p, seed=B)
    assert got.shape == ref.shape
    for r in range(ref.shape[0]):
        bad = np.nonzero(ref[r] != got[r])[0]
        assert len(bad) == 0, (chem, r, bad[:5], ref[r, bad[:5]],
                               got[r, bad[:5]])


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_kernel_model_matches_jax_body(chem):
    """The model's rows on the edge reads equal make_edge_scan2_jnp's."""
    rng = np.random.default_rng(7 if chem == "3p" else 8)
    cfg, tcfg = _cfgs(chem)
    seqs, quals = chip_smoke.edge_set_reads(rng, chem)
    head, tail, _, lens, _ = jax_eg.encode_two_half_int8(seqs, quals)
    model = jax_readscan.ReadScanModel(cfg)
    body = jax_eg.make_edge_scan2_jnp(cfg)
    ref = np.asarray(body(jnp.asarray(head), jnp.asarray(tail),
                          jnp.asarray(lens), model.peq_ad, model.peq_adc,
                          model.peq_tso))
    codes, _, lens2, _ = eg.encode_two_half(seqs, quals)
    got = model_rows(codes, lens2, eg.edge_params(tcfg))
    np.testing.assert_array_equal(got, ref)
    assert ref[eg.ROW_STRANDED].mean() > 0.3


@pytest.mark.parametrize("chem,kw", [
    ("3p", {"polyat__polyat_length": 9,
            "polyat__fraction_at_in_polyat": 0.7}),
    ("5p", {"tso5p__min_tso_consecutive_matches": 5,
            "tso5p__min_tso_two_best_consecutive_matches": 7}),
    ("3p", {"tso3p__min_tso_consecutive_matches": 16,
            "tso3p__min_tso_two_best_consecutive_matches": 20})])
def test_kernel_model_general_path_matches_plain(chem, kw):
    """Configs off the compiled default (k, mc, c1, c2 read at run time)."""
    rng = np.random.default_rng(len(kw) + len(chem))
    seqs, quals = chip_smoke.edge_set_reads(rng, chem, n=60)
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    p = _params(chem, **kw)
    assert p.kernel_unsupported == ""
    ref = ec.edge_scan2(torch.from_numpy(codes), torch.from_numpy(lens),
                        p).numpy()
    np.testing.assert_array_equal(model_rows(codes, lens, p), ref)


def test_kernel_params_layout():
    """The parameter array has the struct's length and field order."""
    p = _params("5p")
    a = ec.kernel_params(p)
    assert a.dtype == np.int32 and a.size == 20 + 12 + 32
    assert list(a[:20]) == [E, p.k, p.mc, p.win_p, p.awin, p.twin, p.m_ad,
                            p.m_adc, p.m_tso, p.mm_ad, p.mm_tso, p.off_tso,
                            p.c1, 3, p.pad, p.bc_len, p.bw,
                            eg.ROW_BC0 + p.bw, 1, p.c2]
    assert list(a[32:35]) == [5, 6, 7] and list(a[48:51]) == [7, 6, 5]
    assert ec.kernel_params(p) is a


def _direct_count(codes, lens, p):
    """The bound's count from first principles, read by read: the columns
    each scan decides on (a plain loop over window starts), the window
    columns inside the read, the longest runs by a scalar recurrence."""
    B = len(lens)
    meta = eg.edge_scan2_plain(torch.from_numpy(codes[:, :E]),
                               torch.from_numpy(codes[:, E:]),
                               torch.from_numpy(lens), p).numpy()
    ops = 0
    cols_read = 0
    pairs = len(scan.bail_pairs(p.c1, p.c2))
    for b in range(B):
        hl = min(int(lens[b]), E)
        halves = (codes[b, :E], codes[b, E:][::-1])
        scan_cols, first = [], []
        for h, base in ((0, 3), (1, 0)):
            x = (halves[h] == base).astype(int)
            x[hl:] = 0
            passing = [p_ <= hl - p.k and x[p_:p_ + p.k].sum() >= p.mc
                       for p_ in range(E - p.k + 1)]
            j = next((q for q in range(min(p.win_p, E)) if passing[q]), -1)
            if hl - p.k + 1 <= 0:
                cols = 0
            elif j < 0:
                cols = min(p.win_p, hl - p.k + 1) - 1 + p.k
            else:
                stop = next(q for q in range(j + 1, E - p.k + 2)
                            if q > E - p.k or not passing[q])
                cols = stop + p.k - 1
            scan_cols.append(min(cols, hl))
            first.append(int(np.nonzero(x[j:])[0][0]) + j if j >= 0 else -1)
        words = sum(-(-c // 32) for c in scan_cols)
        lim = (hl, E)

        def inside(half, s, W):
            return max(0, min(W, lim[half] - s) - max(0, -s))

        five = p.is5p
        spans = [[(0, scan_cols[0])], [(0, scan_cols[1])]]
        myers = 0
        for side in (0, 1):
            half = 1 - side if five else side
            s = 0 if five else first[side] - p.awin
            if first[side] >= 0 or (five and side == 0):
                n = inside(half, s, p.awin)
                myers += n
                spans[half].append((s + max(0, -s), s + max(0, -s) + n))
        is_fwd = bool(meta[eg.ROW_IS_FWD, b])
        us = int(is_fwd)
        uhalf = 1 - us if five else us
        us_s = 0 if five else first[us] - p.awin
        n_used = inside(uhalf, us_s, p.awin)
        spans[uhalf].append((us_s + max(0, -us_s),
                             us_s + max(0, -us_s) + n_used))
        t0 = (int(meta[eg.ROW_AE, b]) if meta[eg.ROW_STRANDED, b] else -1) \
            + 1 + p.bc_len if five else 0
        th = 0 if is_fwd else 1
        n_tso = inside(th, t0, p.twin)
        spans[th].append((t0 + max(0, -t0), t0 + max(0, -t0) + n_tso))
        myers += n_used + n_tso
        run = int(meta[eg.ROW_AD_RUN, b])
        levels = min(run + 1, p.m_adc)
        run_ops = min(2 * levels, chip_smoke.EDGE_RUN_BITSLICE_OPS,
                      3 * p.m_adc)
        # the TSO window's best run, by a scalar recurrence
        hb = halves[th]
        w5 = [hb[t0 + t] if 0 <= t0 + t < lim[th] else PAD
              for t in range(p.twin)]
        if th == 1:
            w5 = [3 - c if c < 4 else c for c in w5]
        tso = p.tso_codes
        best, prev = 0, [0] * p.m_tso
        for c in w5:
            cur = [(prev[i - 1] + 1 if i else 1) if c == tso[i] else 0
                   for i in range(p.m_tso)]
            best, prev = max(best, max(cur)), cur
        tl = min(best + 1, p.c1)
        ops += (words * chip_smoke.EDGE_WORD_OPS
                + myers * chip_smoke.MYERS_OPS + n_used * run_ops
                + n_tso * (2 * tl + chip_smoke.EDGE_PAIR_OPS * pairs))
        for sp in spans:
            cover = np.zeros(E, bool)
            for a, e in sp:
                cover[max(a, 0):max(e, 0)] = True
            cols_read += int(cover.sum())
    n_bytes = cols_read + 4 * B + 4 * B * (eg.ROW_BC0 + p.bw)
    return ops, n_bytes


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_edge_bound_count_matches_direct_count(chem):
    """chip_smoke.edge_scan_work (the bound's operations and bytes, from
    torch ops over the whole chunk) against a direct count, read by read;
    and the model's own column counts agree with both."""
    rng = np.random.default_rng(55 if chem == "3p" else 56)
    seqs, quals = chip_smoke.edge_set_reads(rng, chem, n=60)
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    p = _params(chem)
    work = chip_smoke.edge_scan_work(torch.from_numpy(codes),
                                     torch.from_numpy(lens), p)
    ops, n_bytes = _direct_count(codes, lens, p)
    assert (work["operations"], work["bytes"]) == (ops, n_bytes)
    stats = []
    model_rows(codes, lens, p, stats=stats)
    assert work["scan_columns"] == sum(int(c.sum()) for s in stats
                                       for c in s["scan_cols"])
    assert work["window_columns"] == sum(
        int(s["adapter_cols"][0].sum() + s["adapter_cols"][1].sum()
            + s["used_cols"].sum() + s["tso_cols"].sum()) for s in stats)
    assert work["operations"] > 1000 * len(seqs)
