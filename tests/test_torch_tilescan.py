"""The port's plain tile chimera scan against sicelore_tpu's jnp tile inner
(_make_internal_tile_inner) on build_tiles rows: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from sicelore_tpu.models import readscan as jax_readscan
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig
from sicelore_tpu_torch.models import readscan
from sicelore_tpu_torch.ops import editdist
from sicelore_tpu_torch.ops import tilescan_cuda as ts
from sicelore_tpu_torch.utils import dna


def _long_reads(rng):
    """Chimeras (single and triple fusions), 2-6 kb reads, reads with N
    inside their tiles, and reads just above the interior threshold."""
    wl = synth.make_whitelist(rng, 16)
    seqs = []
    for i in range(10):
        seqs.append(synth.make_chimera(rng, wl[i % 16], wl[(i + 3) % 16],
                                       cdna_len=int(rng.integers(300, 900)),
                                       error_rate=0.04)["seq"])
    for i in range(6):      # three molecules: two junctions in one tile
        a = synth.make_chimera(rng, wl[i], wl[i + 1], cdna_len=150)["seq"]
        seqs.append(a + synth.make_read(rng, wl[i + 2], cdna_len=150)["seq"])
    for i in range(10):
        seqs.append(synth.make_read(rng, wl[i % 16],
                                    cdna_len=int(rng.integers(2000, 6000)),
                                    error_rate=0.05,
                                    reverse=bool(i % 2))["seq"])
    for i in range(8):
        s = bytearray(synth.make_chimera(rng, wl[i], wl[i + 5],
                                         cdna_len=500)["seq"])
        for p in rng.integers(100, len(s) - 100, 4).tolist():
            s[p] = ord("N")
        s[len(s) // 2 - 30:len(s) // 2 - 25] = b"NNNNN"
        seqs.append(bytes(s))
    seqs.append(synth.random_seq(rng, 330).encode())
    seqs.append(b"A" * 400 + synth.random_seq(rng, 200).encode())
    return seqs


def test_plain_tile_scan_matches_jnp_inner():
    rng = np.random.default_rng(17)
    cfg = PipelineConfig()
    seqs = _long_reads(rng)
    rows, read_idx, g0s = readscan.build_tiles(seqs, TorchConfig())
    rows_j, ri_j, g0_j = jax_readscan.build_tiles(seqs, cfg)
    np.testing.assert_array_equal(rows, rows_j)
    np.testing.assert_array_equal(read_idx, ri_j)
    np.testing.assert_array_equal(g0s, g0_j)
    assert len(rows) > 60

    model = jax_readscan.ReadScanModel(cfg)
    inner = jax_readscan._make_internal_tile_inner(cfg)
    ref = np.asarray(inner(jnp.asarray(rows), model.peq_adc)).astype(np.int32)
    got = ts.tile_scan(torch.tensor(rows),
                       ts.tile_params(TorchConfig())).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert (got[0] == 1).sum() >= 10 and (got[0] >= 2).any()


def test_tile_splits_through_model_match_jax():
    """ReadScanModel.internal_tiles_async/finish_internal_tiles: the same
    per-read splits and discards as the JAX model on the CPU."""
    rng = np.random.default_rng(18)
    cfg = PipelineConfig()
    seqs = _long_reads(rng)
    jm = jax_readscan.ReadScanModel(cfg)
    ref = jm.finish_internal_tiles(jm.internal_tiles_async(seqs))
    m = readscan.ReadScanModel(TorchConfig(), device="cpu")
    before = ts.tile_scan_plain.launches
    got = m.finish_internal_tiles(m.internal_tiles_async(seqs))
    assert got == ref
    assert ts.tile_scan_plain.launches == before + 1
    assert len(got[0]) >= 5 and len(got[1]) >= 1
    assert m.internal_tiles_async([b"ACGT" * 20]) is None


# ---- a numpy model of csrc/tilescan.cu: the word form of the detection and
# the block-wide site compaction, held to the plain scan and to the JAX
# inner on chip_smoke.py's edge-case tiles ----

TPB, WARPS, SITES = 32, 4, 6          # csrc/tilescan.cu TPB, THREADS / 32
FULL = np.uint32(0xFFFFFFFF)


def _compact8(f):
    f = ((f >> 4) | (f << 1)) & 0x03030303
    f = (f | (f >> 6)) & 0x000F000F
    return (f | (f >> 12)) & 0xFF


def _word_masks(rows):
    """A and T masks [T, 32] uint32: bit i of word w is column 32w + i."""
    v = np.ascontiguousarray(rows[:, :512]).view("<u4").reshape(-1, 32, 4)
    v1, v2 = v >> 1, v >> 2
    a = _compact8(~(v | v1 | v2) & 0x11111111)
    t = _compact8(v & v1 & ~v2 & 0x11111111)
    sh = np.asarray([0, 8, 16, 24], np.uint32)
    return (np.bitwise_or.reduce(a << sh, axis=-1),
            np.bitwise_or.reduce(t << sh, axis=-1))


def _next(d):
    """__shfl_down_sync(d, 1) over the 32 lanes (last axis): the last lane
    gets its own value back."""
    return np.concatenate([d[..., 1:], d[..., -1:]], axis=-1)


def _funnel_r(lo, hi, s):
    return ((hi.astype(np.uint64) << np.uint64(32) | lo) >> np.uint64(s)
            ).astype(np.uint32)


def _passing(x, k, mc):
    """[..., 32] lane words -> bit i of lane w: columns 32w + i .. + k - 1
    hold >= mc set bits, by the kernel's bit-sliced doubling (each plane
    extended by the next lane's, as the shuffles do) and carry test.
    Positions past 1,024 - k are not defined."""
    if mc <= 0:
        return np.full_like(x, FULL)
    if mc > k:
        return np.zeros_like(x)
    levels = [[x]]
    for s in (1, 2, 4, 8):
        if k >= 2 * s:
            d, c, r = levels[-1], np.zeros_like(x), []
            for p in d:
                y = _funnel_r(p, _next(p), s)
                r.append(p ^ y ^ c)
                c = (p & y) | (c & (p ^ y))
            levels.append(r + [c])
    acc = [np.zeros_like(x) for _ in range(5)]
    o = 0
    for lv in reversed(range(len(levels))):
        if (k >> lv) & 1:
            d, c = levels[lv], np.zeros_like(x)
            for i in range(5):
                y = (_funnel_r(d[i], _next(d[i]), o) if i < len(d)
                     else np.zeros_like(x))
                a = acc[i]
                acc[i] = a ^ y ^ c
                c = (a & y) | (c & (a ^ y))
            o += 1 << lv
    c, carry = 32 - mc, np.zeros_like(x)
    for i in range(5):
        carry = (acc[i] | carry) if (c >> i) & 1 else (acc[i] & carry)
    return carry


def _span_mask(lo, hi):
    """[T, 32] uint32: bits i of word w with lo <= 32w + i < hi."""
    w = 32 * np.arange(32)[None, :]
    a = np.clip(lo[:, None] - w, 0, 32).astype(np.uint64)
    b = np.clip(hi[:, None] - w, 0, 32).astype(np.uint64)
    below = lambda n: ((np.uint64(1) << n) - np.uint64(1)).astype(np.uint32)
    return below(b) & ~below(a)


def _meta(rows):
    mb = rows[:, 512:].astype(np.int64)
    return (mb[:, 0] | mb[:, 1] << 8, mb[:, 2] | mb[:, 3] << 8,
            mb[:, 4] | mb[:, 5] << 8,
            rows[:, 520:524].copy().view("<i4")[:, 0],
            rows[:, 524:528].copy().view("<i4")[:, 0])


def _rising_edges(rows, p):
    """The kernel's rising-edge words [T, 32] per direction (A, T)."""
    A, Tm = _word_masks(rows)
    own_lo, own_hi, tlen, _, _ = _meta(rows)
    own = _span_mask(own_lo, np.minimum(own_hi, tlen - p.k + 1))
    out = []
    for m in (A, Tm):
        ok = _passing(m, p.k, p.mc) & own
        prev = np.zeros_like(ok)
        prev[:, 1:] = ok[:, :-1] >> 31
        out.append(ok & ~((ok << 1) | prev))
    return out


def _first_sites(rs, K=ts.K_TILE_SITES):
    """The ballot / __ffs walk: the first K set bits in column order."""
    s = []
    for lane in range(32):
        r = int(rs[lane])
        while r and len(s) < K:
            s.append(32 * lane + (r & -r).bit_length() - 1)
            r &= r - 1
    return s + [-1] * (K - len(s))


def _kernel_model(rows, p, append_order=None):
    """[3, T] int32 as csrc/tilescan.cu computes it, and the number of
    confirms it runs. `append_order(block)`: the order in which the warps
    append their tiles' sites to the block's list (atomicAdd on the card:
    any order; the outputs must not depend on it)."""
    T = len(rows)
    rsA, rsT = _rising_edges(rows, p)
    codes = ts._unpack(torch.from_numpy(rows))[0].numpy()
    _, _, tlen, g0, rlen = _meta(rows)
    comp = np.asarray(dna._COMP, np.int8)
    out = np.zeros((3, T), np.int64)
    n_confirms = 0
    Wi, m = ts.WI_CONFIRM, p.m_adc
    for t0 in range(0, T, TPB):
        ntl = min(TPB, T - t0)
        spos = np.full(ntl * SITES, -1)
        res = np.full(ntl * SITES, None, dtype=object)
        lst = []
        tiles = [lt for w in range(WARPS) for lt in range(w, ntl, WARPS)]
        for lt in (append_order(tiles) if append_order else tiles):
            sites = _first_sites(rsA[t0 + lt]) + _first_sites(rsT[t0 + lt])
            for i, s in enumerate(sites):
                spos[lt * SITES + i] = s
                if s >= 0:
                    lst.append(lt * SITES + i)
        n_confirms += len(lst)
        if lst:
            wins = np.empty((len(lst), Wi), np.int8)
            for j, slot in enumerate(lst):
                lt, i = divmod(slot, SITES)
                s, tl = spos[slot], tlen[t0 + lt]
                rc = i < ts.K_TILE_SITES
                q = (s + Wi - 1 - np.arange(Wi)) if rc else (s - Wi
                                                              + np.arange(Wi))
                c = np.where((q >= 0) & (q < tl),
                             codes[t0 + lt][np.clip(q, 0, 1023)], dna.PAD)
                wins[j] = comp[c] if rc else c
            ed, pos = editdist.myers_sweep(torch.from_numpy(wins),
                                           p.peq_adc, m)
            for j, slot in enumerate(lst):
                lt, i = divmod(slot, SITES)
                s, e, ps = spos[slot], int(ed[j, 0]), int(pos[j, 0])
                spl = (s + Wi - 1 - ps + m if i < ts.K_TILE_SITES
                       else s - Wi + ps - (m - 1))
                gp = g0[t0 + lt] + spl
                if e <= p.edmax and 50 < gp < rlen[t0 + lt] - 50:
                    res[slot] = spl
        for lt in range(ntl):
            v = list(res[lt * SITES:(lt + 1) * SITES])
            kept = []
            for i, x in enumerate(v):
                if x is not None and x not in v[:i]:
                    kept.append(x)
            out[:, t0 + lt] = (len(kept), *(kept + [-1, -1])[:2])
    return out.astype(np.int32), n_confirms


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8, 11, 15, 16, 22, 31])
def test_word_form_window_test_matches_rolling_count(k):
    """The bit-sliced doubling across lanes and the carry test against a
    direct count of every k-window of a tile, at every threshold, on random
    masks with long runs across lane boundaries."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 2**32, (8, 32), dtype=np.uint64).astype(np.uint32)
    x[:3, ::3] |= np.uint32(0xFFFF0000)
    x[:3, 1::3] |= np.uint32(0x0000FFFF)
    bits = ((x[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(
        8, 1024)
    npos = 1024 - k + 1
    counts = np.stack([bits[:, i:i + k].sum(1) for i in range(npos)], 1)
    for mc in range(0, k + 2):
        got = _passing(x, k, mc)
        gb = ((got[..., None] >> np.arange(32, dtype=np.uint32)) & 1
              ).reshape(8, 1024)[:, :npos]
        np.testing.assert_array_equal(gb, (counts >= mc).astype(gb.dtype),
                                      err_msg=str(mc))


def test_tile_edge_rows_cover_the_cases():
    """chip_smoke.py's edge tiles hold 0, 1, 3 and more than 3 rising edges
    a direction, sites at own_lo, own_hi - 1 and tlen - k, confirm windows
    off both tile ends, an all-PAD tile and confirmed splits."""
    rows = chip_smoke.tile_edge_rows(129)
    p = ts.tile_params(TorchConfig())
    sA, sT = (s.numpy() for s in ts.tile_sites_plain(torch.from_numpy(rows),
                                                     p))
    own_lo, own_hi, tlen, _, _ = _meta(rows)
    n_edges = [np.vectorize(lambda w: bin(w).count("1"))(rs).sum(1)
               for rs in _rising_edges(rows, p)]
    for n in n_edges:
        assert {0, 1, 3} <= set(n.tolist()) and (n > 3).any()
    sites = np.concatenate([sA, sT], 1)
    for where in (own_lo, own_hi - 1, tlen - p.k):
        assert (sites == where[:, None]).any()
    assert ((sA >= 0) & (sA + ts.WI_CONFIRM > tlen[:, None])).any()
    assert ((sT >= 0) & (sT < ts.WI_CONFIRM)).any()
    assert (tlen == 0).any()
    out = ts.tile_scan_plain(torch.from_numpy(rows), p).numpy()
    assert (out[0] == 1).any() and (out[0] == 2).any()


@pytest.mark.parametrize("T", [1, 33, 129])
def test_kernel_model_matches_plain_and_jnp_inner(T):
    """The word-form detection and the block-wide compaction (in two
    append orders) give the plain scan's rows and the JAX inner's, T = 1
    (one partial block), 33 and 129 (ragged last blocks)."""
    rows = chip_smoke.tile_edge_rows(129)[:T]
    cfg = PipelineConfig()
    p = ts.tile_params(TorchConfig())
    ref = np.asarray(jax_readscan._make_internal_tile_inner(cfg)(
        jnp.asarray(rows), jax_readscan.ReadScanModel(cfg).peq_adc))
    plain = ts.tile_scan_plain(torch.from_numpy(rows), p).numpy()
    np.testing.assert_array_equal(plain, ref)
    for order in (None, lambda tiles: tiles[::-1]):
        got, _ = _kernel_model(rows, p, order)
        np.testing.assert_array_equal(got, plain)


def test_kernel_model_on_build_tiles_rows():
    rows, _, _ = readscan.build_tiles(_long_reads(np.random.default_rng(19)),
                                      TorchConfig())
    p = ts.tile_params(TorchConfig())
    got, _ = _kernel_model(rows, p)
    np.testing.assert_array_equal(
        got, ts.tile_scan_plain(torch.from_numpy(rows), p).numpy())


def test_tile_bound_counts_the_confirms_the_scan_runs():
    """chip_smoke.py's tile bound: its site count equals the confirms the
    kernel's block lists hold (the plain detection's sites), and its words
    are those the tiles' windows need."""
    rows = chip_smoke.tile_edge_rows(129)
    p = ts.tile_params(TorchConfig())
    words, sites, row_bytes = chip_smoke.tile_scan_work(
        torch.from_numpy(rows), p)
    _, n_confirms = _kernel_model(rows, p)
    sA, sT = ts.tile_sites_plain(torch.from_numpy(rows), p)
    assert sites == n_confirms == int((sA >= 0).sum() + (sT >= 0).sum()) > 0
    own_lo, own_hi, tlen, _, _ = _meta(rows)
    hi = np.minimum(own_hi, tlen - p.k + 1)
    need = np.where(hi > own_lo,
                    (np.minimum(hi + p.k - 1, 1024) + 31) // 32 - own_lo // 32,
                    0)
    assert words == int(need.sum()) and 0 < words < 32 * len(rows)
    # the bytes: each tile's meta, and the bytes of the columns its windows
    # and its confirm windows read inside the tile's bases
    cols = [set(range(own_lo[i], min(hi[i] + p.k - 1, 1024)))
            if hi[i] > own_lo[i] else set() for i in range(len(rows))]
    for i, s in zip(*np.nonzero(sA.numpy() >= 0)):
        cols[i] |= set(range(int(sA[i, s]), int(sA[i, s]) + ts.WI_CONFIRM))
    for i, s in zip(*np.nonzero(sT.numpy() >= 0)):
        cols[i] |= set(range(int(sT[i, s]) - ts.WI_CONFIRM, int(sT[i, s])))
    want = sum(len({c // 2 for c in cs if 0 <= c < tlen[i]})
               for i, cs in enumerate(cols)) + 16 * len(rows)
    assert row_bytes == want and 16 * len(rows) < row_bytes < rows.size


@pytest.mark.parametrize("k,frac", [(9, 0.7), (16, 0.7), (31, 0.5)])
def test_kernel_model_other_windows_match_plain(k, frac):
    """The word form at other window lengths and thresholds (the kernel's
    general path; k = 15, mc = 11 is compiled in)."""
    cfg = TorchConfig()
    cfg.polyat.internal_pat_length = k
    cfg.polyat.internal_fraction_at_in_polyat = frac
    p = ts.tile_params(cfg)
    rows = chip_smoke.tile_edge_rows(129)[:40]
    got, _ = _kernel_model(rows, p)
    np.testing.assert_array_equal(
        got, ts.tile_scan_plain(torch.from_numpy(rows), p).numpy())
