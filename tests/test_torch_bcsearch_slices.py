"""The sliced whitelist sweep of the port: per-slice partials merged by the
kernel's rule equal the whole-list plain sweep and the JAX package's sweep
(Pallas kernel in interpret mode over several barcode tiles, and the jnp
`bc_search`). Integer results: exact equality, no tolerance. The CUDA kernel
itself runs only on a card (tests/test_torch_kernels_gpu.py); here its
slicing, its merge rule and its arithmetic (pattern in the top bits of the
word, PAD-filled window) are held on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicelore_tpu.ops import bcsearch as jax_bc
from sicelore_tpu_torch.ops import bcsearch, editdist

M, W = 16, 22


def _case(seed, B, N, n_real, dup=()):
    """Windows with planted barcodes (N, PAD, all-PAD rows, one random row)
    and a Peq list of N columns of which the first n_real hold barcodes;
    `dup` pairs (dst, src) copy barcode src to index dst (ties)."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(0, 4, size=(n_real, M)).astype(np.int8)
    for dst, src in dup:
        pats[dst] = pats[src]
    wins = rng.integers(0, 4, size=(B, W)).astype(np.int8)
    for i in range(B):
        j = dup[i % len(dup)][1] if dup and i % 3 == 0 else \
            int(rng.integers(0, n_real))
        off = int(rng.integers(0, W - M + 1))
        wins[i, off:off + M] = pats[j]
        if i % 4 == 1:                      # one substitution
            wins[i, off + 5] = (wins[i, off + 5] + 1) % 4
    wins[::5, 3] = 4
    wins[::7, -4:] = 5
    wins[B - 1] = 5
    wins[B - 2] = rng.integers(0, 4, W)
    peq = np.zeros((4, N), dtype=np.uint32)
    peq[:, :n_real] = editdist.build_peq(pats)
    return wins, peq


def _sliced(wins, peq, nvalid, m, track_pos, bounds):
    """bc_sweep_plain per slice [lo, hi) with global indices -> [S, 4, B]."""
    wt = torch.from_numpy(np.ascontiguousarray(wins.T).astype(np.uint8))
    parts = []
    for lo, hi in bounds:
        part = bcsearch.bc_sweep_plain(
            wt, bcsearch.peq_device(peq[:, lo:hi], "cpu"),
            min(max(nvalid - lo, 0), hi - lo), m, track_pos).clone()
        part[1] += lo
        parts.append(part)
    return wt, torch.stack(parts)


def _bounds(N, L):
    return [(lo, min(lo + L, N)) for lo in range(0, N, L)]


# name: (N, n_real, nvalid, slice length, duplicates)
CASES = {
    "dup_across_slices": (384, 384, 384, 128, ((200, 7), (300, 7), (130, 64))),
    "nvalid_inside_slice": (384, 384, 200, 128, ((150, 3),)),
    "all_masked_slice": (384, 384, 120, 128, ((90, 3),)),
    "ragged_last_slice": (384, 384, 384, 100, ((383, 0), (301, 99))),
    "nvalid_one": (384, 384, 1, 128, ()),
    "many_short_slices": (384, 384, 381, 4, ((380, 1), (5, 4))),
}


@pytest.mark.parametrize("track_pos", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_slices_equal_whole_sweep_and_jax(name, track_pos):
    N, n_real, nvalid, L, dup = CASES[name]
    B = 16
    wins, peq = _case(len(name), B, N, n_real, dup)
    wt, parts = _sliced(wins, peq, nvalid, M, track_pos, _bounds(N, L))
    assert parts.shape == (len(_bounds(N, L)), 4, B)
    got = bcsearch.merge_sweep_partials_plain(parts)
    assert got.dtype == torch.int32
    whole = bcsearch.bc_sweep_plain(wt, bcsearch.peq_device(peq, "cpu"),
                                    nvalid, M, track_pos)
    assert torch.equal(got, whole)
    # the CPU route of the wrapper is the same plain merge
    assert torch.equal(bcsearch.merge_sweep_partials(parts), got)
    ref = np.asarray(jax_bc.bc_sweep_pallas(
        jnp.asarray(wins.astype(np.int32)), jnp.asarray(peq),
        jnp.asarray([nvalid], dtype=np.int32), M, bt=8, nt=128,
        interpret=True, track_pos=track_pos))          # three barcode tiles
    np.testing.assert_array_equal(got.numpy(), ref)
    if dup and nvalid > max(d for d, _ in dup):
        assert int((got[0] == got[2]).sum()) > 0       # ties: b2 == b1
    if nvalid < N:
        assert int(got[1].max()) < nvalid


def test_merged_slices_equal_jnp_bc_search():
    """Through the sentinel mapping of `bc_search`: the merged partials give
    the JAX jnp `bc_search`'s ed / idx / ed2 / end_pos."""
    N, nvalid = 300, 257
    wins, peq = _case(5, 24, N, N, ((256, 2), (299, 2)))
    _, parts = _sliced(wins, peq, nvalid, M, True, _bounds(N, 64))
    out = bcsearch.merge_sweep_partials_plain(parts).numpy().astype(np.int64)
    ref = jax_bc.bc_search(wins, peq, nvalid, M, use_pallas=False)
    np.testing.assert_array_equal(out[0], ref["ed"])
    np.testing.assert_array_equal(out[1], ref["idx"])
    np.testing.assert_array_equal(
        np.where(out[2] >= bcsearch.BIG, editdist.INT_MAX, out[2]),
        ref["ed2"])
    np.testing.assert_array_equal(out[3], ref["end_pos"])


def test_all_masked_partial_never_wins_and_first_index_survives():
    """A slice of masked barcodes only is (BIG, _, BIG, -1); with every
    slice masked the first slice's index 0 survives, as torch.min gives it
    for the whole list."""
    wins, peq = _case(9, 8, 256, 256)
    wt, parts = _sliced(wins, peq, 0, M, True, _bounds(256, 64))
    assert (parts[:, 0] == bcsearch.BIG).all() and (parts[:, 3] == -1).all()
    got = bcsearch.merge_sweep_partials_plain(parts)
    whole = bcsearch.bc_sweep_plain(wt, bcsearch.peq_device(peq, "cpu"), 0, M)
    assert torch.equal(got, whole)
    assert (got[1] == 0).all() and (got[2] == bcsearch.BIG).all()


@pytest.mark.parametrize("B,nvalid,N,sms,slices", [
    (32768, 8192, 8192, 132, None), (32768, 49152, 49152, 132, None),
    (4096, 8192, 8192, 132, None), (1, 8192, 8192, 132, None),
    (37, 5, 5, 132, 8), (37, 5, 9, 132, None), (600, 0, 256, 132, None),
    (600, 256, 256, 132, 3), (600, 255, 256, 132, 7), (10**6, 8192, 8192, 132, None),
    (1000, 1, 1, 4, 2), (5000, 70000 * 4, 70000 * 4, 132, 10**6),
])
def test_sweep_slices_cover_the_valid_list(B, nvalid, N, sms, slices):
    S, L = (bcsearch.sweep_slices(B, nvalid, N, sms) if slices is None
            else bcsearch._slice_grid(nvalid, N, slices))
    nv = min(max(nvalid, 0), N)
    assert 1 <= S <= 65535 and L >= 1 and L % bcsearch.SWEEP_CHAINS == 0
    assert S * L >= nv                       # every valid barcode is swept
    assert S == 1 or (S - 1) * L < nv        # and no slice is empty
    if slices is not None:
        assert S <= max(slices, 1)
    elif nv >= bcsearch.SWEEP_MIN_SLICE * 2 and B <= 32768:
        blocks = -(-B // bcsearch.SWEEP_THREADS) * S
        assert blocks >= min(8 * sms, nv // bcsearch.SWEEP_MIN_SLICE)
    if B >= 10**6:
        assert S == 1                        # the reads alone fill the card


def _sweep_top_bits(wins, peq, nvalid, m, WT):
    """The sweep kernel's arithmetic in numpy: Peq masks shifted into the top
    m bits of a uint32, PV = all ones, the score taken from bit 31, the
    window filled up to WT columns with a code that matches nothing, no
    position in the loop and one more pass over the winner for it."""
    B, Wn = wins.shape
    sh = np.uint32(32 - m)
    rows = np.concatenate([peq.astype(np.uint32) << sh,
                           np.zeros((4, peq.shape[1]), np.uint32)])
    codes = np.full((B, WT), 4, dtype=np.int64)
    codes[:, :Wn] = np.minimum(wins, 4)

    def run(eqs):
        PV = np.full(eqs[0].shape, 0xFFFFFFFF, dtype=np.uint32)
        MV = np.zeros_like(PV)
        score = np.full(PV.shape, m, dtype=np.int64)
        best, pos = score.copy(), np.full(PV.shape, -1, dtype=np.int64)
        for t, eq in enumerate(eqs):
            Xh = (((eq & PV) + PV) ^ PV) | eq
            Ph = MV | ~(Xh | PV)
            Mh = PV & Xh
            score = score + (Ph >> np.uint32(31)) - (Mh >> np.uint32(31))
            Ph1, Mh1 = Ph << np.uint32(1), Mh << np.uint32(1)
            Xv = eq | MV
            PV, MV = Mh1 | ~(Xv | Ph1), Ph1 & Xv
            pos = np.where(score < best, t, pos)
            best = np.minimum(best, score)
        return best, pos

    ed, _ = run([rows[codes[:, t]] for t in range(WT)])         # [B, N]
    ed = np.where(np.arange(peq.shape[1])[None, :] < nvalid, ed, bcsearch.BIG)
    b1 = ed.min(axis=1)
    i1 = ed.argmin(axis=1)
    masked = ed.copy()
    masked[np.arange(B), i1] = bcsearch.BIG
    _, p1 = run([rows[codes[:, t], i1] for t in range(WT)])
    p1 = np.where(b1 >= bcsearch.BIG, -1, p1)
    return np.stack([b1, i1, masked.min(axis=1), p1]).astype(np.int32)


@pytest.mark.parametrize("m,Wn,WT", [(16, 22, 22), (16, 20, 22), (31, 32, 32),
                                     (31, 31, 32), (5, 9, 16), (1, 3, 16),
                                     (12, 17, 22)])
def test_top_bit_formulation_equals_plain(m, Wn, WT):
    """The kernel's formulation against bc_sweep_plain: m up to 31, windows
    narrower than the unrolled width, N / PAD codes, nvalid inside."""
    rng = np.random.default_rng(m * 100 + Wn)
    n = 64
    pats = rng.integers(0, 4, size=(n, m)).astype(np.int8)
    wins = rng.integers(0, 6, size=(40, Wn)).astype(np.int8)
    for i in range(0, 40, 2):
        off = int(rng.integers(0, Wn - m + 1))
        wins[i, off:off + m] = pats[int(rng.integers(0, n))]
    wins[7, Wn // 2:] = 5
    peq = editdist.build_peq(pats)
    for nvalid in (n, n - 9):
        got = _sweep_top_bits(wins, peq, nvalid, m, WT)
        ref = bcsearch.bc_sweep_plain(
            torch.from_numpy(np.ascontiguousarray(wins.T).astype(np.uint8)),
            bcsearch.peq_device(peq, "cpu"), nvalid, m, True).numpy()
        np.testing.assert_array_equal(got, ref)


def test_bc_search_defaults_to_the_card():
    """`bc_search` without `device` asks for the card: on a host without a
    GPU it raises instead of running the plain sweep unasked."""
    pats = np.zeros((2, M), dtype=np.int8)
    wins = np.zeros((3, W), dtype=np.int8)
    peq = editdist.build_peq(pats)
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device resolves")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bcsearch.bc_search(wins, peq, 2, M)
    got = bcsearch.bc_search(wins, peq, 2, M, device="cpu")
    assert (got["ed"] == 0).all() and (got["idx"] == 0).all()


def test_merge_wrapper_refuses_other_inputs():
    parts = torch.zeros((2, 4, 5), dtype=torch.int32)
    assert bcsearch.merge_sweep_partials(parts).shape == (4, 5)
    with pytest.raises(IndexError):
        bcsearch.merge_sweep_partials_plain(parts[:0])
