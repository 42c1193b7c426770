"""The port's Myers edit distance, best-two reduction, whitelist sweep and
single-pattern window search against sicelore_tpu's (jnp path, and the Pallas
kernels in interpret mode): exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicelore_tpu.ops import bcsearch as jax_bc
from sicelore_tpu.ops import editdist as jax_ed
from sicelore_tpu_torch.ops import bcsearch, editdist


def _windows(rng, B, W, pats):
    """Random windows with planted barcodes, N and PAD characters, and
    duplicate plants (ties)."""
    wins = rng.integers(0, 4, size=(B, W)).astype(np.int8)
    for i in range(B):
        j = int(rng.integers(0, len(pats)))
        off = int(rng.integers(0, W - pats.shape[1] + 1))
        wins[i, off:off + pats.shape[1]] = pats[j]
    wins[::5, 3] = 4                    # N
    wins[::7, -4:] = 5                  # PAD tail
    wins[::11] = 5                      # all PAD
    return wins


def test_build_peq_myers_sweep_best_two():
    rng = np.random.default_rng(1)
    m, W = 16, 22
    pats = rng.integers(0, 4, size=(40, m)).astype(np.int8)
    pats[7] = pats[3]                   # duplicate barcode: exact ties
    wins = _windows(rng, 48, W, pats)
    peq = editdist.build_peq(pats)
    np.testing.assert_array_equal(peq, jax_ed.build_peq(pats))
    ed, pos = editdist.myers_sweep(torch.from_numpy(wins), peq, m)
    ed_j, pos_j = jax_ed.myers_sweep(jnp.asarray(wins), jnp.asarray(peq), m)
    np.testing.assert_array_equal(ed.numpy(), np.asarray(ed_j))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    got = editdist.best_two(ed)
    ref = jax_ed.best_two(ed_j)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # ties: both copies of barcode 3 tie; the first index wins and the
    # second best equals the best
    hit = np.nonzero(got[2].numpy() == got[0].numpy())[0]
    assert len(hit) > 0


@pytest.mark.parametrize("track_pos", [True, False])
def test_sweep_matches_pallas_interpret(track_pos):
    """tests/test_bcsearch.py's interpret-mode case (B=16, N=256,
    nvalid=200): the port's sweep rows equal the Pallas kernel's."""
    rng = np.random.default_rng(3)
    m, W = 16, 22
    B, N, n_valid = 16, 256, 200
    pats = rng.integers(0, 4, size=(n_valid, m)).astype(np.int8)
    wins = rng.integers(0, 4, size=(B, W)).astype(np.int8)
    for i in range(B):
        j = int(rng.integers(0, n_valid))
        wins[i, 2:2 + m] = pats[j]
    wins[0, 5] = 4
    peq = np.zeros((4, N), dtype=np.uint32)
    peq[:, :n_valid] = editdist.build_peq(pats)
    ref = np.asarray(jax_bc.bc_sweep_pallas(
        jnp.asarray(wins.astype(np.int32)), jnp.asarray(peq),
        jnp.asarray([n_valid], dtype=np.int32), m, bt=8, nt=128,
        interpret=True, track_pos=track_pos))
    before = bcsearch.bc_sweep_plain.launches
    got = bcsearch.bc_sweep(torch.from_numpy(wins.T.astype(np.uint8).copy()),
                            bcsearch.peq_device(peq, "cpu"), n_valid, m,
                            track_pos=track_pos).numpy()
    assert bcsearch.bc_sweep_plain.launches == before + 1
    np.testing.assert_array_equal(got, ref)


def test_bc_search_matches_jax_and_masks_nvalid():
    """bc_search against the JAX jnp bc_search; lanes >= n_valid never
    win even when they hold the exact barcode."""
    rng = np.random.default_rng(2)
    m, W = 16, 22
    pats = rng.integers(0, 4, size=(100, m)).astype(np.int8)
    wins = _windows(rng, 64, W, pats)
    peq = editdist.build_peq(pats)
    for n_valid in (100, 60):
        ref = jax_bc.bc_search(wins, peq, n_valid, m, use_pallas=False)
        got = bcsearch.bc_search(wins, peq, n_valid, m, device="cpu")
        for k in ("ed", "idx", "ed2", "end_pos"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["idx"] < 60).all()


def test_bc_search_second_best_sentinel():
    """A single barcode: ed2 must be INT_MAX like the reference's ed_sec."""
    pats = np.zeros((1, 16), dtype=np.int8)
    wins = np.zeros((4, 20), dtype=np.int8)
    peq = editdist.build_peq(pats)
    got = bcsearch.bc_search(wins, peq, 1, 16, device="cpu")
    ref = jax_bc.bc_search(wins, peq, 1, 16, use_pallas=False)
    assert (got["ed2"] == editdist.INT_MAX).all() and (got["ed"] == 0).all()
    for k in ("ed", "idx", "ed2", "end_pos"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_myers_win1_matches_pallas_interpret():
    """tests/test_editdist.py's window-search case (B 1,024, W 48, m 19,
    codes 0..5): the port's myers_win1 on CPU tensors (its plain version)
    equals the Pallas kernel in interpret mode and the jnp sweep."""
    rng = np.random.default_rng(3)
    B, W, m = 1024, 48, 19
    wins = rng.integers(0, 6, (B, W)).astype(np.int8)
    peq = editdist.build_peq(rng.integers(0, 4, m).astype(np.int8)[None, :])
    ed_p, pos_p = jax_ed.myers_win1_pallas(jnp.asarray(wins),
                                           jnp.asarray(peq), m,
                                           interpret=True)
    ed_j, pos_j = jax_ed.myers_sweep(jnp.asarray(wins), jnp.asarray(peq), m)
    before = (editdist.myers_win1_plain.launches,
              editdist.myers_win1.launches)
    ed, pos = editdist.myers_win1(torch.from_numpy(wins), peq, m)
    assert editdist.myers_win1_plain.launches == before[0] + 1
    assert editdist.myers_win1.launches == before[1]   # the kernel's count
    assert ed.dtype == torch.int32 and pos.dtype == torch.int32
    for got, a, b in ((ed, ed_p, ed_j[:, 0]), (pos, pos_p, pos_j[:, 0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(a))
        np.testing.assert_array_equal(got.numpy(), np.asarray(b))
    assert (pos.numpy() >= 0).any()


@pytest.mark.parametrize("B,W,m", [(37, 110, 22), (5, 1, 4), (64, 40, 32),
                                   (1, 160, 31), (0, 12, 8)])
def test_myers_win1_matches_jnp_sweep_at_any_shape(B, W, m):
    """Shapes the Pallas wrapper cannot take (B not a multiple of 1,024,
    W = 1, m = 32, B = 0), with planted matches, N, PAD tails and an
    all-PAD row: (ed, end) equal the jnp sweep's; the all-PAD row reports
    (m, -1)."""
    rng = np.random.default_rng(100 * B + W)
    pat = rng.integers(0, 4, m).astype(np.int8)
    wins = rng.integers(0, 4, (B, W)).astype(np.int8)
    for i in range(0, B, 2):
        if W >= m:
            off = int(rng.integers(0, W - m + 1))
            wins[i, off:off + m] = pat
            if m > 4:
                wins[i, off + 2] = (wins[i, off + 2] + 1) % 4
    wins[::5, W // 2] = 4
    wins[::7, -(W // 3 + 1):] = 5
    if B:
        wins[B - 1] = 5
    peq = editdist.build_peq(pat[None, :])
    ed, pos = editdist.myers_win1(torch.from_numpy(wins), peq, m)
    assert ed.shape == (B,) and pos.shape == (B,)
    if B:
        ed_j, pos_j = jax_ed.myers_sweep(jnp.asarray(wins),
                                         jnp.asarray(peq), m)
        np.testing.assert_array_equal(ed.numpy(), np.asarray(ed_j)[:, 0])
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j)[:, 0])
        assert (int(ed[B - 1]), int(pos[B - 1])) == (m, -1)


def test_myers_win1_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((4, 8), dtype=torch.int8)
    peq = editdist.build_peq(np.zeros((1, 8), np.int8))
    with pytest.raises(ValueError, match="1..32"):
        editdist.myers_win1(w, peq, 33)
    with pytest.raises(ValueError, match="W >= 1"):
        editdist.myers_win1(torch.zeros((4, 0), dtype=torch.int8), peq, 8)
    with pytest.raises(ValueError, match=r"\[4, 1\]"):
        editdist.myers_win1(w, np.zeros((4, 2), np.uint32), 8)
