"""The port's Myers edit distance, best-two reduction, whitelist sweep and
single-pattern window search against sicelore_tpu's (jnp path, and the Pallas
kernels in interpret mode): exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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


# ---- a numpy model of csrc/win1.cu's staging: a block's span of ROWS x W
# bytes copied with 16-byte loads (byte loads before the first aligned
# address and after the last), each row read back four codes a word ----

ROWS, WMAX = 128, 160                      # csrc/win1.cu
CAP = ROWS * WMAX
NV = (CAP // 16 + ROWS - 1) // ROWS


def _read_row(sm, rb, nc):
    """Codes [0, nc) of the row at byte rb: aligned words and a funnel
    shift, as run_row reads them (the word after the row may be read)."""
    words = sm.view("<u4").astype(np.uint64)
    w, sh = rb >> 2, np.uint64(8 * (rb & 3))
    lo, out, c = words[w], [], 0
    while True:
        hi = words[w + (c >> 2) + 1]
        word = int(((hi << np.uint64(32)) | lo) >> sh) & 0xFFFFFFFF
        lo = hi
        out += [(word >> (8 * u)) & 7 for u in range(4) if c + u < nc]
        c += 4
        if c >= nc:
            return np.asarray(out, np.int8)


def _win1_staged_rows(wins, base_off):
    """The rows each thread of csrc/win1.cu reads, for windows [B, W] whose
    first byte lies base_off bytes past a 16-byte boundary; asserts that
    the span's every byte is loaded once, within each thread's NV loads."""
    B, W = wins.shape
    flat = wins.reshape(-1).view(np.uint8)
    rows = np.empty_like(wins)
    for b0 in range(0, B, ROWS):
        nrows = min(ROWS, B - b0)
        sm = np.full(CAP + 32, 0xEE, np.uint8)     # stale shared memory
        if W <= WMAX:
            n = nrows * W
            span = flat[b0 * W:b0 * W + n]
            off = (base_off + b0 * W) % 16
            head = min(n, (16 - off) % 16)
            nb = (n - head) // 16
            tail0 = head + 16 * nb
            assert nb <= NV * ROWS and head < ROWS and n - tail0 < ROWS
            assert nb == 0 or (off + head) % 16 == 0
            loads = np.zeros(n, int)
            for t in range(ROWS):
                for j in range(NV):
                    ch = t + j * ROWS
                    if ch < nb:
                        a = head + 16 * ch
                        sm[off + a:off + a + 16] = span[a:a + 16]
                        loads[a:a + 16] += 1
                for a in ([t] if t < head else []) + (
                        [tail0 + t] if t < n - tail0 else []):
                    sm[off + a] = span[a]
                    loads[a] += 1
            assert (loads == 1).all()
            for r in range(nrows):
                rows[b0 + r] = _read_row(sm, off + r * W, W)
        else:
            parts = [[] for _ in range(nrows)]
            for c0 in range(0, W, WMAX):
                nc = min(WMAX, W - c0)
                for r in range(nrows):
                    sm[r * WMAX:r * WMAX + nc] = flat[(b0 + r) * W + c0:
                                                      (b0 + r) * W + c0 + nc]
                for r in range(nrows):
                    parts[r].append(_read_row(sm, r * WMAX, nc))
            for r in range(nrows):
                rows[b0 + r] = np.concatenate(parts[r])
    return rows


@pytest.mark.parametrize("W", [1, 90, 110, 160, 200])
@pytest.mark.parametrize("B", [1, 37, 129])
def test_win1_span_staging_model_matches_plain(B, W):
    """Every row comes back intact from the staged span, whatever the
    span's start modulo 16 (the tensor's own offset and b0 x W), and the
    search over the rows read back through the six-entry match table
    equals myers_win1_plain, for B = 1, 37, 129 (two blocks, the second of
    one row) and W = 1, 90, 110, 160 (one round) and 200 (rounds)."""
    m = min(22, max(W, 1))
    for off in (0, 1, 7, 13):
        wins, pat = chip_smoke.win1_edge_windows(B, W, m, off)
        got = _win1_staged_rows(wins, off)
        np.testing.assert_array_equal(got, wins)
        peq = editdist.build_peq(pat[None, :])
        table = np.concatenate([peq[:, 0], np.zeros(4, np.uint32)])
        np.testing.assert_array_equal(
            table[got & 7], editdist.peq_tensor(peq, "cpu")[
                torch.from_numpy(wins).long(), 0].numpy().astype(np.uint32))
        ed, pos = editdist.myers_win1_plain(torch.from_numpy(got), peq, m)
        ed_j, pos_j = jax_ed.myers_sweep(jnp.asarray(wins), jnp.asarray(peq),
                                         m)
        np.testing.assert_array_equal(ed.numpy(), np.asarray(ed_j)[:, 0])
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j)[:, 0])


def test_win1_edge_shapes_hold_unaligned_spans():
    """chip_smoke.py's window-search edge sets put block spans at every
    start modulo 16 and hold an all-PAD row each."""
    starts = set()
    for B, W, m, off in chip_smoke.WIN1_EDGE_SHAPES:
        starts |= {(off + b0 * W) % 16 for b0 in range(0, B, ROWS)}
        wins, _ = chip_smoke.win1_edge_windows(B, W, m, off)
        assert wins.shape == (B, W) and (wins[B // 2] == 5).all()
        v = chip_smoke.unaligned_rows(wins, off, "cpu")
        assert v.data_ptr() % 16 == off and v.is_contiguous()
        assert torch.equal(v, torch.from_numpy(wins))
    assert len(starts) >= 8 and 0 in starts


def _win1_columns_model(rows, peq, m):
    """csrc/win1.cu's column arithmetic on rows [B, W] of codes 0..5: the
    pattern in the top m bits (low bits PV = 1, MV = 0), the score's step
    from the sign bits, match masks from the 64-entry pair table, and the
    best as the minimum of score x 2^26 + column, four columns a group."""
    B, W = rows.shape
    KEY = np.uint32(1 << 26)
    up = np.uint32(32 - m)
    eq = [np.uint32(int(peq[c, 0]) << int(up) & 0xFFFFFFFF) if c < 4
          else np.uint32(0) for c in range(8)]
    pair = np.asarray([(eq[t & 7], eq[t >> 3]) for t in range(64)],
                      np.uint32)
    PV = np.full(B, 0xFFFFFFFF, np.uint32)
    MV = np.zeros(B, np.uint32)
    score = np.full(B, m, np.uint32)
    best = np.full(B, m, np.uint32) * KEY
    one = np.uint32(1)

    def step(e):
        nonlocal PV, MV, score
        Xv = e | MV
        Xh = (((e & PV) + PV) ^ PV) | e
        Ph = MV | ~(Xh | PV)
        Mh = PV & Xh
        score = score + (Ph >> np.uint32(31)) - (Mh >> np.uint32(31))
        Ph, Mh = Ph << one, Mh << one
        PV = Mh | ~(Xv | Ph)
        MV = Ph & Xv
        return score * KEY

    x = rows.astype(np.uint32)
    c = 0
    while c + 4 <= W:
        word = (x[:, c] | x[:, c + 1] << 8 | x[:, c + 2] << 16
                | x[:, c + 3] << 24)
        e01 = pair[(word | (word >> 5)) & 63]
        e23 = pair[((word >> 16) | (word >> 21)) & 63]
        g = step(e01[:, 0])
        g = np.minimum(g, step(e01[:, 1]) + np.uint32(1))
        g = np.minimum(g, step(e23[:, 0]) + np.uint32(2))
        g = np.minimum(g, step(e23[:, 1]) + np.uint32(3))
        best = np.minimum(best, g + np.uint32(c))
        c += 4
    for u in range(W - c):
        best = np.minimum(best, step(pair[x[:, c + u] & 7, 0])
                          + np.uint32(c + u))
    none = best == np.uint32(m) * KEY
    return (np.where(none, m, best // KEY).astype(np.int32),
            np.where(none, -1, best % KEY).astype(np.int32))


@pytest.mark.parametrize("B,W,m,off", chip_smoke.WIN1_EDGE_SHAPES)
def test_win1_column_model_matches_plain(B, W, m, off):
    """The kernel's top-aligned pattern, pair table and keyed best give
    myers_win1_plain's (ed, end column) on the edge sets, m = 1..32."""
    wins, pat = chip_smoke.win1_edge_windows(B, W, m, off)
    peq = editdist.build_peq(pat[None, :])
    ed, pos = _win1_columns_model(wins, peq, m)
    ed_p, pos_p = editdist.myers_win1_plain(torch.from_numpy(wins), peq, m)
    np.testing.assert_array_equal(ed, ed_p.numpy())
    np.testing.assert_array_equal(pos, pos_p.numpy())
    assert (pos == -1).any() and (B < 37 or W < m or (pos >= 0).any())
