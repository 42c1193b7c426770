"""UMI clustering: the port's batched global Myers distance, its pairwise
matrix with the host rows of empty and over-32-nt UMIs, and its clusters,
against the JAX package on the same seeded inputs (exact equality)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sicelore_tpu.core import umicluster as j_uc
from sicelore_tpu.ops import editdist as j_ed
from sicelore_tpu_torch.core import umicluster as t_uc
from sicelore_tpu_torch.ops import editdist as t_ed
from sicelore_tpu_torch.utils import dna


def _texts(rng, G, K, L, with_n):
    """[G, K, L] int8 codes of random lengths 0..L (text 0 of each group
    empty), PAD after each; N codes sprinkled in when with_n."""
    tx = np.full((G, K, L), dna.PAD, np.int8)
    tl = rng.integers(0, L + 1, (G, K)).astype(np.int32)
    tl[:, 0] = 0
    for g in range(G):
        for k in range(K):
            row = rng.integers(0, 4, tl[g, k]).astype(np.int8)
            if with_n and tl[g, k] > 2 and k % 3 == 1:
                row[int(rng.integers(0, tl[g, k]))] = dna.N_CODE
            tx[g, k, :tl[g, k]] = row
    return tx, tl


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("m", [1, 12, 31, 32])
def test_myers_global_pairwise_matches_jax(G, m):
    """[G, P, K] distances with P != K, an empty text a group, texts with
    N and patterns with N."""
    rng = np.random.default_rng(100 + 7 * m + G)
    P, K, L = 5, 9, m + 6
    tx, tl = _texts(rng, G, K, L, with_n=True)
    pats = rng.integers(0, 4, (G, P, m)).astype(np.int8)
    pats[:, 1, m // 2] = dna.N_CODE
    peq = np.stack([t_ed.build_peq(pats[g]) for g in range(G)])
    want = np.asarray(j_ed.myers_global_pairwise(
        jnp.asarray(peq), jnp.asarray(tx), jnp.asarray(tl), m))
    before = t_ed.myers_global_pairwise.launches
    got = t_ed.myers_global_pairwise(peq, torch.from_numpy(tx),
                                     torch.from_numpy(tl), m)
    assert t_ed.myers_global_pairwise.launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (G, P, K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, :, 0] == m).all()        # empty texts stay at m


def _umi_group(seed, n=60):
    """A group of >= 48 unique UMIs: 12-14 nt, near duplicates, UMIs with
    N (one twice, so N meets N), an empty UMI and a 33-nt one."""
    rng = np.random.default_rng(seed)
    umis = [dna.decode(rng.integers(0, 4, int(rng.integers(12, 15))))
            .encode() for _ in range(n)]
    umis += [umis[0][:-1] + b"A", umis[1] + b"C", umis[3][:5] + b"N"
             + umis[3][6:], umis[4][:7] + b"N" + umis[4][8:],
             umis[4][:7] + b"N" + umis[4][8:10], b"", b"ACGT" * 8 + b"G",
             b"ACGT" * 8 + b"C", b"ACGTN" * 6 + b"ACG", b"ACGTN" * 6]
    return list(dict.fromkeys(umis))


def test_pairwise_ed_matches_jax_device_route():
    """The port's batched route equals `_pairwise_ed_device`, row for row:
    codes for 1-32 nt rows (N matches nothing), host bytes for the empty
    and the 33-nt rows (N matches N), so the matrix is not symmetric."""
    umis = _umi_group(3)
    assert len(umis) >= t_uc.DEVICE_ED_THRESHOLD
    want = j_uc._pairwise_ed_device(umis)
    before = t_ed.myers_global_pairwise.launches
    got = t_uc.pairwise_ed(umis, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # one call a pattern-length class of 1..32 nt
    lens = {len(u) for u in umis if 1 <= len(u) <= 32}
    assert t_ed.myers_global_pairwise.launches == before + len(lens)
    i, j = umis.index(b"ACGTN" * 6 + b"ACG"), umis.index(b"ACGTN" * 6)
    assert got[i, j] == 3 and got[j, i] > 3     # host row, batched row
    n = umis.index(umis[4][:7] + b"N" + umis[4][8:])
    assert got[n, n] == 1 and t_uc.myers_ed(umis[n], umis[n]) == 0


def _mixed_group(seed):
    """UMIs of every length 1..32 nt (random draws around them), N rows,
    an all-N UMI, an empty UMI and 33-nt UMIs."""
    rng = np.random.default_rng(seed)
    umis = [dna.decode(rng.integers(0, 4, m)).encode() for m in range(1, 33)]
    umis += [dna.decode(rng.integers(0, 4, int(rng.integers(1, 33))))
             .encode() for _ in range(40)]
    umis += [u[:1] + b"N" + u[2:] for u in umis[8:20]]
    umis += [b"", b"N" * 7, b"ACGT" * 8 + b"G", b"ACGTN" * 6 + b"ACG"]
    return list(dict.fromkeys(umis))


def _rows_inputs(umis, device="cpu"):
    L = max(1, max(len(u) for u in umis))
    tx, tl = dna.encode_batch(umis, L)
    ml = np.fromiter((len(u) for u in umis), np.int32, len(umis))
    peq = t_ed.build_peq(tx[:, :min(L, 32)])
    return (peq, ml, tx, tl), t_ed.pairwise_inputs(peq, ml, tx, tl, device)


@pytest.mark.parametrize("seed", [21, 22])
def test_myers_global_rows_matches_jax(seed):
    """The rows function's plain version (every length class at once)
    against the JAX `myers_global_pairwise` called a length at a time:
    equal in every row of 1..32 nt; the empty and 33-nt rows are 0."""
    umis = _mixed_group(seed)
    (peq, ml, tx, tl), args = _rows_inputs(umis)
    got = t_ed.myers_global_rows(*args).numpy()
    assert got.dtype == np.int32 and got.shape == (len(umis),) * 2
    for m in range(1, 33):
        rows = np.nonzero(ml == m)[0]
        want = np.asarray(j_ed.myers_global_pairwise(
            jnp.asarray(np.ascontiguousarray(peq[:, rows])[None]),
            jnp.asarray(tx[None]), jnp.asarray(tl[None]), m))[0]
        np.testing.assert_array_equal(got[rows], want, err_msg=str(m))
    assert (got[(ml == 0) | (ml > 32)] == 0).all()
    # the whole matrix (host rows filled) is the JAX device route's
    np.testing.assert_array_equal(t_uc.pairwise_ed(umis, device="cpu"),
                                  j_uc._pairwise_ed_device(umis))


def test_pairwise_ed_one_call_a_group():
    """The batched route makes one rows call a group (the plain version's
    counter on the CPU; on the card one kernel launch), which calls the
    torch body once a length class; the kernel wrapper launches nothing
    on the CPU."""
    umis = _mixed_group(23)
    n_cls = len({len(u) for u in umis if 1 <= len(u) <= 32})
    before = (t_ed.myers_global_rows_plain.launches,
              t_ed.myers_global_pairwise.launches,
              t_ed.myers_global_rows.launches)
    for _ in range(2):
        t_uc._pairwise_ed_device(umis, "cpu")
    assert (t_ed.myers_global_rows_plain.launches,
            t_ed.myers_global_pairwise.launches,
            t_ed.myers_global_rows.launches) == \
        (before[0] + 2, before[1] + 2 * n_cls, before[2])


def test_pairwise_inputs_one_buffer():
    """The group's inputs go up as views of one int32 buffer: each view
    holds what it was given."""
    umis = _mixed_group(24)
    (peq, ml, tx, tl), (p_t, m_t, x_t, l_t) = _rows_inputs(umis)
    assert p_t.untyped_storage().data_ptr() == \
        x_t.untyped_storage().data_ptr() == l_t.untyped_storage().data_ptr()
    np.testing.assert_array_equal(p_t.numpy().view(np.uint32), peq)
    np.testing.assert_array_equal(m_t.numpy(), ml)
    np.testing.assert_array_equal(x_t.numpy(), tx)
    np.testing.assert_array_equal(l_t.numpy(), tl)
    assert (p_t.dtype, m_t.dtype, x_t.dtype, l_t.dtype) == (
        torch.int32, torch.int32, torch.int8, torch.int32)
    # an empty group: empty views, an empty matrix
    e = t_ed.pairwise_inputs(np.zeros((4, 0), np.uint32),
                             np.zeros(0, np.int32), np.zeros((0, 1), np.int8),
                             np.zeros(0, np.int32), "cpu")
    assert [tuple(v.shape) for v in e] == [(4, 0), (0,), (0, 1), (0,)]
    assert t_ed.myers_global_rows(*e).shape == (0, 0)


def test_myers_global_rows_checks_shapes():
    _, args = _rows_inputs(_mixed_group(25)[:10])
    with pytest.raises(ValueError, match="peq must be"):
        t_ed.myers_global_rows(args[0][:, :-1], *args[1:])
    with pytest.raises(ValueError, match="L >= 1"):
        t_ed.myers_global_rows(*args[:2], args[2][:, :0], args[3])
    with pytest.raises(ValueError, match="L >= 1"):
        t_ed.myers_global_rows(*args[:2], args[2][0], args[3])


def _kernel_model(peq, ml, tx, tl, TX=32):
    """A numpy model of csrc/pairwise.cu's arithmetic: uint32 state started
    at all ones (the bits above m - 1 unmasked), the global column with
    carry-in 1, the match masks of codes 4..7 zero, every lane of a block
    running to the block's longest text and keeping its score after its
    own text's last column; rows outside 1..32 nt are 0."""
    K, L = tx.shape
    M = np.uint64(0xFFFFFFFF)
    tlc = np.where((tl < 0) | (tl > L), 0, tl)
    ok = (ml >= 1) & (ml <= 32)
    hb = np.where(ok, ml - 1, 0).astype(np.uint64)[:, None]
    eq8 = np.concatenate([peq.astype(np.uint64),
                          np.zeros((4, K), np.uint64)])       # [8, K]
    d = np.zeros((K, K), np.int64)
    for j0 in range(0, K, TX):
        js = np.arange(j0, min(j0 + TX, K))
        tmax = int(tlc[js].max())
        PV = np.full((K, len(js)), M)
        MV = np.zeros((K, len(js)), np.uint64)
        score = np.repeat(ml[:, None].astype(np.int64), len(js), 1)
        snap = score.copy()
        for t in range(tmax):
            eq = eq8[tx[js, t].astype(np.int64) & 7].T        # [K, n]
            Xv = eq | MV
            Xh = ((((eq & PV) + PV) & M) ^ PV) | eq
            Ph = MV | (~(Xh | PV) & M)
            Mh = PV & Xh
            score += ((Ph >> hb) & 1).astype(np.int64)
            score -= ((Mh >> hb) & 1).astype(np.int64)
            Ph = ((Ph << np.uint64(1)) | np.uint64(1)) & M
            Mh = (Mh << np.uint64(1)) & M
            PV = Mh | (~(Xv | Ph) & M)
            MV = Ph & Xv
            snap = np.where((tlc[js] == t + 1)[None, :], score, snap)
        d[:, js] = np.where(ok[:, None], snap, 0)
    return d


@pytest.mark.parametrize("seed", [26, 27])
def test_pairwise_kernel_model_equals_plain(seed):
    """The kernel's arithmetic (numpy model) equals the plain rows, in
    blocks that hold texts of many lengths, the empty text among them."""
    umis = _mixed_group(seed)
    (peq, ml, tx, tl), args = _rows_inputs(umis)
    np.testing.assert_array_equal(_kernel_model(peq, ml, tx, tl),
                                  t_ed.myers_global_rows(*args).numpy())


def test_pairwise_ed_route_rule():
    """The route follows the unique-UMI count, never the device: below the
    threshold the host matrix, from it the batched one; both forced ways
    match the JAX package's."""
    umis = _umi_group(4)
    small = umis[:t_uc.DEVICE_ED_THRESHOLD - 1]
    before = t_ed.myers_global_pairwise.launches
    np.testing.assert_array_equal(t_uc.pairwise_ed(small, device="cpu"),
                                  j_uc.pairwise_ed(small))
    assert t_ed.myers_global_pairwise.launches == before
    for use in (False, True):
        np.testing.assert_array_equal(
            t_uc.pairwise_ed(umis, use_device=use, device="cpu"),
            j_uc.pairwise_ed(umis, use_device=use))


def _reads_of(seed, n_base, copies):
    """Per-read UMIs of n_base molecules, each read with a chance of one
    substitution or indel, plus per-read qualities with ties."""
    rng = np.random.default_rng(seed)
    base = [dna.decode(rng.integers(0, 4, 12)) for _ in range(n_base)]
    umis, quals = [], []
    for b in base:
        for _ in range(int(rng.integers(1, copies + 1))):
            u = b
            r = rng.random()
            p = int(rng.integers(0, 12))
            if r < 0.3:
                u = u[:p] + "ACGT"[int(rng.integers(0, 4))] + u[p + 1:]
            elif r < 0.4:
                u = u[:p] + u[p + 1:]
            elif r < 0.45:
                u = u[:p] + "N" + u[p + 1:]
            umis.append(u.encode())
            quals.append(float(rng.integers(20, 23)))
    return umis, quals


def _clusters(cls):
    return [(c.center, c.members, c.from_clustering, c.is_readseq)
            for c in cls]


@pytest.mark.parametrize("case", ["small", "large", "single_link",
                                  "over_max"])
def test_cluster_group_matches_jax(case):
    """Clusters equal one for one, in order (complete-link tie order
    included), on both routes and both linkages."""
    n_base, copies, kw = {
        "small": (10, 3, {}),
        "large": (45, 3, {}),
        "single_link": (40, 3, {"single_link_threshold": 50}),
        "over_max": (20, 2, {"max_complexity": 10}),
    }[case]
    umis, quals = _reads_of(20 + n_base, n_base, copies)
    want = j_uc.cluster_group(umis, quals, **kw)
    got = t_uc.cluster_group(umis, quals, device="cpu", **kw)
    assert _clusters(got) == _clusters(want)
    if case == "large":
        assert len(set(umis)) >= t_uc.DEVICE_ED_THRESHOLD


def test_clusterings_on_ties_match_jax():
    """A distance matrix full of ties: the copied NN-chain keeps the first
    index of np.argmin / np.argmax."""
    rng = np.random.default_rng(9)
    d = rng.integers(0, 4, (30, 30)).astype(np.int32)
    d = np.minimum(d, d.T)
    np.fill_diagonal(d, 0)
    for k in (1, 2):
        assert t_uc.complete_link_clusters(d, k) == \
            j_uc.complete_link_clusters(d, k)
        assert t_uc.single_link_clusters(d, k) == \
            j_uc.single_link_clusters(d, k)
    for a, b in ((b"ACGT", b"AGT"), (b"", b"ACG"), (b"NNA", b"NNA"),
                 (b"ACGTN" * 7, b"ACGT" * 8)):
        assert t_uc.myers_ed(a, b) == j_uc.myers_ed(a, b)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        t_uc.cluster_group([b"ACGT"], [30.0])
    with pytest.raises(RuntimeError, match="cuda"):
        t_uc.pairwise_ed(_umi_group(5))
