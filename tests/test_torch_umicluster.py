"""UMI clustering: the port's batched global Myers distance, its group
entry on raw bytes (plain version, refusals, a numpy model of the kernel),
its pairwise matrix with the host rows of empty and over-32-nt UMIs, and its
clusters, against the JAX package on the same seeded inputs (exact
equality)."""
from pathlib import Path

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


def _rows_inputs(umis):
    """The rows oracle's inputs of a group: Peq [4, K] int32, pattern
    lengths, codes [K, L] and text lengths, as numpy and as CPU tensors."""
    L = max(1, max(len(u) for u in umis))
    tx, tl = dna.encode_batch(umis, L)
    ml = np.fromiter((len(u) for u in umis), np.int32, len(umis))
    peq = t_ed.build_peq(tx[:, :min(L, 32)])
    return (peq, ml, tx, tl), tuple(torch.from_numpy(a) for a in (
        peq.view(np.int32), ml, tx, tl))


@pytest.mark.parametrize("seed", [21, 22])
def test_myers_global_rows_matches_jax(seed):
    """The rows oracle (every length class at once) against the JAX
    `myers_global_pairwise` called a length at a time: equal in every row
    of 1..32 nt; the empty and 33-nt rows are 0. The group entry on the
    same UMIs gives the same matrix."""
    umis = _mixed_group(seed)
    (peq, ml, tx, tl), args = _rows_inputs(umis)
    got = t_ed.myers_global_rows_plain(*args).numpy()
    assert got.dtype == np.int32 and got.shape == (len(umis),) * 2
    for m in range(1, 33):
        rows = np.nonzero(ml == m)[0]
        want = np.asarray(j_ed.myers_global_pairwise(
            jnp.asarray(np.ascontiguousarray(peq[:, rows])[None]),
            jnp.asarray(tx[None]), jnp.asarray(tl[None]), m))[0]
        np.testing.assert_array_equal(got[rows], want, err_msg=str(m))
    assert (got[(ml == 0) | (ml > 32)] == 0).all()
    np.testing.assert_array_equal(
        t_ed.myers_global_group(*t_ed.group_inputs(umis, "cpu")).numpy(),
        got)
    # the whole matrix (host rows filled) is the JAX device route's
    np.testing.assert_array_equal(t_uc.pairwise_ed(umis, device="cpu"),
                                  j_uc._pairwise_ed_device(umis))


def _byte_group(seed, n=120):
    """UMIs of 10-16 nt over ACGT, acgt, N and n, near duplicates that
    differ in case or by an N, an empty UMI, 33-nt UMIs, and UMIs of other
    bytes: together every byte value 0..255 appears in the group."""
    rng = np.random.default_rng(seed)
    alpha = list(b"ACGTACGTACGTacgtNn")
    umis = [bytes(rng.choice(alpha, int(rng.integers(10, 17))).tolist())
            for _ in range(n)]
    umis += [u.lower() for u in umis[:6]] + [u[:3] + b"N" + u[4:]
                                            for u in umis[6:12]]
    umis += [b"", b"ACGT" * 8 + b"G", b"acgtN" * 6 + b"ACG"]
    allb = rng.permutation(256).astype(np.uint8).tobytes()
    umis += [allb[i:i + 16] for i in range(0, 256, 16)]
    umis += [b"AC" + allb[i:i + 9] + b"GT" for i in range(0, 256, 37)]
    return list(dict.fromkeys(umis))


@pytest.mark.parametrize("seed", [31, 32])
def test_myers_global_group_matches_jax(seed):
    """The group entry's plain version and the port's `_pairwise_ed_device`
    on the CPU against the JAX `_pairwise_ed_device`, on groups of mixed
    case, N, other bytes, an empty and 33-nt UMIs: the batched rows equal,
    the host rows 0 in the group matrix and equal once filled."""
    umis = _byte_group(seed)
    assert set(b"".join(umis)) == set(range(256))
    want = j_uc._pairwise_ed_device(umis)
    ml = np.fromiter(map(len, umis), np.int32, len(umis))
    host = (ml == 0) | (ml > 32)
    before = t_ed.myers_global_group_plain.launches
    got = t_ed.myers_global_group_plain(
        *t_ed.group_inputs(umis, "cpu")).numpy()
    assert t_ed.myers_global_group_plain.launches == before + 1
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[~host], want[~host])
    assert (got[host] == 0).all()
    np.testing.assert_array_equal(t_uc._pairwise_ed_device(umis, "cpu"),
                                  want)


def test_pairwise_ed_all_byte_values():
    """A group whose UMIs hold every byte value: each byte maps as
    `dna._ENC` (A, C, G, T either case; every other byte an N that matches
    nothing), as in the JAX route."""
    umis = [bytes([v]) * 12 for v in range(256)] + [
        bytes(range(v, v + 12)) for v in range(0, 244, 4)]
    want = j_uc._pairwise_ed_device(umis)
    np.testing.assert_array_equal(t_uc._pairwise_ed_device(umis, "cpu"),
                                  want)
    a, aa, n = (umis.index(x * 12) for x in (b"A", b"a", b"N"))
    assert want[a, aa] == 0 and want[n, n] == 12


def test_pairwise_ed_one_call_a_group():
    """The batched route makes one group call a group (the plain version's
    counter on the CPU; on the card one kernel launch), which calls the
    torch body once a length class; the kernel wrapper launches nothing
    on the CPU."""
    umis = _mixed_group(23)
    n_cls = len({len(u) for u in umis if 1 <= len(u) <= 32})
    before = (t_ed.myers_global_group_plain.launches,
              t_ed.myers_global_pairwise.launches,
              t_ed.myers_global_group.launches)
    for _ in range(2):
        t_uc._pairwise_ed_device(umis, "cpu")
    assert (t_ed.myers_global_group_plain.launches,
            t_ed.myers_global_pairwise.launches,
            t_ed.myers_global_group.launches) == \
        (before[0] + 2, before[1] + 2 * n_cls, before[2])


def test_group_inputs_one_buffer():
    """A group goes up as views of one buffer: raw, the UMIs joined, and
    offs, the cumulative sum of their lengths, both 16-byte aligned."""
    umis = _mixed_group(24)
    raw, offs, ho = t_ed.group_inputs(umis, "cpu")
    assert raw.untyped_storage().data_ptr() == \
        offs.untyped_storage().data_ptr()
    np.testing.assert_array_equal(ho, offs.numpy())
    assert (raw.dtype, offs.dtype) == (torch.uint8, torch.int32)
    assert raw.data_ptr() % 16 == 0 and offs.data_ptr() % 16 == 0
    assert raw.numpy().tobytes() == b"".join(umis)
    np.testing.assert_array_equal(
        offs.numpy(), np.concatenate([[0], np.cumsum(list(map(len, umis)))]))
    # an empty group, and a group of empty UMIs: empty matrices, 0 rows
    raw, offs, ho = t_ed.group_inputs([], "cpu")
    assert tuple(raw.shape) == (0,) and offs.tolist() == [0]
    assert t_ed.myers_global_group(raw, offs, ho).shape == (0, 0)
    d = t_ed.myers_global_group(*t_ed.group_inputs([b""] * 3, "cpu"))
    assert d.tolist() == [[0] * 3] * 3


def _refused(case):
    raw, offs, ho = t_ed.group_inputs(_mixed_group(25)[:10], "cpu")
    falls = offs.clone()
    falls[3] = falls[5]
    on_card = (raw.to("meta"), offs.to("meta"))   # off the CPU, no data
    return {"raw_dtype": ((raw.to(torch.int8), offs), "raw must be"),
            "raw_dims": ((raw[None], offs), "raw must be"),
            "offs_dtype": ((raw, offs.long()), "offs must be int32"),
            "offs_empty": ((raw, offs[:0]), "offs must be int32"),
            "two_devices": ((raw, offs.to("meta")), "one device"),
            "falls": ((raw, falls), "without a fall"),
            "not_from_0": ((raw, offs + 1), "from 0"),
            "not_to_S": ((raw[:-1], offs), "to S"),
            "host_falls": ((raw, offs, falls.numpy()), "without a fall"),
            "host_offs_shape": ((raw, offs, ho[:-1]), "host_offs must be"),
            "no_host_offs": (on_card, "need host_offs"),
            "device_falls": ((*on_card, falls.numpy()),
                             "without a fall")}[case]


@pytest.mark.parametrize("case", ["raw_dtype", "raw_dims", "offs_dtype",
                                  "offs_empty", "two_devices", "falls",
                                  "not_from_0", "not_to_S", "host_falls",
                                  "host_offs_shape", "no_host_offs",
                                  "device_falls"])
def test_myers_global_group_refusals(case):
    """The group entry refuses what the kernel does not take: wrong dtypes
    or ranks, tensors on two devices, offsets that fall, do not start at 0
    or do not end at S, host offsets of another shape; off the CPU it
    checks the host offsets (no read back from the device) and needs them;
    so does its plain version."""
    args, what = _refused(case)
    for fn in (t_ed.myers_global_group, t_ed.myers_global_group_plain):
        with pytest.raises(ValueError, match=what):
            fn(*args)


@pytest.mark.parametrize("shape", [(45, 45), (7, 45), (1, 3)])
def test_copy_rows_through_a_stage(shape):
    """A download larger than `umicluster.PINNED_BYTES` goes through one
    stage a run of whole rows at a time (runs of 7 rows of 45 here, the
    last one short): the result equals the matrix and can take the host
    rows."""
    rng = np.random.default_rng(28)
    d = torch.from_numpy(rng.integers(-9, 99, shape, dtype=np.int32))
    stage = torch.full((7 * 45 + 3,), -1, dtype=torch.int32)
    got = t_uc.copy_rows(d, stage)
    assert got.dtype == np.int32 and got.flags.writeable
    np.testing.assert_array_equal(got, d.numpy())
    assert got.ctypes.data != stage.data_ptr()


def _kernel_consts():
    """csrc/pairwise.cu's tile constants (R_WIDE and R_NARROW rows a
    thread, TT texts a tile, NW warps a block), read from its source."""
    import re
    src = (Path(t_ed.__file__).parents[1] / "csrc" / "pairwise.cu"
           ).read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("R_WIDE", "R_NARROW", "TT", "NW")}


def _kernel_bases():
    """The four base letters of csrc/pairwise.cu's BASES, in code order."""
    import re
    src = (Path(t_ed.__file__).parents[1] / "csrc" / "pairwise.cu"
           ).read_text()
    m = re.search(r"constexpr unsigned BASES = '(.)' \| '(.)' << 8 \| "
                  r"'(.)' << 16 \| '(.)' << 24;", src)
    return [ord(x) for x in m.groups()]


def _code_of(b, bases=tuple(_kernel_bases())):
    """The kernel's byte map (`code_of` in csrc/pairwise.cu): b & 0xDF
    against the BASES letters."""
    u = b & 0xDF
    return bases.index(u) if u in bases else 4


def _kernel_model(raw: bytes, offs, R, TT, NW, grid):
    """A numpy model of csrc/pairwise.cu: `grid` persistent blocks over
    (row tile of NW x R rows, text tile of TT texts) items, each a
    contiguous run; Peq by ballot (bit b from lane b's byte) in the top
    bits of the word, the row-0 carry at bit 32 - m; a table of R masks a
    byte through the kernel's byte map; a lane runs its own text's columns
    (PV and MV, uint32 wraparound) and stops, and its distance is the text
    length plus the pattern bits of PV less the bits of MV; rows outside
    1..32 nt are 0. Returns (d, tiles staged in shared
    memory, tiles read from global memory); every entry is written once."""
    U = np.uint64
    M32, one = U(0xFFFFFFFF), U(1)
    K, S = len(offs) - 1, len(raw)
    RT, SPAN = NW * R, TT * 32 + 32
    rb = np.frombuffer(raw, np.uint8).astype(np.int64)
    lut = np.array([_code_of(v) for v in range(256)])
    ntt, items = -(-K // TT), -(-K // RT) * -(-K // TT)
    d = np.full((K, K), -1, np.int64)
    paths = [0, 0]
    for blk in range(grid):
        for k in range(items * blk // grid, items * (blk + 1) // grid):
            rt, tt = divmod(k, ntt)
            rows = np.arange(rt * RT, min(rt * RT + RT, K))
            m = offs[rows + 1] - offs[rows]
            ok = (m >= 1) & (m <= 32)
            m = np.where(ok, m, 0)
            tab = np.zeros((len(rows), 256), np.uint64)
            for q, i in enumerate(rows):
                if ok[q]:
                    c = lut[rb[offs[i]:offs[i] + m[q]]]
                    eq = [int((1 << np.nonzero(c == x)[0]).sum())
                          << (32 - int(m[q])) for x in range(4)] + [0]
                    tab[q] = np.array(eq, np.uint64)[lut]
            carry = np.where(ok, one << (32 - m).astype(np.uint64),
                             U(0))[:, None]
            j0 = tt * TT
            xs = np.arange(j0, min(j0 + TT, K))
            a0 = offs[j0] & ~15
            paths[int(offs[xs[-1] + 1] - a0 > SPAN)] += 1
            b, tl = offs[xs], offs[xs + 1] - offs[xs]
            PV = np.full((len(rows), len(xs)), M32)
            MV = np.zeros_like(PV)
            for t in range(int(tl.max())):
                act = (t < tl)[None, :]
                eq = tab[:, rb[np.minimum(b + t, S - 1)]]
                Xv = eq | MV
                Xh = ((((eq & PV) + PV) & M32) ^ PV) | eq
                Ph = MV | (~(Xh | PV) & M32)
                Mh = PV & Xh
                Ph1 = ((Ph << one) + carry) & M32
                Mh1 = (Mh << one) & M32
                PV = np.where(act, Mh1 | (~(Xv | Ph1) & M32), PV)
                MV = np.where(act, Ph1 & Xv, MV)
            hm = (U(0) - carry) & M32             # the pattern's bits
            up = np.bitwise_count(PV & hm).astype(np.int64)
            down = np.bitwise_count(MV).astype(np.int64)
            blk_d = np.where(ok[:, None], tl[None, :] + up - down, 0)
            assert (d[rows[:, None], xs] == -1).all()
            d[rows[:, None], xs] = blk_d
    assert (d >= 0).all()
    return d, paths[0], paths[1]


def _model_case(umis, **kw):
    raw, offs, _ = t_ed.group_inputs(umis, "cpu")
    return (_kernel_model(raw.numpy().tobytes(), offs.numpy().astype(
        np.int64), **kw), t_ed.myers_global_group(raw, offs).numpy())


@pytest.mark.parametrize("seed", [26, 27])
def test_pairwise_kernel_model_equals_plain(seed):
    """The kernel's design (numpy model, at the source's TT and NW and
    both its R; one item a block, as a group of this size runs, and 5
    blocks of several items each, row tiles changing inside a block)
    equals the plain version, on a group of every length 1..32 nt, N, an
    empty and 33-nt UMIs, mixed case and other bytes."""
    umis = _mixed_group(seed) + _byte_group(seed)[-40:]
    c = _kernel_consts()
    for R in (c["R_WIDE"], c["R_NARROW"]):
        for grid in (10_000, 5):
            (d, staged, _), want = _model_case(umis, R=R, TT=c["TT"],
                                               NW=c["NW"], grid=grid)
            np.testing.assert_array_equal(d, want)
            assert staged > 0


@pytest.mark.parametrize("variant", ["r1_t64", "r2_t64", "r4_t128"])
def test_pairwise_kernel_model_variants(variant):
    """The model at kernel_variants.py's shapes (R rows a thread, TT texts
    a tile) on a group with long texts: tiles whose span exceeds the
    staging buffer read global memory, and the result does not change."""
    R, TT = (int(x[1:]) for x in variant.split("_"))
    rng = np.random.default_rng(40 + R + TT)
    umis = _mixed_group(28)
    umis += [dna.decode(rng.integers(0, 4, int(rng.integers(40, 90))))
             .encode() for _ in range(2 * TT)]
    umis += _mixed_group(29)[:50]
    (d, staged, direct), want = _model_case(umis, R=R, TT=TT, NW=8, grid=7)
    np.testing.assert_array_equal(d, want)
    assert staged > 0 and direct > 0


def test_kernel_byte_map_is_enc():
    """The kernel's byte map is `dna._ENC`: its code_of folds bit 5 and
    compares with the BASES letters, its table is written at each letter
    and its lower case, and that map sends all 256 byte values where
    `_ENC` does."""
    src = (Path(t_ed.__file__).parents[1] / "csrc" / "pairwise.cu"
           ).read_text()
    assert "const unsigned u = b & 0xDFu;" in src
    assert "(BASES >> 8 * c & 0xFFu) | (lane & 4) << 3" in src
    np.testing.assert_array_equal([_code_of(v) for v in range(256)],
                                  dna._ENC)


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
