"""The port's consensus engine (plain torch bodies on the CPU) against the
JAX package: the plain band alignment and votes against the jnp reference
`consensus_votes`, the engine against the production Pallas route in
interpret mode and against the jnp route at maxps > 63, and the QV table
against both JAX QV formulations. Tolerance: exact (integers and bytes)
everywhere."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicelore_tpu.ops import poa_tpu as jax_poa
from sicelore_tpu_torch.ops import poa_cuda as pc
from sicelore_tpu_torch.utils import synth, trace


def _indel_molecule(rng, length, n_reads, ins_lo, ins_hi):
    """Reads with an insertion run longer than K_INS and a deletion."""
    truth = synth.random_seq(rng, length)
    reads = []
    for _ in range(n_reads):
        pos = int(rng.integers(40, length - 40))
        ins = synth.random_seq(rng, int(rng.integers(ins_lo, ins_hi)))
        s = truth[:pos] + ins + truth[pos:]
        dpos = int(rng.integers(20, 120))
        s = s[:dpos] + s[dpos + int(rng.integers(1, 9)):]
        reads.append(synth.mutate(rng, s, 0.03).encode())
    return reads


def _w32_set(rng):
    """The W = 32 set of tests/test_poa_tpu.py::test_pallas_parity_w32:
    plain molecules, insertion runs longer than K_INS, length differences
    next to the drop threshold (W/2 - 4 = 12), a center of exactly 256."""
    mols, _ = synth.molecule_set(rng, 5, 5, 0.08, 220)
    for _ in range(3):
        mols.append(_indel_molecule(rng, 200, 4, 6, 11))
    truth = synth.random_seq(rng, 240)
    mols.append([truth.encode(), truth[:229].encode(),
                 (truth + "ACGTACGTACG").encode(),
                 synth.mutate(rng, truth, 0.05).encode()])
    truth = synth.random_seq(rng, 256)
    mols.append([synth.mutate(rng, truth, 0.04).encode() for _ in range(4)]
                + [truth.encode()])
    return mols


def _w64_set(rng):
    """The W = 64 set of test_pallas_parity_w64 (Lc = 1024 bucket)."""
    mols, _ = synth.molecule_set(rng, 2, 4, 0.06, 560)
    truth = synth.random_seq(rng, 600)
    reads = []
    for _ in range(5):
        pos = int(rng.integers(100, 500))
        s = truth[:pos] + synth.random_seq(rng, 7) + truth[pos:]
        reads.append(synth.mutate(rng, s, 0.04).encode())
    mols.append(reads)
    return mols


def _with_n(rng, length=230, depth=4):
    mols, _ = synth.molecule_set(rng, 1, depth, 0.05, length)
    s = bytearray(mols[0][1])
    s[50] = s[120] = ord("N")
    mols[0][1] = bytes(s)
    c = bytearray(mols[0][0])
    c[77] = ord("N")
    mols[0][0] = bytes(c)
    return mols[0]


def _same(got, ref):
    assert len(got) == len(ref)
    for i, ((gc, gq), (rc, rq)) in enumerate(zip(got, ref)):
        assert gc == rc, (i, gc, rc)
        assert gq == rq, (i, gq, rq)


# ---------------------------------------------------------------------------
# plain votes vs the jnp reference
# ---------------------------------------------------------------------------

def _votes_case(name):
    if name == "w32":
        rng = np.random.default_rng(31)
        mols = _w32_set(rng)[3:]
        # keep the 256-base truth the center: exactly the bucket size
        mols[-1] = [r[:255] for r in mols[-1][:-1]] + [mols[-1][-1]]
        # an infeasible pair (the read ends outside the band), a read and a
        # center with N
        truth = synth.random_seq(rng, 230)
        mols.append([truth.encode(), truth[:190].encode(),
                     synth.mutate(rng, truth, 0.05).encode()])
        mols.append(_with_n(rng))
        return mols, 256, 32
    rng = np.random.default_rng(32)
    mols = _w64_set(rng)[1:]
    mols.append(_indel_molecule(rng, 1000, 3, 6, 11))
    return mols, 1024, 64


@pytest.mark.parametrize("name", ["w32", "w64"])
def test_plain_votes_match_jnp_reference(name):
    """`band_align` on CPU tensors (its plain version) and `segment_votes`
    against `consensus_votes`, whose col_votes carry one more column, an
    empty one."""
    mols, Lc, W = _votes_case(name)
    center, clens, reads, rlens, mids = synth.pair_arrays(mols, Lc, W)
    M = len(mols)
    ref = jax_poa.consensus_votes(
        *(jnp.asarray(a) for a in (center, clens, reads, rlens, mids)), W, M)
    first = np.searchsorted(mids, np.arange(M))
    t_mids = torch.from_numpy(mids)
    before = pc.band_align_plain.launches
    aligned, ins, feas = pc.band_align(
        torch.from_numpy(reads), torch.from_numpy(rlens), t_mids,
        torch.from_numpy(center[first]), torch.from_numpy(clens[first]),
        Lc, W)
    assert pc.band_align_plain.launches == before + 1
    cv, iv, pairs = pc.segment_votes(aligned, ins, feas, t_mids, M)
    got = (torch.cat([cv, torch.zeros((M, 1, 5), dtype=torch.int32)], 1),
           iv, pairs)
    for g, r, what in zip(got, ref, ("col_votes", "ins_votes", "pairs")):
        r = np.asarray(r)
        assert g.dtype == torch.int32 and tuple(g.shape) == r.shape, what
        np.testing.assert_array_equal(g.numpy(), r, err_msg=what)
    col, ins, pairs = (g.numpy() for g in got)
    assert pairs.sum() >= len(reads) - 2 and ins.max() >= 2
    if name == "w32":
        assert pairs[-2] == 1           # the short read is infeasible
        assert ins[:, :, pc.K_INS - 1].sum() > 0   # runs past K_INS


def test_band_align_contract_on_cpu():
    """`band_align` on CPU tensors runs (and counts) the plain version; its
    per-pair outputs sum to the votes."""
    rng = np.random.default_rng(33)
    mols = _w32_set(rng)[:6]
    center, clens, reads, rlens, mids = synth.pair_arrays(mols, 256, 32)
    first = np.searchsorted(mids, np.arange(len(mols)))
    before = pc.band_align_plain.launches
    aligned, ins, feas = pc.band_align(
        torch.from_numpy(reads), torch.from_numpy(rlens),
        torch.from_numpy(mids), torch.from_numpy(center[first]),
        torch.from_numpy(clens[first]), 256, 32)
    assert pc.band_align_plain.launches == before + 1
    assert pc.band_align.launches == 0
    P = len(mids)
    assert aligned.shape == (P, 257) and aligned.dtype == torch.int8
    assert ins.shape == (P, 257, pc.K_INS, 4) and ins.dtype == torch.int8
    assert feas.dtype == torch.int32 and int(feas.sum()) == P
    assert bool((aligned[:, 256] == 5).all())
    ref = jax_poa.consensus_votes(
        *(jnp.asarray(a) for a in (center, clens, reads, rlens, mids)),
        32, len(mols))
    cv, iv, pairs = pc.segment_votes(aligned, ins, feas,
                                     torch.from_numpy(mids), len(mols))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(ref[0])[:, :256])
    np.testing.assert_array_equal(iv.numpy(), np.asarray(ref[1]))
    with pytest.raises(ValueError, match="reads must be"):
        pc.band_align(torch.from_numpy(reads[:, :100]),
                      torch.from_numpy(rlens), torch.from_numpy(mids),
                      torch.from_numpy(center[first]),
                      torch.from_numpy(clens[first]), 256, 32)


# ---------------------------------------------------------------------------
# the engine vs the production route (Pallas, interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_production():
    return jax_poa.BatchedConsensusEngine(force="pallas-interpret")


@pytest.fixture(scope="module")
def port_engine():
    return pc.BatchedConsensusEngine(device="cpu")


def test_engine_matches_production_route_w32(jax_production, port_engine):
    """The W = 32 set plus every host-engine route: 1 read, 2 reads, a
    molecule with N, a center over 2,048, a molecule whose reads all fall
    to the drop rule beside one that keeps its pairs."""
    rng = np.random.default_rng(7)
    mols = _w32_set(rng)
    mols.append([b"ACGTACGTAA"])
    mols.append([b"ACGTACGTAA", b"ACGTACGTAAACG"])
    mols.append(_with_n(rng))
    long_truth = synth.random_seq(rng, 2100)
    mols.append([synth.mutate(rng, long_truth, 0.02).encode()
                 for _ in range(3)])
    truth = synth.random_seq(rng, 250)
    mols.append([truth.encode(), truth[:200].encode(), truth[:210].encode()])
    before = pc.band_align_plain.launches
    got = port_engine(mols)
    assert pc.band_align_plain.launches > before
    _same(got, jax_production(mols))
    assert got[-5][0] == b"ACGTACGTAA" and got[-4][0] == b"ACGTACGTAAACG"
    assert got[-1][0] == truth.encode()       # the center alone votes


def test_engine_matches_production_route_w64(jax_production, port_engine):
    mols = _w64_set(np.random.default_rng(8))
    _same(port_engine(mols), jax_production(mols))


def test_engine_refine_matches_production_route(jax_production, port_engine):
    rng = np.random.default_rng(9)
    mols, truths = synth.molecule_set(rng, 3, 6, 0.09, 230)
    mols.append([b"ACGTACGTAA"])
    got = port_engine(mols, refine=True)
    _same(got, jax_production(mols, refine=True))
    assert got[-1][0] == b"ACGTACGTAA"
    assert got != port_engine(mols) or all(
        g[0].decode() == t for g, t in zip(got, truths))


def test_sub_batches_do_not_change_results(port_engine, monkeypatch):
    """A bucket cut into sub-batches at molecule boundaries gives the same
    bytes as the bucket in one piece."""
    rng = np.random.default_rng(10)
    mols, _ = synth.molecule_set(rng, 7, 4, 0.06, 150)
    truth = synth.random_seq(rng, 200)        # no surviving pair, last
    mols.append([truth.encode(), truth[:150].encode(), truth[:160].encode()])
    whole = port_engine(mols)
    monkeypatch.setattr(pc, "PAIRS_PER_CALL", 5)
    before = pc.band_align_plain.launches
    cut = port_engine(mols)
    assert pc.band_align_plain.launches - before >= 3
    assert cut == whole
    idx = list(pc.BatchedConsensusEngine._sub_batches(
        [0, 0, 0, 1, 1, 1, 3, 3], 6))
    assert idx == [(0, 2, 0, 6), (2, 6, 6, 8)]


# ---------------------------------------------------------------------------
# maxps > 63: the jnp route (band = self.band, no N screen, every assembly
# kept, however long)
# ---------------------------------------------------------------------------

def _jnp_route_case(band, maxps):
    """The W = 32 set, an N, two reads, and two reads with a run of ten A
    beside their center: an insertion slot of 14 votes where R is 3, which
    the jnp route's float64 QV takes as full agreement."""
    rng = np.random.default_rng(40 + band)
    mols = _w32_set(rng)[2:8]
    mols.append(_with_n(rng))
    mols.append([b"ACGTACGTAA", b"ACGTACGTAAACG"])
    t = synth.random_seq(np.random.default_rng(3), 200)
    run = (t[:20] + t[30:100] + "A" * 10 + t[100:]).encode()
    mols.append([t.encode(), run, run])
    ref = jax_poa.BatchedConsensusEngine(band=band, force="jnp")(
        mols, maxps=maxps)
    got = pc.BatchedConsensusEngine(band=band, device="cpu")(mols,
                                                             maxps=maxps)
    _same(got, ref)
    assert max(max(q) for _, q in got) == 33 + maxps


@pytest.mark.parametrize("band", [64, 32])
def test_engine_matches_jnp_route_at_maxps_64(band):
    _jnp_route_case(band, 64)


def test_engine_matches_jnp_route_at_maxps_120():
    _jnp_route_case(64, 120)


def test_engine_keeps_long_assemblies_above_maxps_63(monkeypatch):
    """An assembly longer than the device route's output row (Lc + Lc // 8
    + 16) is the device's above maxps 63, as the jnp route keeps it, and
    the host engine's (route overflow) at maxps 20. Reads alone hardly make
    one under linear gaps, so both engines' votes get one more A vote of
    every pair in every insertion slot."""
    rng = np.random.default_rng(44)
    mols, _ = synth.molecule_set(rng, 2, 4, 0.05, 200)

    def more_a(iv, mids, M):
        iv = np.array(iv)
        per_mol = np.bincount(np.asarray(mids), minlength=M)[:M]
        iv[..., 0] += per_mol[:, None, None].astype(iv.dtype)
        return iv

    jax_votes, port_votes = jax_poa.consensus_votes, pc.segment_votes

    def jax_more(center, clens, reads, rlens, mids, W, M):
        cv, iv, n = jax_votes(center, clens, reads, rlens, mids, W, M)
        return cv, jnp.asarray(more_a(iv, mids, M)), n

    def port_more(aligned, ins, feasible, mids, M):
        cv, iv, n = port_votes(aligned, ins, feasible, mids, M)
        return cv, torch.from_numpy(more_a(iv, mids, M)), n

    monkeypatch.setattr(jax_poa, "consensus_votes", jax_more)
    monkeypatch.setattr(pc, "segment_votes", port_more)
    ref = jax_poa.BatchedConsensusEngine(force="jnp")(mols, maxps=64)
    got = pc.BatchedConsensusEngine(device="cpu")(mols, maxps=64)
    _same(got, ref)
    assert all(len(c) > 256 + 256 // 8 + 16 for c, _ in got)
    trace.enable()
    try:
        pc.BatchedConsensusEngine(device="cpu")(mols, maxps=20)
        snap = trace.snapshot()
    finally:
        trace.disable()
    routes = {c["attrs"]["route"]: c["value"] for c in snap["counters"]
              if c["name"] == "consensus.molecules"}
    assert routes["overflow"] == 2 and routes["device"] == 0


# ---------------------------------------------------------------------------
# QV rounding: the host-built table vs both JAX formulations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maxps", [20, 63])
def test_qv_table_matches_both_jax_formulations(maxps):
    """Every (win, R) with win <= R <= 64: the float32 device formulation
    (assemble_votes) and the float64 host one (_assemble) against the
    table, and the port's assemble_votes on the same votes."""
    RMAX = Lc = 64
    table = pc.qv_table(maxps, RMAX)
    assert table.shape == (RMAX + 1, RMAX + 1) and table.dtype == np.uint8
    # molecule r (R = r + 1 votes): column c holds win = c + 1 votes for A
    cv = np.zeros((RMAX, Lc, 5), np.int32)
    cv[:, :, 0] = np.arange(Lc)[None, :]
    iv = np.zeros((RMAX, Lc + 1, pc.K_INS, 4), np.int32)
    pcount = np.arange(RMAX, dtype=np.int32)
    centers = np.zeros((RMAX, Lc), np.int8)
    clen = np.arange(1, RMAX + 1, dtype=np.int32)
    packed, out_len, _, _ = jax_poa.assemble_votes(
        *(jnp.asarray(a) for a in (cv, iv, pcount, centers, clen)),
        maxps=maxps, out_cols=Lc)
    packed, out_len = np.asarray(packed), np.asarray(out_len)
    codes, qv, lens = pc.assemble_votes(
        *(torch.from_numpy(a) for a in (cv, iv, pcount, centers, clen)),
        maxps)
    np.testing.assert_array_equal(lens.numpy(), out_len)
    assert not codes.any()
    qv = np.split(qv.numpy(), np.cumsum(out_len)[:-1])
    for r in range(RMAX):
        R = r + 1
        want = table[1:R + 1, R]
        assert out_len[r] == R
        np.testing.assert_array_equal(packed[r, :R] >> 2, want)   # float32
        np.testing.assert_array_equal(qv[r], want)
        _, q64 = jax_poa.BatchedConsensusEngine._assemble(
            b"A" * R, cv[r], iv[r], r, maxps)                     # float64
        np.testing.assert_array_equal(
            np.frombuffer(q64, np.uint8) - 33, want)
    assert table[1, 1] == maxps and table[1, 2] == 3
