"""The host engine's banded alignment in the port (`ops/hostnw_cuda.py`, the
plain PyTorch version on the CPU) against the JAX package's host engine
(`sicelore_tpu/ops/poa.py`): each pair's moves turned into aligned strings
against `nw_align_banded`, the center-star rows against `msa_center_star`,
and the batched engine's answers for the molecules it leaves to the host
engine against `consensus_reads`. Tolerance: exact (bytes) everywhere. The
plain version works in int32 as the kernel does, so its equality with the
host's int64 matrix also says int32 holds every value at these sizes."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from sicelore_tpu.ops import poa as jax_poa
from sicelore_tpu_torch.ops import hostnw_cuda as hn
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.utils import synth, trace


aligned = chip_smoke.hostnw_aligned
packed = chip_smoke.hostnw_packed


@pytest.mark.parametrize("name", chip_smoke.HOSTNW_CASES)
def test_plain_moves_are_the_host_alignment(name):
    pairs = chip_smoke.hostnw_pairs(name)
    before = hn.host_nw_plain.launches
    moves, n, mv_off = hn.align_pairs(*packed(pairs), "cpu")
    assert hn.host_nw_plain.launches == before + 1
    for p, (a, b) in enumerate(pairs):
        got = aligned(a, b, moves[mv_off[p]:mv_off[p] + n[p]])
        assert got == jax_poa.nw_align_banded(a, b), (name, p, len(a),
                                                      len(b))


def test_launches_split_by_slab_budget(monkeypatch):
    """A slab budget under the pairs' score rows cuts the batch into more
    launches; the moves land at the same places."""
    pairs = [p for name in ("equal", "n_lower", "band_edge")
             for p in chip_smoke.hostnw_pairs(name)]
    args = packed(pairs)
    whole = hn.align_pairs(*args, "cpu")
    monkeypatch.setattr(hn, "SLAB_BYTES", 300_000)
    before = hn.host_nw_plain.launches
    split = hn.align_pairs(*args, "cpu")
    assert hn.host_nw_plain.launches - before > 3
    for x, y in zip(whole, split):
        np.testing.assert_array_equal(x, y)


def test_wrapper_refuses_other_inputs():
    seq, a_off, la, b_off, lb = packed(chip_smoke.hostnw_pairs("tiny"))
    table = hn.pair_table(a_off, la, b_off, lb)
    s, t = torch.from_numpy(seq.copy()), torch.from_numpy(table)
    with pytest.raises(ValueError, match="uint8"):
        hn.host_nw(s.int(), t)
    with pytest.raises(ValueError, match=r"int64 \[P, 6\]"):
        hn.host_nw(s, t[:, :4])
    with pytest.raises(ValueError, match="S >= 1"):
        hn.host_nw(s[:0], t[:0])
    with pytest.raises(ValueError, match="lie in seq"):
        hn.host_nw(s[:10], t)
    bad = table.copy()
    bad[1, 4] += 1
    with pytest.raises(ValueError, match="layout"):
        hn.host_nw(s, torch.from_numpy(bad))
    with pytest.raises(ValueError, match="host_table"):
        hn.host_nw(s, t, table[:2])


def _molecules(rng):
    """Molecules 0-4 with an N (route n), 5-6 with a center over the
    engine's max_center_len (300 here; route long), 7 a molecule whose
    reads differ from its center by more than the band keeps, alone in its
    bucket (route nopair), 8-12 of one or two reads, 13-15 for the
    device route."""
    mols = []
    for depth, length in ((3, 180), (5, 240), (8, 120), (4, 290)):
        reads = synth.molecule_set(rng, 1, depth, 0.04, length)[0][0]
        s = bytearray(reads[1])
        s[len(s) // 2] = ord("N")
        reads[1] = bytes(s)
        mols.append(reads)
    mols.append([b"N" * 150, b"N" * 140, b"ACGT" * 30])
    for depth, length in ((3, 320), (6, 360)):
        mols += synth.molecule_set(rng, 1, depth, 0.04, length)[0]
    truth = synth.random_seq(rng, 280).encode()
    mols.append([truth, truth[:230], truth[:200]])       # alone at Lc 512
    mols += synth.molecule_set(rng, 3, 2, 0.04, 150)[0]
    mols += synth.molecule_set(rng, 2, 1, 0.04, 150)[0]
    mols += synth.molecule_set(rng, 3, 4, 0.04, 200)[0]      # device route
    return mols


def test_center_star_rows_are_msa_center_star():
    rng = np.random.default_rng(5)
    mols = [m for m in _molecules(rng) if len(m) >= 3]
    mols.append([b"", b"", b""])
    mols.append([b"ACGT", b"", b"AC"])
    star = hn.CenterStar(mols, "cpu")
    for m, seqs in enumerate(mols):
        assert star.rows(m) == jax_poa.msa_center_star(seqs), m
    assert list(star.pair_mol) == [m for m, s in enumerate(mols)
                                   for _ in range(len(s) - 1)]


@pytest.mark.parametrize("overflow", [False, True])
def test_engine_host_routes_are_the_host_engine(overflow, monkeypatch):
    """Routes n, long and nopair (and, forced, overflow: every device
    molecule's assembly handed back as too long) give the JAX host
    engine's bytes; the tracer counts each route's pairs."""
    rng = np.random.default_rng(11)
    mols = _molecules(rng)
    engine = poa_cuda.BatchedConsensusEngine(device="cpu",
                                             max_center_len=300)
    if overflow:
        run = engine._run_batch

        def every_one_overflows(results, info, *a, **kw):
            run(results, info, *a, **kw)
            return [mi for mi, _, _ in info]
        monkeypatch.setattr(engine, "_run_batch", every_one_overflows)
    trace.enable()
    try:
        got = engine(mols, minps=3, maxps=20)
        snap = trace.snapshot()
    finally:
        trace.disable()
    routes = {c["attrs"]["route"]: c["value"] for c in snap["counters"]
              if c["name"] == "consensus.molecules"}
    pairs = {(c["attrs"]["route"], c["attrs"]["where"]): c["value"]
             for c in snap["counters"] if c["name"] == "consensus.host_pairs"}
    want = {"n": 2 + 4 + 7 + 3 + 2, "long": 2 + 5, "nopair": 2}
    if overflow:
        want["overflow"] = 3 * 3
    assert pairs == {(r, "host"): k for r, k in want.items()}
    assert routes["overflow"] == (3 if overflow else 0)
    assert routes["device"] == (0 if overflow else 3)
    for m, seqs in enumerate(mols):
        if overflow or m < 13:
            assert got[m] == jax_poa.consensus_reads(seqs, 3, 20), m


def test_refine_host_routes_are_the_host_engine():
    """The refine pass's host routes take the same path: the host
    engine's answer from the molecule's reads (routes n and long: the
    nopair molecule has pairs against its consensus)."""
    rng = np.random.default_rng(12)
    mols = _molecules(rng)
    engine = functools.partial(poa_cuda.BatchedConsensusEngine(
        device="cpu", max_center_len=300), refine=True)
    got = engine(mols, minps=3, maxps=20)
    for m in range(7):
        assert got[m] == jax_poa.consensus_reads(mols[m], 3, 20), m


def test_host_aligned_routes_leave_the_host_engine_uncalled(monkeypatch):
    """Molecules of three or more reads never reach `consensus_reads`."""
    from sicelore_tpu_torch.ops import poa
    calls = []
    inner = poa.consensus_reads

    def counted(seqs, *a):
        calls.append(len(seqs))
        return inner(seqs, *a)
    monkeypatch.setattr(poa, "consensus_reads", counted)
    mols = _molecules(np.random.default_rng(13))
    poa_cuda.BatchedConsensusEngine(device="cpu", max_center_len=300)(mols)
    assert calls and max(calls) <= 2
