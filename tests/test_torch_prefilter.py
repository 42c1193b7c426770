"""The port's q-gram prefilter search against sicelore_tpu's: the [5, B]
rows of `qgram_prefilter_search` (overflow included) on the three input sets
of tests/test_bcsearch_prefilter.py, and `prepare_search(mode="prefilter")`
with the fused and sweep-only searches against the JAX model. Exact
equality (integer outputs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicelore_tpu.models import readscan as jax_readscan
from sicelore_tpu.ops import bcsearch as jax_bc
from sicelore_tpu.utils import dna, synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.models.readscan import ReadScanModel
from sicelore_tpu_torch.ops import bcsearch, editdist
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig


def _mutate(rng, s: str, ned: int) -> str:
    codes = list(dna.encode(s))
    for _ in range(ned):
        op = rng.integers(0, 3)
        pos = int(rng.integers(0, len(codes)))
        if op == 0:
            codes[pos] = (codes[pos] + 1 + int(rng.integers(0, 3))) % 4
        elif op == 1 and len(codes) > 1:
            del codes[pos]
        else:
            codes.insert(pos, int(rng.integers(0, 4)))
    return dna.decode(np.array(codes, dtype=np.int8))


def _set_mixed(rng):
    """Windows holding a barcode at ED 0..3 between random flanks."""
    wl = synth.make_whitelist(rng, 600)
    wins = np.full((64, 22), 5, np.int8)
    for b in range(64):
        s = _mutate(rng, wl[int(rng.integers(0, 600))],
                    (0, 0, 1, 1, 2, 3)[b % 6])
        flank = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, 8))
        full = (flank[:3] + s + flank[3:])[:22]
        wins[b, :len(full)] = dna.encode(full)
    wins[5, 7] = 4                                   # an N inside a window
    return wl, wins, 32


def _set_indels(rng):
    """One deletion and one insertion a window: shifted alignment frames."""
    wl = synth.make_whitelist(rng, 600)
    wins = np.full((32, 22), 5, np.int8)
    for b in range(32):
        codes = list(dna.encode(wl[int(rng.integers(0, 600))]))
        del codes[int(rng.integers(2, 14))]
        codes.insert(int(rng.integers(2, 14)), int(rng.integers(0, 4)))
        s = "AGT" + dna.decode(np.array(codes, np.int8)) + "CCA"
        wins[b, :len(s)] = dna.encode(s)
    return wl, wins, 32


def _set_overflow(rng):
    """40 barcodes within ED 1 of each other and K = 8: every read passes
    more than K candidates."""
    base = "ACGTACGTACGTACGT"
    wl = []
    for i in range(40):
        codes = list(dna.encode(base))
        codes[i % 16] = (codes[i % 16] + 1 + i // 16) % 4
        wl.append(dna.decode(np.array(codes, np.int8)))
    wl = sorted(set(wl))
    wins = np.full((4, 22), 5, np.int8)
    wins[:, :16] = dna.encode(base)
    return wl, wins, 8


SETS = {"mixed": (_set_mixed, 7), "indels": (_set_indels, 3),
        "overflow": (_set_overflow, 0)}


@pytest.mark.parametrize("name", sorted(SETS))
def test_prefilter_rows_match_jax(name):
    make, seed = SETS[name]
    wl, wins, K = make(np.random.default_rng(seed))
    N, m, R = len(wl), 16, 2
    pats, _ = dna.encode_batch([w.encode() for w in wl], m)
    peq = editdist.build_peq(pats)
    qt = bcsearch.build_qgram_table(pats)
    np.testing.assert_array_equal(qt, jax_bc.build_qgram_table(pats))
    assert bcsearch.qgram_threshold(m, R) == jax_bc.qgram_threshold(m, R)
    ref = np.asarray(jax_bc.qgram_prefilter_search(
        jnp.asarray(wins), jnp.asarray(qt), jnp.asarray(peq),
        jnp.asarray([N], np.int32), m, R, K=K))
    got = bcsearch.qgram_prefilter_search(
        torch.from_numpy(wins), torch.from_numpy(qt),
        bcsearch.peq_device(peq, "cpu"), N, m, R, K=K)
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, len(wins))
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "overflow":
        assert ref[4].all()
    else:
        assert not ref[4].any() and (ref[0] <= R).sum() > len(wins) // 2
        assert (ref[0] == bcsearch.BIG).any() or name == "indels"


def test_prefilter_equals_brute_sweep_within_radius():
    """Where the best ED lies within the radius the prefilter reports the
    brute sweep's ed and idx; beyond it, BIG. The candidate ranking breaks
    score ties by the lower index, so lanes >= nvalid never enter."""
    wl, wins, K = _set_mixed(np.random.default_rng(11))
    m, R, nvalid = 16, 2, 500
    pats, _ = dna.encode_batch([w.encode() for w in wl], m)
    peq = bcsearch.peq_device(editdist.build_peq(pats), "cpu")
    got = bcsearch.qgram_prefilter_search(
        torch.from_numpy(wins), torch.from_numpy(
            bcsearch.build_qgram_table(pats)), peq, nvalid, m, R, K=K).numpy()
    brute = bcsearch.bc_sweep_plain(
        torch.from_numpy(wins.T.astype(np.uint8).copy()), peq, nvalid, m
    ).numpy()
    near = brute[0] <= R
    assert near.sum() > 20 and (~near).any()
    np.testing.assert_array_equal(got[0, near], brute[0, near])
    np.testing.assert_array_equal(got[1, near], brute[1, near])
    np.testing.assert_array_equal(got[3, near], brute[3, near])
    assert (got[0, ~near] == bcsearch.BIG).all()
    assert (got[1, near] < nvalid).all()


@pytest.fixture(scope="module")
def bound_models():
    """Both models in prefilter mode over one used list; K = 4 is small
    enough that reads of the crowded cells overflow and are redone."""
    rng = np.random.default_rng(23)
    wl = synth.make_whitelist(rng, 200)
    crowd = []
    for i in range(12):                # 12 barcodes within ED 1 of wl[0]
        c = list(wl[0])
        c[i] = "ACGT"[("ACGT".index(c[i]) + 1) % 4]
        crowd.append("".join(c))
    used = wl[:150] + crowd
    pats, _ = dna.encode_batch([w.encode() for w in used], 16)
    seqs, quals = [], []
    for i in range(72):
        bc = used[0] if i % 6 == 0 else used[int(rng.integers(0, len(used)))]
        r = synth.make_read(rng, bc, cdna_len=int(rng.integers(150, 500)),
                            error_rate=0.05 if i % 3 else 0.12,
                            reverse=bool(i % 2))
        seqs.append(r["seq"])
        quals.append(r["qual"])
    ref = jax_readscan.ReadScanModel(PipelineConfig())
    port = ReadScanModel(TorchConfig(), device="cpu")
    for model in (ref, port):
        model.prepare_search(pats, len(used), radius=2, mode="prefilter",
                             K=4)
    return ref, port, seqs, quals


def test_prefilter_fused_search_matches_jax_model(bound_models):
    ref, port, seqs, quals = bound_models
    ref_out, ref_bc = ref.finish_search(ref.scan_search_async(seqs, quals))
    out, bc = port.finish_search(port.scan_search_async(seqs, quals))
    assert np.asarray(out["overflow"]).sum() >= 4      # the redo ran
    for k in ("is_fwd", "stranded", "ps", "pe", "ae", "tso_end", "x_qv"):
        np.testing.assert_array_equal(out[k], ref_out[k], err_msg=k)
    np.testing.assert_array_equal(bc["ed"], ref_bc["ed"])
    np.testing.assert_array_equal(bc["ed2"], ref_bc["ed2"])
    found = ref_bc["ed"] <= 2
    assert found.sum() > 40 and (~found).any()
    np.testing.assert_array_equal(bc["idx"][found], ref_bc["idx"][found])
    assert (bc["ed"][~found] == bcsearch.BIG).all()


def test_prefilter_sweep_only_matches_jax_model(bound_models):
    """The cached pipeline's pass 2 in prefilter mode: finish_bc_sweep
    over the pass-1 windows, overflow redo included."""
    ref, port, seqs, quals = bound_models
    _, wins, _ = port.finish_pass1_full(
        port.scan_pass1_full_async(seqs, quals))
    _, ref_wins, _ = ref.finish_pass1_full(
        ref.scan_pass1_full_async(seqs, quals))
    np.testing.assert_array_equal(wins, ref_wins)
    ref_bc = ref.finish_bc_sweep(ref.bc_sweep_async(ref_wins))
    bc = port.finish_bc_sweep(port.bc_sweep_async(wins))
    np.testing.assert_array_equal(bc["ed"], ref_bc["ed"])
    np.testing.assert_array_equal(bc["ed2"], ref_bc["ed2"])
    found = ref_bc["ed"] <= 2
    np.testing.assert_array_equal(bc["idx"][found], ref_bc["idx"][found])


def test_prefilter_agrees_with_sweep_mode_within_radius(bound_models):
    """Prefilter against the port's own brute mode on the same reads:
    equal ed and idx wherever the sweep's best ED lies within the radius."""
    _, port, seqs, quals = bound_models
    _, pre = port.finish_search(port.scan_search_async(seqs, quals))
    brute = ReadScanModel(TorchConfig(), device="cpu")
    brute.prepare_search(np.zeros((0, 16), np.int8), 0)
    brute._peq_raw, brute._peq_bc, brute._n_valid = \
        port._peq_raw, port._peq_bc, port._n_valid
    _, ref = brute.finish_search(brute.scan_search_async(seqs, quals))
    near = ref["ed"] <= 2
    assert near.sum() > 40
    np.testing.assert_array_equal(pre["ed"][near], ref["ed"][near])
    np.testing.assert_array_equal(pre["idx"][near], ref["idx"][near])
    assert (pre["ed"][~near] == bcsearch.BIG).all()
