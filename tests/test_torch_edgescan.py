"""The port's edge scans against sicelore_tpu's, for both chemistries, with
exact equality: the plain and composed two-half bodies against
make_edge_scan2_jnp (every row), the v1 composite scan (`scan_reads`) and the
bucketed chimera scan (`scan_internal`) against the JAX model's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sicelore_tpu.models import readscan as jax_readscan
from sicelore_tpu.ops import edgescan as jax_eg
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.models.readscan import ReadScanModel
from sicelore_tpu_torch.ops import edgescan as eg
from sicelore_tpu_torch.ops import editdist
from sicelore_tpu_torch.ops import tilescan_cuda as ts
from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig


def _cfgs(chem: str = "3p"):
    """One configuration for each side: (JAX package's, port's)."""
    cfg, tcfg = PipelineConfig(), TorchConfig()
    cfg.chemistry = tcfg.chemistry = chem
    return cfg, tcfg


def _partial_tso(rng, cfg):
    """A FWD read whose TSO has > maxNeedlemanMismatches errors but keeps an
    exact 9-base run (the consecutive-match bailout accepts it)."""
    wl = synth.make_whitelist(rng, 1)
    seq = bytearray(synth.make_read(rng, wl[0], cdna_len=400)["seq"])
    w = cfg.tso3p.window_for_tso_search
    seq[9:w] = b"C" * (w - 9)
    return bytes(seq)


def _reads(rng, chem: str, n: int = 96):
    """~96 reads: both strands, long (> 2E) and short (overlapping halves),
    garbage, a partial TSO, very short reads and reads with N bases."""
    cfg = PipelineConfig()
    make = synth.make_read_5p if chem == "5p" else synth.make_read
    wl = synth.make_whitelist(rng, 32)
    seqs = []
    for i in range(n - 8):
        if i % 7 == 3:
            clen = int(rng.integers(1200, 4000))
        elif i % 5 == 2:
            clen = int(rng.integers(40, 260))
        else:
            clen = int(rng.integers(260, 560))
        s = bytearray(make(rng, wl[i % 32], cdna_len=clen, error_rate=0.05,
                           reverse=bool(i % 2))["seq"])
        if i % 6 == 1:      # N near the head and near the tail
            s[int(rng.integers(0, 120))] = ord("N")
            s[len(s) - 1 - int(rng.integers(0, 120))] = ord("N")
        seqs.append(bytes(s))
    for L in (5, 15, 200, 400, 700):
        seqs.append(synth.random_seq(rng, L).encode())
    seqs.append(_partial_tso(rng, cfg))
    seqs.append(b"N" * 50 + b"A" * 30 + b"N" * 40)
    seqs.append(b"")
    quals = [bytes(33 + int(x) for x in rng.integers(3, 40, len(s)))
             for s in seqs]
    return seqs, quals


def _jax_meta(cfg, head, tail, lens):
    model = jax_readscan.ReadScanModel(cfg)
    body = jax_eg.make_edge_scan2_jnp(cfg)
    return np.asarray(body(jnp.asarray(head), jnp.asarray(tail),
                           jnp.asarray(lens), model.peq_ad, model.peq_adc,
                           model.peq_tso))


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_plain_edge_body_matches_jnp(chem):
    rng = np.random.default_rng(21 if chem == "3p" else 22)
    cfg, tcfg = _cfgs(chem)
    seqs, quals = _reads(rng, chem)
    head, tail, _, lens, _ = jax_eg.encode_two_half_int8(seqs, quals)
    ref = _jax_meta(cfg, head, tail, lens)

    codes, qv2, true_lens, qsum = eg.encode_two_half(seqs, quals)
    p = eg.edge_params(tcfg)
    got = edge_scan2(torch.from_numpy(codes), torch.from_numpy(true_lens),
                     p).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    for r in range(ref.shape[0]):
        bad = np.nonzero(ref[r] != got[r])[0]
        assert len(bad) == 0, (chem, r, bad[:5], ref[r, bad[:5]],
                               got[r, bad[:5]])
    assert ref[eg.ROW_STRANDED].mean() > 0.6

    ref_out = jax_eg.finalize_meta_np(ref, lens, cfg)
    out = eg.finalize_meta_np(got, true_lens, tcfg)
    jax_eg.compute_qvs2_np(*jax_eg.encode_two_half_int8(seqs, quals)[2:4],
                           ref_out, 16, chem == "5p")
    eg.compute_qvs2_np(qv2, true_lens, out, 16, chem == "5p", qsum)
    assert set(out) == set(ref_out)
    for k in ref_out:
        np.testing.assert_array_equal(out[k], ref_out[k], err_msg=k)


def test_plain_body_counts_and_tso_bailout():
    """The wrapper takes the plain body for CPU tensors (and counts it);
    the partial-TSO read reports T= through the bailout."""
    rng = np.random.default_rng(5)
    cfg = TorchConfig()
    seq = _partial_tso(rng, cfg)
    codes, _, lens, _ = eg.encode_two_half([seq], [b"I" * len(seq)])
    before = eg.edge_scan2_plain.launches
    meta = edge_scan2(torch.from_numpy(codes), torch.from_numpy(lens),
                      eg.edge_params(cfg)).numpy()
    assert eg.edge_scan2_plain.launches == before + 1
    assert edge_scan2.launches == 0
    assert meta[eg.ROW_STRANDED, 0] and meta[eg.ROW_IS_FWD, 0]
    assert meta[eg.ROW_TSO_ED, 0] > cfg.tso3p.max_needleman_mismatches
    assert meta[eg.ROW_TSO_END, 0] >= 0


def test_encoder_matches_jax_layouts():
    """Clean reads: the port's int8 halves equal JAX's 2-bit composite
    unpacked; N reads: they equal JAX's exact int8 encoder. The qual
    matrix, lengths and qual sums match the native/numpy composite."""
    rng = np.random.default_rng(3)
    seqs, quals = _reads(rng, "3p", n=48)
    codes, qv2, lens, qsum = eg.encode_two_half(seqs, quals)
    packed, qv2_j, lens_j, dirty, qsum_j = jax_eg.encode_composite_tm(
        seqs, quals)
    head, tail, lens_u = (np.asarray(a) for a in
                          jax_eg.unpack_tm(jnp.asarray(packed)))
    clean = ~dirty
    assert dirty.any() and clean.any()
    np.testing.assert_array_equal(codes[clean, :eg.E], head[clean])
    np.testing.assert_array_equal(codes[clean, eg.E:], tail[clean])
    h8, t8, qv8, lens8, qsum8 = jax_eg.encode_two_half_int8(seqs, quals)
    np.testing.assert_array_equal(codes[dirty, :eg.E], h8[dirty])
    np.testing.assert_array_equal(codes[dirty, eg.E:], t8[dirty])
    for a, b in ((qv2, qv2_j), (lens, lens_j), (lens, lens_u),
                 (qsum, qsum_j), (qv2, qv8), (qsum, qsum8)):
        np.testing.assert_array_equal(a, b)


def test_patterns_and_used_list_peq_match_jax_model():
    """The 'weights': the pattern bitmasks of one PipelineConfig and the
    Peq of one bound used-barcode list are identical on both sides."""
    from sicelore_tpu.utils import dna

    rng = np.random.default_rng(9)
    pats, _ = dna.encode_batch(
        [w.encode() for w in synth.make_whitelist(rng, 300)], 16)
    for chem in ("3p", "5p"):
        cfg, tcfg = _cfgs(chem)
        model = jax_readscan.ReadScanModel(cfg)
        for mine, ref in zip(eg.patterns_from_cfg(tcfg),
                             (model.peq_ad, model.peq_adc, model.peq_tso)):
            assert mine.dtype == np.uint32
            np.testing.assert_array_equal(mine, np.asarray(ref))
    model.prepare_search(pats, 300)
    port = ReadScanModel(tcfg, device="cpu")
    port.prepare_search(pats, 300)
    np.testing.assert_array_equal(port._peq_raw, model._peq_raw)
    ref_bc = np.asarray(model._peq_bc)            # padded to 1024 columns
    np.testing.assert_array_equal(port._peq_bc.numpy().view(np.uint32),
                                  ref_bc[:, :300])
    assert not ref_bc[:, 300:].any()
    # prefilter mode binds the q-gram table as well
    model.prepare_search(pats, 300, mode="prefilter", radius=2)
    port.prepare_search(pats, 300, mode="prefilter", radius=2)
    ref_qt = np.asarray(model._qgram_t)           # padded to 1024 columns
    assert port._qgram_t.dtype == torch.float32
    np.testing.assert_array_equal(port._qgram_t.numpy(), ref_qt[:, :300])
    assert not ref_qt[:, 300:].any() and ref_qt.sum() == 300 * 13
    np.testing.assert_array_equal(port._peq_bc.numpy().view(np.uint32),
                                  np.asarray(model._peq_bc)[:, :300])
    with pytest.raises(ValueError, match="unknown search mode"):
        port.prepare_search(pats, 300, mode="pallas")


def test_kernel_envelope_rejects_5p_on_cuda_only():
    """The fused kernel's envelope holds both chemistries (the name dates
    from when it left 5p out). A config outside it (an adapter window of
    129 columns) takes the composed body (adapter searches through
    myers_win1), which on CPU tensors computes what edge_scan2 computes
    there."""
    for chem in ("3p", "5p"):
        cfg = TorchConfig()
        cfg.chemistry = chem
        assert eg.edge_params(cfg).kernel_unsupported == ""
    cfg = TorchConfig()
    cfg.chemistry = "5p"
    cfg.adapter5p.adapter_search_window = 129
    p = eg.edge_params(cfg)
    assert p.kernel_unsupported == "adapter window"
    seqs, quals = _reads(np.random.default_rng(31), "5p", n=40)
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    ct = torch.from_numpy(codes)
    before = (eg.edge_scan2_composed.launches,
              editdist.myers_win1_plain.launches)
    got = eg.edge_scan2_composed(ct[:, :eg.E], ct[:, eg.E:],
                                 torch.from_numpy(lens), p)
    assert eg.edge_scan2_composed.launches == before[0] + 1
    assert editdist.myers_win1_plain.launches == before[1] + 3
    assert torch.equal(got, edge_scan2(ct, torch.from_numpy(lens), p))
    assert int(got[eg.ROW_STRANDED].sum()) > 20


def test_plain_oracles_never_reach_the_window_search():
    """edge_scan2_plain and tile_scan_plain are what the kernels are
    compared with: they must search through the plain sweep, not through
    myers_win1 (neither its kernel nor its counted plain version)."""
    from sicelore_tpu_torch.models import readscan

    rng = np.random.default_rng(8)
    cfg = TorchConfig()
    seqs, quals = _reads(rng, "3p", n=24)
    seqs.append(synth.make_chimera(rng, "ACGTACGTACGTACGT",
                                   "TTGCATGCATGCAAGT", cdna_len=500)["seq"])
    quals.append(b"I" * len(seqs[-1]))
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    rows, _, _ = readscan.build_tiles(seqs, cfg)
    before = (editdist.myers_win1.launches,
              editdist.myers_win1_plain.launches)
    for chem in ("3p", "5p"):
        c = TorchConfig()
        c.chemistry = chem
        eg.edge_scan2_plain(torch.from_numpy(codes[:, :eg.E]),
                            torch.from_numpy(codes[:, eg.E:]),
                            torch.from_numpy(lens), eg.edge_params(c))
    out = ts.tile_scan_plain(torch.tensor(rows), ts.tile_params(cfg))
    assert int((out[0] > 0).sum()) >= 1
    assert (editdist.myers_win1.launches,
            editdist.myers_win1_plain.launches) == before


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_scan_reads_matches_jax_model(chem):
    """The v1 composite scan: every key of scan_reads' dict equals the JAX
    model's (coordinates remapped to true reads, QVs, BC windows)."""
    rng = np.random.default_rng(41 if chem == "3p" else 42)
    cfg, tcfg = _cfgs(chem)
    seqs, quals = _reads(rng, chem)
    ref = jax_readscan.ReadScanModel(cfg).scan_reads(seqs, quals)
    before = editdist.myers_win1_plain.launches
    got = ReadScanModel(tcfg, device="cpu").scan_reads(seqs, quals)
    assert editdist.myers_win1_plain.launches == before + 3
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, (k, got[k].dtype, ref[k].dtype)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["stranded"].mean() > 0.6 and (ref["tso_end"] >= 0).any()


def test_composite_encoding_and_remap_match_jax():
    from sicelore_tpu_torch.models import readscan

    rng = np.random.default_rng(6)
    seqs, quals = _reads(rng, "3p", n=40)
    got = readscan.encode_composite(seqs, quals)
    ref = jax_readscan.encode_composite(seqs, quals)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    pos = rng.integers(-1, 2 * readscan.EDGE, len(seqs)).astype(np.int32)
    np.testing.assert_array_equal(
        readscan.remap_composite(pos, got[3]),
        jax_readscan.remap_composite(pos, ref[3]))


def test_scan_internal_matches_jax_model():
    """The bucketed full-length chimera scan on reads with and without
    internal junctions: site counts, starts, confirm EDs and split
    positions equal the JAX model's."""
    from sicelore_tpu.utils import dna

    rng = np.random.default_rng(17)
    cfg, tcfg = _cfgs("3p")
    wl = synth.make_whitelist(rng, 8)
    seqs, _ = _reads(rng, "3p", n=40)
    for i in range(6):
        seqs.append(synth.make_chimera(rng, wl[i], wl[i + 1],
                                       cdna_len=int(rng.integers(350, 600)),
                                       error_rate=0.03)["seq"])
    codes, lens = dna.encode_batch(seqs, 4608)
    ref = jax_readscan.ReadScanModel(cfg).scan_internal(codes, lens)
    before = editdist.myers_win1_plain.launches
    got = ReadScanModel(tcfg, device="cpu").scan_internal(codes, lens)
    assert editdist.myers_win1_plain.launches == before + 2
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    edmax = cfg.adapter3p.max_complete_seq_needleman_mismatches
    confirmed = ((ref["internal_a_ed"] <= edmax).any(axis=1)
                 | (ref["internal_t_ed"] <= edmax).any(axis=1))
    assert confirmed[-6:].all() and ref["n_internal_a"].max() >= 1
