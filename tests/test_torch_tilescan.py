"""The port's plain tile chimera scan against sicelore_tpu's jnp tile inner
(_make_internal_tile_inner) on build_tiles rows: exact equality."""
import jax.numpy as jnp
import numpy as np
import torch

from sicelore_tpu.models import readscan as jax_readscan
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig
from sicelore_tpu_torch.models import readscan
from sicelore_tpu_torch.ops import tilescan_cuda as ts


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
