"""The fused short-read tile feed (`ops/tilescan_cuda.tile_feed`) and the
cached pipeline's fused route against the JAX package, on the CPU (plain
torch bodies), exact equality:

  * the feed's rows of the covered reads' index equal `build_tiles`' row of
    each (the native tiler and its numpy fallback), inert rows for an index
    of any other read; a numpy model of csrc/tilefeed.cu's word build
    gives the same rows;
  * feed + tile scan equal the JAX `make_composite_tile_fn` on the JAX
    composite of the same reads (the Pallas tile kernel stood in for by its
    documented contract, the jnp inner: interpret mode takes minutes);
  * `tiles_fused_mask` / `finish_tiles_merged` equal the JAX methods;
  * the port's cached pipeline with the fused route forced writes the
    bytes of the JAX cached pipeline (host route) and of its own host route,
    3p and 5p; with N reads, the JAX streaming run's;
  * the route rule, and the last JAX helpers without a port counterpart
    (`scan.internal_polyat`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sicelore_tpu.models import readscan as j_readscan
from sicelore_tpu.ops import edgescan as j_eg
from sicelore_tpu.ops import editdist as j_editdist
from sicelore_tpu.ops import scan as j_scan
from sicelore_tpu.ops import tilescan_tpu
from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline as JaxPipeline
from sicelore_tpu.utils import dna as j_dna
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.io import native
from sicelore_tpu_torch.models import readscan
from sicelore_tpu_torch.ops import edgescan as eg
from sicelore_tpu_torch.ops import scan
from sicelore_tpu_torch.ops import tilescan_cuda as ts
from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig
from test_torch_scanfastq import (_cfg5p, _same_outputs, _write_fastq,
                                  n_dir, run5p_dir)  # noqa: F401 fixtures


def _feed(seqs, quals, cfg=None, index="covered"):
    """(feed rows [C, 528] uint8, lens, the feed's TileParams, the index
    [C] fed) on the CPU: the covered reads' index (the fused route's), or
    every read's ("all")."""
    tp = ts.tile_params(cfg or TorchConfig())
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    idx = np.nonzero(ts.feed_covered(lens, tp))[0] if index == "covered" \
        else np.arange(len(lens))
    idx = idx.astype(np.int32)
    return (ts.tile_feed(torch.from_numpy(codes), torch.from_numpy(lens),
                         torch.from_numpy(idx), tp).numpy(), lens, tp, idx)


def _tiles3(seqs, quals, cfg=None):
    """The fused route's chimera scan [3, B] on the CPU: the feed + scan of
    the covered reads, scattered back to their reads (n = 0, no split
    elsewhere), as `finish_pass1_full` does."""
    rows, lens, tp, idx = _feed(seqs, quals, cfg)
    tiles3 = np.zeros((3, len(lens)), np.int32)
    tiles3[1:] = -1
    tiles3[:, idx] = ts.tile_scan_plain(torch.from_numpy(rows), tp).numpy()
    return tiles3, lens, tp


@pytest.fixture(scope="module")
def edge_reads():
    return chip_smoke.feed_edge_reads(np.random.default_rng(3))


@pytest.mark.parametrize("tiler", ["native", "numpy"])
def test_feed_rows_equal_build_tiles(edge_reads, monkeypatch, tiler):
    """Every covered read's feed row is byte for byte build_tiles' one row
    for it (lengths 315, 316, 607, 608, 609, chimeras of at most 2E bases,
    reads with N, lowercase, other bytes and NUL, 3p and 5p reads); every
    other read's row is inert: PAD codes, zero meta."""
    if tiler == "numpy":
        monkeypatch.setattr(native, "get_hostenc", lambda: None)
    elif native.get_hostenc() is None:
        pytest.skip("the native host codecs are not built here")
    seqs, quals = edge_reads
    cfg = TorchConfig()
    rows, lens, tp, idx = _feed(seqs, quals, cfg)
    tiles, read_idx, g0s = readscan.build_tiles(seqs, cfg)
    cov = ts.feed_covered(lens, tp)
    assert cov.sum() > 100 and (~cov).sum() > 10
    for L in (316, 607, 608):
        assert cov[lens == L].all()
    assert not cov[np.isin(lens, (315, 609))].any()
    np.testing.assert_array_equal(idx, np.nonzero(cov)[0])
    assert rows.shape == (cov.sum(), ts.ROW_BYTES)
    t_of = {int(r): t for t, r in enumerate(read_idx)}
    for i, r in enumerate(idx):
        t = t_of[int(r)]
        assert g0s[t] == 0 and (read_idx == r).sum() == 1
        np.testing.assert_array_equal(rows[i], tiles[t], err_msg=str(r))
    # the short chimeras split
    out = ts.tile_scan_plain(torch.from_numpy(rows), tp).numpy()
    assert (out[0] > 0).sum() >= 10
    # an index of every read: the same rows, inert ones for the rest
    rows_all = _feed(seqs, quals, cfg, index="all")[0]
    np.testing.assert_array_equal(rows_all[cov], rows)
    assert (rows_all[~cov, :ts.TILE // 2] == 0x55).all()
    assert (rows_all[~cov, ts.TILE // 2:] == 0).all()
    # the inert rows scan to n = 0
    out = ts.tile_scan_plain(torch.from_numpy(rows_all[~cov]), tp).numpy()
    assert (out[0] == 0).all()


def test_feed_wrapper_checks_and_counts():
    tp = ts.tile_params(TorchConfig())
    codes = torch.full((3, 2 * eg.E), 5, dtype=torch.int8)
    lens = torch.tensor([0, 400, 700], dtype=torch.int32)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    before = ts.tile_feed_plain.launches
    rows = ts.tile_feed(codes, lens, idx, tp)
    assert ts.tile_feed_plain.launches == before + 1
    assert rows.shape == (2, ts.ROW_BYTES) and rows.dtype == torch.uint8
    # a covered read of all-PAD codes (NUL bytes) reads as N; read 0 is
    # not covered: an inert row
    assert (rows[0, :200] == 0x44).all() and (rows[0, 200:512] == 0x55).all()
    assert (rows[1, :512] == 0x55).all() and (rows[1, 512:] == 0).all()
    assert ts.tile_feed(codes, lens, idx[:0], tp).shape == (0, ts.ROW_BYTES)
    with pytest.raises(ValueError, match="2E"):
        ts.tile_feed(codes[:, :eg.E], lens, idx, tp)
    with pytest.raises(ValueError, match="idx"):
        ts.tile_feed(codes, lens, idx[None], tp)


def _composite_kernel_standin(cfg, interpret=False):
    """`make_tile_scan_kernel`'s documented contract: its [3, T] rows are
    those of the jnp inner on the same tiles. Unpacks the 2-bit text-major
    rows (tile code j at bits 2 (j % 4) of row j // 4) into nibble rows."""
    inner = j_readscan._make_internal_tile_inner(cfg)
    peq = jnp.asarray(j_editdist.build_peq(
        j_dna.encode(cfg.adapter3p.sequence_complete)[None, :]))

    def fn(rows_tm):
        S = rows_tm.shape[1]
        b = rows_tm[:ts.TILE // 4].astype(jnp.int32)
        codes = jnp.stack([(b >> (2 * i)) & 3 for i in range(4)],
                          axis=1).reshape(ts.TILE, S)
        nib = ((codes[0::2] << 4) | codes[1::2]).T.astype(jnp.uint8)
        return inner(jnp.concatenate([nib, rows_tm[ts.TILE // 4:].T], 1),
                     peq)

    return fn


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_feed_scan_equals_jax_composite(monkeypatch, chem):
    """The port's feed + plain tile scan [3, B] against the JAX
    make_composite_tile_fn on encode_composite_tm's rows of the same clean
    reads (lengths around min_len and 2E, chimeras of at most 2E bases,
    long reads): equal in every read, covered or not."""
    monkeypatch.setattr(tilescan_tpu, "make_tile_scan_kernel",
                        _composite_kernel_standin)
    rng = np.random.default_rng(12 if chem == "3p" else 13)
    wl = synth.make_whitelist(rng, 16)
    make = synth.make_read_5p if chem == "5p" else synth.make_read
    seqs = [synth.random_seq(rng, L).encode()
            for L in (300, 315, 316, 500, 607, 608, 609, 900)]
    for i in range(48):
        seqs.append(make(rng, wl[i % 16], cdna_len=int(rng.integers(150, 500)),
                         error_rate=0.04, reverse=bool(i % 2))["seq"])
    for i in range(16):
        a = make(rng, wl[i], cdna_len=int(rng.integers(150, 200)),
                 error_rate=0.03)["seq"]
        b = make(rng, wl[(i + 3) % 16], cdna_len=int(rng.integers(150, 200)),
                 error_rate=0.03)["seq"]
        seqs.append(a + b)
    quals = [b"I" * len(s) for s in seqs]
    cfg = PipelineConfig()
    tcfg = TorchConfig()
    cfg.chemistry = tcfg.chemistry = chem
    packed_tm, _, _, dirty, _ = j_eg.encode_composite_tm(seqs, quals)
    assert not dirty.any()
    ref = np.asarray(tilescan_tpu.make_composite_tile_fn(cfg)(
        jnp.asarray(packed_tm))).astype(np.int32)
    got, lens, tp = _tiles3(seqs, quals, tcfg)
    np.testing.assert_array_equal(got, ref)
    if chem == "3p":     # 5p reads end to end make no 3p junction
        assert (got[0][ts.feed_covered(lens, tp)] > 0).sum() >= 8


def test_fused_mask_and_merge_equal_jax(edge_reads):
    """tiles_fused_mask and finish_tiles_merged against the JAX methods on
    the same tiles3 and their own residue scans (the host tiles of the long
    reads)."""
    rng = np.random.default_rng(5)
    wl = synth.make_whitelist(rng, 16)
    seqs, quals = map(list, edge_reads)
    for i in range(6):        # residue: long reads and long chimeras
        r = synth.make_chimera(rng, wl[i], wl[i + 1],
                               cdna_len=int(rng.integers(600, 1600)))
        seqs.append(r["seq"])
        quals.append(r["qual"])
    port = readscan.ReadScanModel(TorchConfig(), device="cpu")
    ref = j_readscan.ReadScanModel(PipelineConfig())
    tiles3, lens, tp = _tiles3(seqs, quals)
    dirty = np.zeros(len(seqs), bool)
    dirty[::7] = True
    for d in (np.zeros(len(seqs), bool), dirty):
        cov, need = port.tiles_fused_mask(lens, d)
        rcov, rneed = ref.tiles_fused_mask(lens, d)
        np.testing.assert_array_equal(cov, rcov)
        np.testing.assert_array_equal(need, rneed)
    cov, need = port.tiles_fused_mask(lens, np.zeros(len(seqs), bool))
    need_idx = np.nonzero(need)[0]
    sub = [seqs[i] for i in need_idx]
    got = port.finish_tiles_merged(tiles3, cov,
                                   port.internal_tiles_async(sub), need_idx)
    want = ref.finish_tiles_merged(tiles3, cov,
                                   ref.internal_tiles_async(sub), need_idx)
    assert got == want
    assert len(got[0]) >= 14 and any(r in need_idx for r in got[0])
    # no residue: the covered reads alone
    assert port.finish_tiles_merged(tiles3, cov, None, need_idx[:0]) == \
        ref.finish_tiles_merged(tiles3, cov, None, need_idx[:0])
    # the host route gives the same splits for the covered reads
    host = port.finish_internal_tiles(port.internal_tiles_async(seqs))
    assert {r: v for r, v in host[0].items() if cov[r]} == \
        {r: v for r, v in got[0].items() if cov[r]}


@pytest.fixture(scope="module")
def short_chimera_dir(tmp_path_factory):
    """Two files of 3p reads, 3-in-4 of them within the feed's range, with
    chimeras of 470-600 bases (covered) and of 1-2 kb (residue), long
    reads, garbage and a too-short read."""
    rng = np.random.default_rng(31)
    d = tmp_path_factory.mktemp("fused")
    wl = synth.make_whitelist(rng, 128)
    cells = wl[:12]
    for fi in range(2):
        recs = []
        for i in range(140):
            c = cells[int(rng.integers(0, 12))]
            if i % 10 == 3:
                r = synth.make_chimera(rng, c, cells[(i + 1) % 12],
                                       cdna_len=int(rng.integers(150, 200)),
                                       error_rate=0.03)
            elif i % 20 == 7:
                r = synth.make_chimera(rng, c, cells[(i + 2) % 12],
                                       cdna_len=int(rng.integers(500, 900)),
                                       error_rate=0.03)
            else:
                r = synth.make_read(rng, c, cdna_len=int(
                    rng.integers(1500, 3000) if i % 17 == 0
                    else rng.integers(150, 520)),
                    error_rate=0.05, reverse=bool(rng.random() < 0.5))
            recs.append((f"f{fi}r{i}".encode(), r["seq"], r["qual"]))
        for i in range(8):
            s = synth.random_seq(rng, int(rng.integers(300, 650))).encode()
            recs.append((f"f{fi}g{i}".encode(), s, b"I" * len(s)))
        recs.append((f"f{fi}short".encode(), b"ACGT" * 10, b"I" * 40))
        _write_fastq(d / f"reads{fi}.fastq.gz", recs)
    return d, wl


def _fused_run(cfg, wl, d, out, **kw):
    """The port's cached pipeline on the CPU with the fused route forced;
    returns (stats, the feed's and the tile scan's plain launches)."""
    pipe = ScanFastqPipeline(cfg, whitelist=wl, device="cpu", **kw)
    assert pipe.model._p1f_tiles is False       # the CPU's own route
    pipe.model._p1f_tiles = True
    f0, t0 = ts.tile_feed_plain.launches, ts.tile_scan_plain.launches
    stats = pipe.run([d], out)
    return (stats, ts.tile_feed_plain.launches - f0,
            ts.tile_scan_plain.launches - t0)


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_fused_route_pipeline_byte_identical(short_chimera_dir, run5p_dir,
                                             tmp_path, chem):
    """The cached pipeline with the fused route forced writes every file
    byte-identical to the JAX cached pipeline (its host route on the CPU)
    and to the port's own host route."""
    if chem == "3p":
        d, wl = short_chimera_dir
        cfg, tcfg = PipelineConfig(), TorchConfig()
    else:
        d, wl, _ = run5p_dir
        cfg, tcfg = _cfg5p()
    kw = dict(user_max_ed=2, chunk_size=100, cache_pass1=True)
    ref_stats = JaxPipeline(cfg, whitelist=wl, **kw).run([d],
                                                         tmp_path / "jax")
    stats, feeds, scans = _fused_run(tcfg, wl, d, tmp_path / "fused", **kw)
    host = ScanFastqPipeline(tcfg, whitelist=wl, device="cpu", **kw).run(
        [d], tmp_path / "host")
    assert _same_outputs(tmp_path / "jax", tmp_path / "fused", chem)
    assert _same_outputs(tmp_path / "host", tmp_path / "fused", chem)
    assert stats.to_json() == ref_stats.to_json() == host.to_json()
    assert feeds == 4 and scans >= 4          # 2 files of 2 chunks
    if chem == "3p":
        assert stats.split_chimeric >= 20


def test_fused_route_reads_with_n(n_dir, tmp_path):
    """Reads with N: the port's fused route covers them on the card (the
    JAX package sends them to the host tiles as dirty); the files equal
    the JAX streaming run's (its cached mode cannot take them under
    numpy 2)."""
    d, wl, _ = n_dir
    JaxPipeline(PipelineConfig(), whitelist=wl, chunk_size=64, user_max_ed=2,
                cache_pass1=False).run([d], tmp_path / "jax")
    stats, feeds, _ = _fused_run(TorchConfig(), wl, d, tmp_path / "fused",
                                 chunk_size=64, user_max_ed=2,
                                 cache_pass1=True)
    assert _same_outputs(tmp_path / "jax", tmp_path / "fused", "N reads")
    assert feeds == 3 and stats.split_chimeric >= 1


@pytest.mark.parametrize("device,mesh,fused", [
    ("cpu", None, False), ("cpu", ["cpu", "cpu"], False),
    ("cuda", None, True), ("cuda:1", None, True),
    ("cuda", ["cuda:0", "cuda:1"], False)])
def test_route_rule(device, mesh, fused):
    """Fused on a CUDA device without a mesh, as the JAX package's
    `on_tpu and self.mesh is None`; the host route on the CPU and with a
    mesh. (A CUDA model cannot be built without a GPU: the rule is a
    function of the device and the mesh.)"""
    assert readscan.fused_tiles_route(torch.device(device), mesh) is fused


def test_model_takes_the_route_rule():
    m = readscan.ReadScanModel(TorchConfig(), device="cpu")
    assert m._p1f_tiles is False
    rng = np.random.default_rng(2)
    seqs = [synth.random_seq(rng, 500).encode() for _ in range(4)]
    quals = [b"I" * 500] * 4
    assert m.finish_pass1_full(m.scan_pass1_full_async(seqs, quals))[2] \
        is None
    m._p1f_tiles = True
    tiles3 = m.finish_pass1_full(m.scan_pass1_full_async(seqs, quals))[2]
    assert tiles3.shape == (3, 4) and tiles3.dtype == np.int32


def test_chunk_without_covered_reads():
    """A chunk whose reads all lie outside the feed's range (too short or
    over 2E): the fused pass 1 feeds and scans nothing (neither body runs;
    on the card neither kernel launches), every read reports n = 0, and
    the merge takes the residue's host tiles alone, as the host route."""
    rng = np.random.default_rng(8)
    wl = synth.make_whitelist(rng, 8)
    seqs = [synth.random_seq(rng, L).encode() for L in (0, 40, 315, 609)]
    seqs += [synth.make_chimera(rng, wl[i], wl[i + 1], cdna_len=700)["seq"]
             for i in range(4)]
    quals = [b"I" * len(s) for s in seqs]
    m = readscan.ReadScanModel(TorchConfig(), device="cpu")
    m._p1f_tiles = True
    before = (ts.tile_feed_plain.launches, ts.tile_scan_plain.launches)
    out, _, tiles3 = m.finish_pass1_full(m.scan_pass1_full_async(seqs, quals))
    assert (ts.tile_feed_plain.launches, ts.tile_scan_plain.launches) == \
        before
    assert tiles3.shape == (3, len(seqs)) and (tiles3[0] == 0).all()
    assert (tiles3[1:] == -1).all()
    cov, need = m.tiles_fused_mask(out["true_lens"], np.zeros(len(seqs), bool))
    assert not cov.any() and need[4:].all()
    need_idx = np.nonzero(need)[0]
    got = m.finish_tiles_merged(tiles3, cov, m.internal_tiles_async(
        [seqs[i] for i in need_idx]), need_idx)
    assert got == m.finish_internal_tiles(m.internal_tiles_async(seqs))
    assert len(got[0]) >= 2


def _feed_model(codes, lens, idx, p):
    """A numpy model of csrc/tilefeed.cu's row build: a covered read's
    pieces staged as they are ([0, E) and the 16-byte pieces from 3E - L),
    the rest of its staged row garbage; each output word 8 codes read as 8
    contiguous staged bytes (j or j + 2E - L: a word never straddles E),
    PAD mapped to N, cut at L, packed high nibble first; the meta words;
    inert rows for other reads."""
    E, E2, R = eg.E, 2 * eg.E, ts.ROW_BYTES
    rng = np.random.default_rng(0)
    out = np.zeros((len(idx), R), np.uint8)
    min_len = 2 * p.edge + p.k
    for i, r in enumerate(idx):
        L = int(lens[r])
        if not min_len < L <= E2:
            out[i, :ts.TILE // 2] = 0x55
            continue
        st = rng.integers(0, 256, E2 + 16).astype(np.uint8)   # garbage
        for c0 in range(0, E2, 16):
            if c0 < E or c0 + 16 > 3 * E - L:
                st[c0:c0 + 16] = codes[r, c0:c0 + 16].view(np.uint8)
        for w in range(ts.TILE // 8):
            j0 = 8 * w
            if j0 >= L:
                out[i, 4 * w:4 * w + 4] = 0x55
                continue
            off = j0 if j0 < E else j0 + E2 - L
            x = st[off:off + 8].copy()
            x[x == 5] = 4
            x[np.arange(8) >= L - j0] = 5
            out[i, 4 * w:4 * w + 4] = (x[0::2] << 4) | x[1::2]
        own_hi = max(L - p.edge - p.k + 1, 0)
        meta = np.array([p.edge | own_hi << 16, L, 0, L], np.uint32)
        out[i, ts.TILE // 2:] = meta.view(np.uint8)
    return out


@pytest.mark.parametrize("index", ["covered", "all"])
def test_feed_kernel_model_equals_plain(edge_reads, index):
    """The kernel's row build (numpy model, garbage in the pieces it does
    not stage) gives tile_feed_plain's rows, byte for byte."""
    seqs, quals = edge_reads
    tp = ts.tile_params(TorchConfig())
    codes, _, lens, _ = eg.encode_two_half(seqs, quals)
    rows, _, _, idx = _feed(seqs, quals, index=index)
    np.testing.assert_array_equal(_feed_model(codes, lens, idx, tp), rows)


@pytest.mark.parametrize("base", ["A", "T"])
def test_internal_polyat_matches_jax(base):
    rng = np.random.default_rng(9)
    B, L = 64, 260
    seqs = rng.integers(0, 6, (B, L)).astype(np.int8)
    code = j_dna.encode(base)[0]
    for b in range(B):                   # runs inside, at and off the ends
        s = int(rng.integers(0, L - 20))
        seqs[b, s:s + int(rng.integers(8, 30))] = code
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:3] = (0, 14, L)
    kw = dict(base=int(code), k=15, min_count=11, edge_exclusion=40)
    want = j_scan.internal_polyat(jnp.asarray(seqs), jnp.asarray(lens), **kw)
    got = scan.internal_polyat(torch.from_numpy(seqs),
                               torch.from_numpy(lens), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and not got[0].all()
    short = scan.internal_polyat(torch.from_numpy(seqs[:, :10]),
                                 torch.from_numpy(lens), **kw)
    jshort = j_scan.internal_polyat(jnp.asarray(seqs[:, :10]),
                                    jnp.asarray(lens), **kw)
    for g, w in zip(short, jshort):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
