"""The CUDA kernels against their plain PyTorch versions on the card (exact
equality), at small shapes. Needs a GPU and nvcc: skipped elsewhere. Run on
the card with `python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu
--noconftest` (tests/conftest.py imports jax, which a GPU host need not
have; nothing here uses jax). The edge cases of the whitelist sweep and of
the band aligner are those `chip_smoke.py` runs (its generators)."""
import numpy as np
import pytest
import torch

import chip_smoke
from sicelore_tpu_torch.models import readscan
from sicelore_tpu_torch.ops import bcsearch, editdist
from sicelore_tpu_torch.ops import edgescan as eg
from sicelore_tpu_torch.ops import poa_cuda as pc
from sicelore_tpu_torch.ops import tilescan_cuda as ts
from sicelore_tpu_torch.ops.edgescan_cuda import edge_scan2
from sicelore_tpu_torch.utils import dna, synth
from sicelore_tpu_torch.utils.config import PipelineConfig

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(4)
    wl = synth.make_whitelist(rng, 256)
    seqs = []
    for i in range(600):
        if i % 25 == 0:
            r = synth.make_chimera(rng, wl[i % 256], wl[(i + 9) % 256],
                                   cdna_len=500, error_rate=0.04)
        elif i % 25 == 1:
            r = synth.make_read(rng, wl[i % 256],
                                cdna_len=int(rng.integers(2000, 5000)),
                                error_rate=0.04, reverse=bool(i % 2))
        elif i % 25 == 2:
            r = {"seq": synth.random_seq(rng, int(rng.integers(0, 900)))
                 .encode()}
        else:
            r = synth.make_read(rng, wl[i % 256],
                                cdna_len=int(rng.integers(100, 700)),
                                error_rate=0.05, reverse=bool(i % 2))
        s = bytearray(r["seq"])
        if i % 9 == 0 and s:
            s[int(rng.integers(0, len(s)))] = ord("N")
        seqs.append(bytes(s))
    return wl, seqs


def _rows(seqs, dev):
    codes, _, lens, _ = eg.encode_two_half(seqs, [b"I" * len(x) for x in seqs])
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev),
            codes, lens)


def _params(chem, **kw):
    cfg = PipelineConfig()
    cfg.chemistry = chem
    for key, val in kw.items():
        obj, name = key.split("__")
        setattr(getattr(cfg, obj), name, val)
    return eg.edge_params(cfg)


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_edge_kernel_matches_plain(dev, reads, chem):
    """csrc/edgescan.cu on encode_two_half's rows [B, 2E] against
    edge_scan2_plain, both chemistries."""
    seqs = reads[1] if chem == "3p" else _reads_5p()
    ct, ld, _, _ = _rows(seqs, dev)
    p = _params(chem)
    before = edge_scan2.launches
    k = edge_scan2(ct, ld, p)
    pl = eg.edge_scan2_plain(ct[:, :eg.E], ct[:, eg.E:], ld, p)
    torch.cuda.synchronize()
    assert edge_scan2.launches == before + 1
    assert torch.equal(k, pl) and int(pl[eg.ROW_STRANDED].sum()) > 200


@pytest.mark.parametrize("B", [1, 37, 129, None])
@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_edge_kernel_edge_set_matches_plain(dev, chem, B):
    """chip_smoke.py's edge set (reads of length 0, under k, E, 2E and over
    2E, all-N reads, runs at win_p and at word borders, adapter windows off
    both read ends) in launches of 1, 37, 129 reads and all of them."""
    seqs, _ = chip_smoke.edge_set_reads(np.random.default_rng(3), chem)
    seqs = seqs[:B] if B else seqs
    ct, ld, codes, lens = _rows(seqs, dev)
    p = _params(chem)
    k = edge_scan2(ct, ld, p)
    torch.cuda.synchronize()
    pl = eg.edge_scan2_plain(torch.from_numpy(codes[:, :eg.E]),
                             torch.from_numpy(codes[:, eg.E:]),
                             torch.from_numpy(lens), p)
    assert torch.equal(k.cpu(), pl)


@pytest.mark.parametrize("chem,kw", [
    ("3p", {"polyat__polyat_length": 9,
            "polyat__fraction_at_in_polyat": 0.7}),
    ("5p", {"polyat__polyat_length": 16,
            "polyat__fraction_at_in_polyat": 0.5,
            "polyat__window_search_for_polya": 200}),
    ("5p", {"tso5p__min_tso_consecutive_matches": 5,
            "tso5p__min_tso_two_best_consecutive_matches": 7}),
    ("3p", {"tso3p__min_tso_consecutive_matches": 16,
            "tso3p__min_tso_two_best_consecutive_matches": 20})])
def test_edge_kernel_general_path_matches_plain(dev, chem, kw):
    """Configs off the compiled default (k, mc, c1, c2 read at run time)."""
    seqs, _ = chip_smoke.edge_set_reads(np.random.default_rng(5), chem)
    ct, ld, _, _ = _rows(seqs, dev)
    p = _params(chem, **kw)
    assert p.kernel_unsupported == ""
    k = edge_scan2(ct, ld, p)
    pl = eg.edge_scan2_plain(ct[:, :eg.E], ct[:, eg.E:], ld, p)
    torch.cuda.synchronize()
    assert torch.equal(k, pl)


def test_edge_kernel_rejects_other_inputs(dev):
    """Rows that are not contiguous, not 16-byte aligned or not int8
    raise; nothing falls back to the plain body."""
    p = _params("3p")
    buf = torch.full((4 * 2 * eg.E + 64,), dna.PAD, dtype=torch.int8,
                     device=dev)
    ld = torch.full((4,), 100, dtype=torch.int32, device=dev)
    off = (-buf.data_ptr()) % 16
    with pytest.raises(ValueError, match="16-byte"):
        edge_scan2(buf[off + 8:off + 8 + 4 * 2 * eg.E].view(4, -1), ld, p)
    wide = buf[:4 * (2 * eg.E + 16)].view(4, -1)
    with pytest.raises(ValueError, match="contiguous"):
        edge_scan2(wide[:, :2 * eg.E], ld, p)
    with pytest.raises(ValueError, match="contiguous int8"):
        edge_scan2(torch.zeros((4, 2 * eg.E), dtype=torch.int32,
                               device=dev), ld, p)


def _reads_5p(n=300):
    rng = np.random.default_rng(14)
    wl = synth.make_whitelist(rng, 64)
    seqs = []
    for i in range(n):
        if i % 25 == 2:
            s = synth.random_seq(rng, int(rng.integers(0, 900))).encode()
        else:
            s = synth.make_read_5p(
                rng, wl[i % 64], cdna_len=int(rng.integers(2000, 4000))
                if i % 25 == 1 else int(rng.integers(100, 700)),
                error_rate=0.05, reverse=bool(i % 2))["seq"]
        s = bytearray(s)
        if i % 9 == 0 and s:
            s[int(rng.integers(0, min(len(s), 200)))] = ord("N")
        seqs.append(bytes(s))
    return seqs + [b"", b"ACGT", b"N" * 80]


def test_edge_kernel_refuses_5p(dev):
    """A config outside the fused kernel's envelope (an adapter window of
    129 columns; the name dates from when 5p was outside): edge_scan2 runs
    the composed body on the card (three window searches through the
    kernel) and its rows equal edge_scan2_plain's on CPU tensors."""
    p = _params("5p", adapter5p__adapter_search_window=129)
    assert p.kernel_unsupported == "adapter window"
    seqs = _reads_5p()
    ct, ld, codes, lens = _rows(seqs, dev)
    before = (edge_scan2.launches, eg.edge_scan2_composed.launches,
              editdist.myers_win1.launches,
              editdist.myers_win1_plain.launches)
    k = edge_scan2(ct, ld, p)
    torch.cuda.synchronize()
    assert (edge_scan2.launches, eg.edge_scan2_composed.launches,
            editdist.myers_win1.launches,
            editdist.myers_win1_plain.launches) == (
        before[0], before[1] + 1, before[2] + 3, before[3])
    pl = eg.edge_scan2_plain(torch.from_numpy(codes[:, :eg.E]),
                             torch.from_numpy(codes[:, eg.E:]),
                             torch.from_numpy(lens), p)
    assert torch.equal(k.cpu(), pl)
    assert int(pl[eg.ROW_STRANDED].sum()) > 200


def test_edge_5p_launches_the_fused_kernel_only(dev):
    """5p reads take the fused kernel once a call: no window search, no
    composed body, no plain body."""
    ct, ld, _, _ = _rows(_reads_5p(), dev)
    counters = (edge_scan2, eg.edge_scan2_composed, eg.edge_scan2_plain,
                editdist.myers_win1, editdist.myers_win1_plain)
    before = [c.launches for c in counters]
    edge_scan2(ct, ld, _params("5p"))
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [1, 0, 0, 0, 0]


@pytest.mark.parametrize("B,W,m", [(1, 110, 22), (37, 110, 22), (300, 1, 5),
                                   (129, 64, 32), (1000, 160, 31),
                                   (4097, 65, 19), (0, 30, 8)])
def test_win1_kernel_matches_plain(dev, B, W, m):
    """csrc/win1.cu against myers_win1_plain: codes 0..5, planted matches,
    PAD tails, an all-PAD row (m, -1); B not a multiple of the block, W
    across the staging width, m = 32."""
    rng = np.random.default_rng(B + W)
    pat = rng.integers(0, 4, m).astype(np.int8)
    wins = rng.integers(0, 6, (B, W)).astype(np.int8)
    for i in range(0, B, 3):
        if W >= m:
            off = int(rng.integers(0, W - m + 1))
            wins[i, off:off + m] = pat
    wins[::7, -(W // 3 + 1):] = dna.PAD
    if B:
        wins[B // 2] = dna.PAD
    peq = editdist.build_peq(pat[None, :])
    before = editdist.myers_win1.launches
    ed, pos = editdist.myers_win1(torch.from_numpy(wins).to(dev), peq, m)
    torch.cuda.synchronize()
    assert editdist.myers_win1.launches == before + (B > 0)
    ed_p, pos_p = editdist.myers_win1_plain(torch.from_numpy(wins), peq, m)
    assert ed.dtype == torch.int32 and pos.dtype == torch.int32
    assert torch.equal(ed.cpu(), ed_p) and torch.equal(pos.cpu(), pos_p)
    if B:
        assert (int(ed[B // 2]), int(pos[B // 2])) == (m, -1)


def test_win1_kernel_rejects_other_inputs(dev):
    peq = editdist.build_peq(np.zeros((1, 8), np.int8))
    w = torch.zeros((8, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous int8"):
        editdist.myers_win1(w.to(torch.int32), peq, 8)
    with pytest.raises(ValueError, match="contiguous int8"):
        editdist.myers_win1(w.t(), peq, 8)


def test_plain_oracles_never_reach_the_kernel_on_the_card(dev, reads):
    """edge_scan2_plain and tile_scan_plain on CUDA tensors search through
    the plain sweep: the window-search kernel's count stays put."""
    _, seqs = reads
    cfg = PipelineConfig()
    codes, _, lens, _ = eg.encode_two_half(seqs, [b"I" * len(s) for s in seqs])
    ct = torch.from_numpy(codes).to(dev)
    rows, _, _ = readscan.build_tiles(seqs, cfg)
    before = (editdist.myers_win1.launches,
              editdist.myers_win1_plain.launches)
    for chem in ("3p", "5p"):
        c = PipelineConfig()
        c.chemistry = chem
        eg.edge_scan2_plain(ct[:, :eg.E], ct[:, eg.E:],
                            torch.from_numpy(lens).to(dev), eg.edge_params(c))
    ts.tile_scan_plain(torch.tensor(rows, device=dev), ts.tile_params(cfg))
    torch.cuda.synchronize()
    assert (editdist.myers_win1.launches,
            editdist.myers_win1_plain.launches) == before


@pytest.mark.parametrize("chem", ["3p", "5p"])
def test_v1_scans_cuda_match_cpu(dev, reads, chem):
    """scan_reads and scan_internal on the card (window searches through
    the kernel) against the same model on the CPU."""
    cfg = PipelineConfig()
    cfg.chemistry = chem
    seqs = _reads_5p(200) if chem == "5p" else reads[1][:200]
    quals = [bytes(33 + (i + j) % 40 for j in range(len(s)))
             for i, s in enumerate(seqs)]
    gpu = readscan.ReadScanModel(cfg, device="cuda")
    cpu = readscan.ReadScanModel(cfg, device="cpu")
    before = editdist.myers_win1.launches
    got, ref = gpu.scan_reads(seqs, quals), cpu.scan_reads(seqs, quals)
    assert editdist.myers_win1.launches == before + 3
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    codes, lens = dna.encode_batch(seqs, 5120)
    got, ref = gpu.scan_internal(codes, lens), cpu.scan_internal(codes, lens)
    assert editdist.myers_win1.launches == before + 5
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_prefilter_cuda_matches_cpu(dev, reads):
    wl, seqs = reads
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    res = {}
    for d in ("cuda", "cpu"):
        model = readscan.ReadScanModel(PipelineConfig(), device=d)
        model.prepare_search(pats, len(wl), radius=2, mode="prefilter", K=16)
        res[d] = model.finish_search(model.scan_search_async(
            seqs, [b"I" * len(s) for s in seqs]))[1]
    for k in ("ed", "idx", "ed2"):
        np.testing.assert_array_equal(res["cuda"][k], res["cpu"][k])
    assert (res["cpu"]["ed"] <= 2).sum() > 300


@pytest.mark.parametrize("nvalid,track_pos", [(256, True), (200, False),
                                              (1, True)])
def test_sweep_kernel_matches_plain(dev, reads, nvalid, track_pos):
    wl, seqs = reads
    codes, _, lens, _ = eg.encode_two_half(seqs, [b"I" * len(s) for s in seqs])
    meta = eg.edge_scan2_plain(torch.from_numpy(codes[:, :eg.E]),
                               torch.from_numpy(codes[:, eg.E:]),
                               torch.from_numpy(lens),
                               eg.edge_params(PipelineConfig()))
    wins = meta[eg.ROW_BC0:].to(torch.uint8).contiguous().to(dev)
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    peq = bcsearch.peq_device(editdist.build_peq(pats), dev)
    k = bcsearch.bc_sweep(wins, peq, nvalid, 16, track_pos)
    pl = bcsearch.bc_sweep_plain(wins, peq, nvalid, 16, track_pos)
    torch.cuda.synchronize()
    assert torch.equal(k, pl)


@pytest.mark.parametrize("track_pos", [True, False])
@pytest.mark.parametrize("name", sorted(chip_smoke.SWEEP_EDGE_CASES))
def test_sweep_kernel_slices_match_plain(dev, name, track_pos):
    """csrc/bcsweep.cu over a reads x slices grid against bc_sweep_plain on
    the whole list: the cases the slices make possible to get wrong."""
    wins, peq, nvalid, m, slices, ties = chip_smoke.sweep_edge_case(name,
                                                                     "cpu")
    before = bcsearch.bc_sweep.launches
    k = bcsearch._bc_sweep_sliced(wins.to(dev), peq.to(dev), nvalid, m,
                                  track_pos, slices)
    torch.cuda.synchronize()
    assert bcsearch.bc_sweep.launches == before + 1
    pl = bcsearch.bc_sweep_plain(wins, peq, nvalid, m, track_pos)
    assert k.dtype == torch.int32 and torch.equal(k.cpu(), pl)
    if ties:
        assert int((pl[0] == pl[2]).sum()) > 0          # ties: b2 == b1
    if nvalid == 0:
        assert (pl[0] == bcsearch.BIG).all() and (pl[1] == 0).all()


def test_sweep_merge_kernel_matches_plain(dev):
    """The merge kernel alone on crafted partials: ties between slices, a
    slice of masked barcodes only in first, middle and last place, every
    slice masked (the first slice's index 0 survives)."""
    t = chip_smoke.merge_edge_partials("cpu")
    got = bcsearch.merge_sweep_partials(t.to(dev))
    torch.cuda.synchronize()
    ref = bcsearch.merge_sweep_partials_plain(t)
    assert torch.equal(got.cpu(), ref)
    assert (ref[1, 900:] == 0).all() and (ref[0, 900:] == bcsearch.BIG).all()
    assert torch.equal(bcsearch.merge_sweep_partials(t[:1].to(dev)).cpu(),
                       t[0])


def test_tile_kernel_matches_plain(dev, reads):
    _, seqs = reads
    cfg = PipelineConfig()
    rows, _, _ = readscan.build_tiles(seqs, cfg)
    rd = torch.tensor(rows, device=dev)
    k = ts.tile_scan(rd, ts.tile_params(cfg))
    pl = ts.tile_scan_plain(rd, ts.tile_params(cfg))
    torch.cuda.synchronize()
    assert torch.equal(k, pl) and int((k[0] > 0).sum()) > 0


@pytest.mark.parametrize("T", [1, 33, 129])
def test_tile_kernel_edge_rows_match_plain(dev, T):
    """csrc/tilescan.cu on chip_smoke.py's edge tiles (0, 1, 3 and 5 runs a
    direction, sites at own_lo, own_hi - 1 and tlen - k, confirm windows
    off both ends, an all-PAD tile), one partial block and ragged ones."""
    rows = torch.from_numpy(chip_smoke.tile_edge_rows(129)[:T])
    p = ts.tile_params(PipelineConfig())
    before = ts.tile_scan.launches
    k = ts.tile_scan(rows.to(dev), p)
    torch.cuda.synchronize()
    assert ts.tile_scan.launches == before + 1
    pl = ts.tile_scan_plain(rows, p)
    assert k.dtype == torch.int32 and torch.equal(k.cpu(), pl)


@pytest.mark.parametrize("k,frac", [(9, 0.7), (16, 0.7), (31, 0.5),
                                    (15, 0.6)])
def test_tile_kernel_other_windows_match_plain(dev, k, frac):
    """Window lengths and thresholds other than the default (k = 15,
    mc = 11, compiled into the kernel): the kernel's general path."""
    cfg = PipelineConfig()
    cfg.polyat.internal_pat_length = k
    cfg.polyat.internal_fraction_at_in_polyat = frac
    p = ts.tile_params(cfg)
    rows = torch.from_numpy(chip_smoke.tile_edge_rows(129))
    got = ts.tile_scan(rows.to(dev), p)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ts.tile_scan_plain(rows, p))


def test_tile_kernel_rejects_other_inputs(dev):
    p = ts.tile_params(PipelineConfig())
    rows = torch.zeros((4, ts.ROW_BYTES + 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        ts.tile_scan(rows.view(-1)[1:1 + 3 * ts.ROW_BYTES].view(3, -1), p)
    with pytest.raises(ValueError, match="contiguous"):
        ts.tile_scan(rows[:, :ts.ROW_BYTES], p)


@pytest.mark.parametrize("index", ["covered", "all"])
@pytest.mark.parametrize("n", [1, 33, None])
def test_tile_feed_kernel_matches_plain(dev, reads, n, index):
    """csrc/tilefeed.cu against tile_feed_plain, byte for byte, on the
    reads fixture and chip_smoke.py's feed edge set (lengths around E,
    min_len and 2E, N, lowercase, NUL and other bytes, short chimeras), in
    launches of 1, 33 and all reads, fed the covered reads' index (the
    fused route's) and every read's (inert rows too); an empty index
    launches nothing."""
    _, seqs = reads
    es, _ = chip_smoke.feed_edge_reads(np.random.default_rng(3))
    seqs = (seqs + es)[:n]
    codes, lens, _, _ = _rows(seqs, dev)
    p = ts.tile_params(PipelineConfig())
    idx = chip_smoke.covered_index(lens.cpu().numpy(), p, dev) \
        if index == "covered" else \
        torch.arange(len(seqs), dtype=torch.int32, device=dev)
    before = ts.tile_feed.launches
    got = ts.tile_feed(codes, lens, idx, p)
    torch.cuda.synchronize()
    assert ts.tile_feed.launches == before + (len(idx) > 0)
    want = ts.tile_feed_plain(codes.cpu(), lens.cpu(), idx.cpu(), p)
    assert got.dtype == torch.uint8 and got.shape == (len(idx), ts.ROW_BYTES)
    assert torch.equal(got.cpu(), want)


def test_tile_feed_kernel_rejects_other_inputs(dev):
    p = ts.tile_params(PipelineConfig())
    codes = torch.zeros((4 * 2 * eg.E + 16,), dtype=torch.int8, device=dev)
    lens = torch.zeros(3, dtype=torch.int32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        ts.tile_feed(codes[1:1 + 3 * 2 * eg.E].view(3, -1), lens, idx, p)
    with pytest.raises(ValueError, match="lens"):
        ts.tile_feed(codes[:3 * 2 * eg.E].view(3, -1), lens.long(), idx, p)
    with pytest.raises(ValueError, match="idx"):
        ts.tile_feed(codes[:3 * 2 * eg.E].view(3, -1), lens, idx.long(), p)


def test_fused_splits_equal_host_splits(dev, reads):
    """On the card the cached pass 1 takes the fused route: its merged
    splits (the feed's covered reads + the host tiles of the residue)
    equal the host route's over all tiles."""
    wl, seqs = reads
    seqs = seqs + [synth.make_chimera(
        np.random.default_rng(i), wl[i], wl[i + 1], cdna_len=170,
        error_rate=0.03)["seq"] for i in range(16)]
    quals = [b"I" * len(s) for s in seqs]
    m = readscan.ReadScanModel(PipelineConfig(), device=dev)
    assert m._p1f_tiles
    before = (ts.tile_feed.launches, ts.tile_scan.launches)
    out, _, tiles3 = m.finish_pass1_full(m.scan_pass1_full_async(seqs, quals))
    assert (ts.tile_feed.launches, ts.tile_scan.launches) == \
        (before[0] + 1, before[1] + 1)
    covered, need = m.tiles_fused_mask(out["true_lens"],
                                       np.zeros(len(seqs), bool))
    need_idx = np.nonzero(need)[0]
    got = m.finish_tiles_merged(
        tiles3, covered,
        m.internal_tiles_async([seqs[i] for i in need_idx]), need_idx)
    want = m.finish_internal_tiles(m.internal_tiles_async(seqs))
    assert got == want
    assert sum(bool(covered[r]) for r in got[0]) >= 10


@pytest.mark.parametrize("B,W,m,off", chip_smoke.WIN1_EDGE_SHAPES)
def test_win1_kernel_unaligned_spans_match_plain(dev, B, W, m, off):
    """csrc/win1.cu on rows whose data starts `off` bytes past a 16-byte
    boundary (block spans at every start modulo 16), B = 1 / 37 / 129 / 300,
    W = 1 / 90 / 110 / 160 / 200 (rounds)."""
    wins, pat = chip_smoke.win1_edge_windows(B, W, m, off)
    peq = editdist.build_peq(pat[None, :])
    x = chip_smoke.unaligned_rows(wins, off, dev)
    assert x.data_ptr() % 16 == off
    ed, pos = editdist.myers_win1(x, peq, m)
    torch.cuda.synchronize()
    ed_p, pos_p = editdist.myers_win1_plain(torch.from_numpy(wins), peq, m)
    assert torch.equal(ed.cpu(), ed_p) and torch.equal(pos.cpu(), pos_p)
    assert (int(ed[B // 2]), int(pos[B // 2])) == (m, -1)


def _pairs(seed, n_mol, length, rate, Lc, W, dev):
    """Pair tensors on the card: noisy molecules plus an infeasible pair,
    insertion runs past K_INS, a read with N and an empty read."""
    rng = np.random.default_rng(seed)
    mols, _ = synth.molecule_set(rng, n_mol, 5, rate, length)
    truth = synth.random_seq(rng, length)
    ins = truth[:60] + synth.random_seq(rng, 9) + truth[60:]
    mols.append([ins.encode(), truth.encode(), truth[:length - 40].encode(),
                 (truth[:90] + "N" + truth[91:]).encode(), b"",
                 synth.mutate(rng, truth, rate).encode()])
    center, clens, reads, rlens, mids = synth.pair_arrays(mols, Lc, W)
    first = np.searchsorted(mids, np.arange(len(mols)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(reads), t(rlens), t(mids), t(center[first]), t(clens[first]),
            Lc, W)


@pytest.mark.parametrize("length,Lc,W", [
    (230, 256, 32), (256, 256, 32), (500, 512, 32), (500, 512, 64),
    (900, 1024, 64), (2000, 2048, 64)])
def test_band_kernel_matches_plain(dev, length, Lc, W):
    args = _pairs(length, 6, length - 12, 0.06, Lc, W, dev)
    before = pc.band_align.launches
    k = pc.band_align(*args)
    assert pc.band_align.launches == before + 1
    pl = pc.band_align_plain(*args)
    torch.cuda.synchronize()
    for a, b, what in zip(k, pl, ("aligned", "ins", "feasible")):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), (what, int((a != b).sum()))
    assert int(k[2].sum()) >= k[2].numel() - 3 and int(k[1].max()) >= 1


@pytest.mark.parametrize("n_pairs,length,Lc,W", [
    (5, 200, 256, 32), (3, 480, 512, 64), (1001, 110, 128, 32),
    *chip_smoke.BAND_EDGE_SHAPES])
def test_band_kernel_pair_groups_match_plain(dev, n_pairs, length, Lc, W):
    """Four (W = 32) or two (W = 64) pairs a warp with P not a multiple of
    the pairs a warp or a block holds, on pairs that run out of the band,
    hug its edge, are empty or have a center of length 0."""
    args = chip_smoke.band_edge_pairs(np.random.default_rng(n_pairs + Lc),
                                      n_pairs, length, Lc, W, dev)
    before = pc.band_align.launches
    k = pc.band_align(*args, Lc, W)
    torch.cuda.synchronize()
    assert pc.band_align.launches == before + 1
    pl = pc.band_align_plain(*args, Lc, W)
    for a, b, what in zip(k, pl, ("aligned", "ins", "feasible")):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), (what, int((a != b).sum()))
    if n_pairs > 30:
        assert 0 < int(k[2].sum()) < n_pairs      # feasible and not


def test_band_kernel_refuses_other_bands(dev):
    args = _pairs(1, 2, 200, 0.05, 256, 48, dev)
    with pytest.raises(NotImplementedError, match="W in"):
        pc.band_align(*args)


def test_consensus_engine_cuda_matches_cpu(dev):
    rng = np.random.default_rng(77)
    mols = []
    for L in (180, 300, 450, 700, 1100):
        m, _ = synth.molecule_set(rng, 3, 5, 0.05, L)
        mols += m
    mols.append([b"ACGTACGTAA"])
    got = pc.BatchedConsensusEngine(device="cuda")(mols, refine=True)
    ref = pc.BatchedConsensusEngine(device="cpu")(mols, refine=True)
    assert got == ref


@pytest.mark.parametrize("Lc", [64, 128, 256])
def test_band_kernel_gap_shapes_match_plain(dev, Lc):
    """The aligner's gap buckets (W = 32): pairs as GapBatcher builds them
    (each its own molecule), with infeasible and empty ones. The pairs the
    N screen lets through hold ACGT only, and the kernel's feasible agrees
    with the plain version's on every pair."""
    from sicelore_tpu_torch.align import extend

    pairs = chip_smoke.gap_pairs(np.random.default_rng(Lc), Lc, 300)
    pairs.append((b"ACGTNACGTA" * 4, b"ACGTACGTA" * 4))
    gb = extend.GapBatcher(dev)
    screened = [gb.feasible(R, Q) for R, Q in pairs]
    assert not screened[-1] and 250 < sum(screened) < len(pairs)
    assert all(not (R + Q).translate(None, b"ACGT")
               for (R, Q), ok in zip(pairs, screened) if ok)
    W = pc.w_for(Lc)
    reads, rlens, cent, clens = gb._build_bucket(pairs, Lc, W)
    mids = torch.arange(len(pairs), dtype=torch.int32, device=dev)
    before = pc.band_align.launches
    k = pc.band_align(reads, rlens, mids, cent, clens, Lc, W)
    assert pc.band_align.launches == before + 1
    pl = pc.band_align_plain(reads, rlens, mids, cent, clens, Lc, W)
    for a, b, what in zip(k, pl, ("aligned", "ins", "feasible")):
        assert torch.equal(a, b), (what, int((a != b).sum()))
    feas = k[2].cpu().numpy()
    assert all(feas[i] for i, ok in enumerate(screened) if ok)


def test_gap_batcher_cuda_matches_cpu(dev):
    from sicelore_tpu_torch.align import extend

    rng = np.random.default_rng(5)
    got = {}
    for d in ("cuda", "cpu"):
        gb = extend.GapBatcher(d, pairs_per_call=97 if d == "cuda" else None)
        for Lc, n in ((64, 400), (128, 60), (256, 20), (1024, 5)):
            for R, Q in chip_smoke.gap_pairs(np.random.default_rng(Lc), Lc,
                                             n):
                if gb.feasible(R, Q):
                    gb.add(R, Q)
        gb.run()
        got[d] = gb.results
    assert sorted(got["cuda"]) == sorted(got["cpu"])
    for Lc in got["cpu"]:
        for a, b in zip(got["cuda"][Lc], got["cpu"][Lc]):
            np.testing.assert_array_equal(a, b)


def test_aligner_cuda_matches_cpu(dev):
    from sicelore_tpu_torch.align import NativeAligner

    rng = np.random.default_rng(100)
    g = {"chrT": synth.random_seq(rng, 120_000).encode(),
         "chrU": synth.random_seq(rng, 40_000).encode()}
    names, reads = [], []
    for i in range(40):
        src = g["chrT"] if i % 3 else g["chrU"]
        pos = int(rng.integers(1_000, len(src) - 1_500))
        r = synth.mutate(rng, src[pos:pos + int(rng.integers(300, 1_300))]
                         .decode(), 0.06).encode()
        names.append(b"n%d" % i)
        reads.append(dna.revcomp_bytes(r) if i % 2 else r)
    before = pc.band_align.launches
    got = NativeAligner(g, device="cuda").align_batch(names, reads)
    assert pc.band_align.launches > before
    ref = NativeAligner(g, device="cpu").align_batch(names, reads)
    for a, b in zip(got, ref):
        for f in ("qname", "flag", "ref_id", "pos", "mapq", "cigar", "seq",
                  "qual", "tags"):
            assert getattr(a, f) == getattr(b, f), (a.qname, f)


def test_pairwise_ed_cuda_matches_cpu(dev):
    from sicelore_tpu_torch.core import umicluster

    rng = np.random.default_rng(6)
    umis = list(dict.fromkeys(
        [dna.decode(rng.integers(0, 4, int(rng.integers(10, 17)))).encode()
         for _ in range(200)]
        + [b"", b"ACGTN" * 7, b"ACGTN" * 6, b"AAAANCCCCGGGG"]))
    before = (editdist.myers_global_group.launches,
              editdist.myers_global_pairwise.launches,
              editdist.myers_global_group_plain.launches)
    got = umicluster.pairwise_ed(umis, device="cuda")
    # one kernel launch for the group, every length class in it; no plain
    assert (editdist.myers_global_group.launches,
            editdist.myers_global_pairwise.launches,
            editdist.myers_global_group_plain.launches) == \
        (before[0] + 1, before[1], before[2])
    np.testing.assert_array_equal(got,
                                  umicluster.pairwise_ed(umis, device="cpu"))
    quals = [float(x) for x in rng.integers(20, 24, len(umis))]
    a = umicluster.cluster_group(umis, quals, device="cuda")
    b = umicluster.cluster_group(umis, quals, device="cpu")
    assert [(c.center, c.members) for c in a] == \
        [(c.center, c.members) for c in b]


def _group_vs_plain(umis, dev):
    args = editdist.group_inputs(umis, dev)
    before = editdist.myers_global_group.launches
    got = editdist.myers_global_group(*args)
    torch.cuda.synchronize()
    assert editdist.myers_global_group.launches == before + (len(umis) > 0)
    want = editdist.myers_global_group_plain(*args)
    assert got.dtype == torch.int32 and got.shape == (len(umis),) * 2
    assert torch.equal(got, want)
    ml = np.fromiter(map(len, umis), np.int32, len(umis))
    assert (got.cpu().numpy()[(ml == 0) | (ml > 32)] == 0).all()


@pytest.mark.parametrize("group", ["g288", "mixed", "g3000", "g8192",
                                   "bytes256"])
def test_pairwise_kernel_matches_plain(dev, group):
    """csrc/pairwise.cu against myers_global_group_plain (on the card),
    element for element, on chip_smoke.py's groups: 256 UMIs of 12 nt and
    32 of 16 nt, mixed lengths with N, an empty and 33-nt UMIs (their rows
    0), 3,000 UMIs of 10-14 nt, 8,192 of 12 nt with indels, and a group
    holding every byte value (each mapped as dna._ENC)."""
    _group_vs_plain(chip_smoke.umi_groups()[group], dev)


@pytest.mark.parametrize("n", [1, 37, 163, 1537])
def test_pairwise_kernel_partial_tiles(dev, n):
    """Launches whose last row and text tiles end inside a warp, on UMIs
    of 1-32 nt with N, lowercase and empty ones, and the same with texts
    of 40-90 nt (a tile too long for the staging buffer reads global
    memory); 1,537 UMIs fill an H100 at 4 rows a thread, the rest take 2."""
    rng = np.random.default_rng(n)
    umis = [bytes(rng.choice(list(b"ACGTACGTacgtN"), int(rng.integers(
        0, 33))).tolist()) for _ in range(n)]
    _group_vs_plain(umis, dev)
    long = [dna.decode(rng.integers(0, 4, int(rng.integers(40, 90))))
            .encode() for _ in range(n)]
    _group_vs_plain([u for p in zip(umis, long) for u in p], dev)


def test_pairwise_kernel_rejects_other_inputs(dev):
    umis = chip_smoke.umi_groups()["mixed"][:40]
    raw, offs, ho = editdist.group_inputs(umis, dev)
    falls = ho.copy()
    falls[3] = falls[5]
    # the same bytes one past a 16-byte boundary
    shifted = editdist.group_inputs([b"G" + umis[0]] + umis[1:], dev)[0][1:]
    for bad, what in (((raw.to(torch.int8), offs, ho), "raw must be"),
                      ((raw, offs.long(), ho), "offs must be int32"),
                      ((raw, offs.cpu(), ho), "one device"),
                      ((raw, offs), "need host_offs"),
                      ((raw, offs, ho[:-1]), "host_offs must be"),
                      ((raw, offs, falls), "without a fall"),
                      ((raw[:-1], offs, ho), "to S"),
                      ((shifted, offs, ho), "16-byte aligned"),
                      ((raw, torch.stack((offs, offs), 1)[:, 0], ho),
                       "contiguous")):
        with pytest.raises(ValueError, match=what):
            editdist.myers_global_group(*bad)
    # an empty group launches nothing
    before = editdist.myers_global_group.launches
    assert editdist.myers_global_group(
        *editdist.group_inputs([], dev)).shape == (0, 0)
    assert editdist.myers_global_group.launches == before


@pytest.mark.parametrize("K", [45, 8200])
def test_pairwise_download_above_pinned_bytes(dev, monkeypatch, K):
    """A matrix over PINNED_BYTES comes down a run of rows at a time
    through one pinned block, equal to a plain copy and writeable (the host
    rows go into it): 8,200 x 8,200 is over the limit as it is; at 45 the
    limit is cut to 7 rows (runs of 7, the last one short), and the group
    call through it equals the CPU's."""
    from sicelore_tpu_torch.core import umicluster

    d = torch.randint(-9, 99, (K, K), dtype=torch.int32, device=dev)
    if K == 45:
        monkeypatch.setattr(umicluster, "PINNED_BYTES", 7 * 45 * 4)
    assert d.numel() * 4 > umicluster.PINNED_BYTES
    got = umicluster.to_host(d)
    assert got.dtype == np.int32 and got.flags.writeable
    np.testing.assert_array_equal(got, d.cpu().numpy())
    if K == 45:
        umis = chip_smoke.umi_groups()["mixed"]
        np.testing.assert_array_equal(
            umicluster._pairwise_ed_device(umis, dev),
            umicluster._pairwise_ed_device(umis, "cpu"))


def _encode_sets(reads):
    """The encode kernel's read sets: chip_smoke's edge set and the
    module's reads (qualities of their own length, and cut or grown)."""
    rng = np.random.default_rng(12)
    _, seqs = reads
    quals = [rng.integers(0, 256, max(len(s) + int(d), 0)).astype(
        np.uint8).tobytes() for s, d in zip(seqs, rng.integers(-9, 9,
                                                               len(seqs)))]
    return {"edge": chip_smoke.encode_edge_reads(rng),
            "reads": (seqs, quals)}


@pytest.mark.parametrize("entry", ["two_half", "composite"])
@pytest.mark.parametrize("spans", [None, [(0, 1), (1, 37), (37, 60)]])
@pytest.mark.parametrize("name", ["edge", "reads"])
def test_encode_kernel_matches_plain(dev, reads, name, spans, entry):
    """csrc/encode.cu against its plain version on the same bytes, in one
    launch or in spans of rebased offsets (the first 60 reads): every row,
    exact; the wrapper counts its launches, the plain version does not
    run on the card."""
    from sicelore_tpu_torch.ops import encode_cuda as enc
    seqs, quals = _encode_sets(reads)[name]
    kern = getattr(enc, f"encode_{entry}_dev")
    plain = getattr(enc, f"encode_{entry}_plain")
    if spans is not None:
        seqs, quals = seqs[:60], quals[:60]
    want = plain(*enc.chunk_inputs(seqs, quals, "cpu"))
    st = enc.Staged(enc.join(seqs, quals), spans or [(0, len(seqs))], "cuda")
    n, p = kern.launches, plain.launches
    parts = [kern(*st.upload(dev, a, b)) for a, b in
             (spans or [(0, len(seqs))])]
    torch.cuda.synchronize()
    assert kern.launches == n + len(parts) and plain.launches == p
    for w, got in zip(want, zip(*parts)):
        got = torch.cat(got).cpu()
        assert got.dtype == w.dtype and torch.equal(got, w)


def test_encode_kernel_pageable_route_and_refusals(dev, reads):
    """A chunk over STAGING_BYTES goes up from pageable memory, to the same
    rows; the wrappers refuse what the kernel does not take; an empty chunk
    launches nothing."""
    from sicelore_tpu_torch.ops import encode_cuda as enc
    seqs, quals = _encode_sets(reads)["edge"]
    want = enc.encode_two_half_plain(*enc.chunk_inputs(seqs, quals, "cpu"))
    limit = enc.STAGING_BYTES
    enc.STAGING_BYTES = 1024
    try:
        st = enc.Staged(enc.join(seqs, quals), [(0, len(seqs))], "cuda")
    finally:
        enc.STAGING_BYTES = limit
    assert st.ring_index is None
    got = enc.encode_two_half_dev(*st.upload(dev, 0, len(seqs)))
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)
    inp = enc.chunk_inputs(seqs, quals, dev)
    falls = inp.host_soffs.copy()
    falls[2] = falls[-1] + 1
    for bad, what in ((inp._replace(seq=inp.seq.view(torch.int8)), "uint8"),
                      (inp._replace(soffs=inp.soffs.int()), "int64"),
                      (inp[:4], "host"),
                      (inp._replace(host_soffs=falls), "fall"),
                      (inp._replace(seq=inp.seq[:-1]), "fall"),
                      (inp._replace(soffs=inp.soffs.cpu()), "one device"),
                      (inp._replace(soffs=torch.stack(
                          (inp.soffs, inp.soffs), 1)[:, 0]), "contiguous")):
        for fn in (enc.encode_two_half_dev, enc.encode_composite_dev):
            with pytest.raises(ValueError, match=what):
                fn(*bad)
    before = enc.encode_two_half_dev.launches
    codes, _, qsum = enc.encode_two_half_dev(*enc.chunk_inputs([], [], dev))
    assert codes.shape == (0, 2 * eg.E) and qsum.shape == (0,)
    assert enc.encode_two_half_dev.launches == before


@pytest.mark.parametrize("entry", ["two_half", "composite"])
@pytest.mark.parametrize("at", range(16))
def test_encode_kernel_inputs_at_any_address(dev, at, entry):
    """seq and qual as views starting 0-15 bytes past a 16-byte boundary
    (the kernel widens each span to 16-byte addresses, so its copies reach
    before the views' first byte and past their last): chip_smoke's
    encode_shape_reads (lengths around 0, E, 2E and 3E in a row, L = 0
    beside Lq = 0, L > 2E with Lq <= 2E and the reverse), exact."""
    from sicelore_tpu_torch.ops import encode_cuda as enc
    seqs, quals = chip_smoke.encode_shape_reads(np.random.default_rng(at))
    want = getattr(enc, f"encode_{entry}_plain")(
        *enc.chunk_inputs(seqs, quals, "cpu"))
    got = getattr(enc, f"encode_{entry}_dev")(
        *chip_smoke.encode_inputs_at(seqs, quals, dev, at, (5 * at + 3) % 16))
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def _many_reads(n, seed=31):
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"ACGTacgtN\x00", np.uint8)
    seqs, quals = [], []
    for i in range(n):
        L = int(rng.choice([0, rng.integers(1, 2 * eg.E + 2),
                            rng.integers(2 * eg.E, 3000)]))
        Lq = max(L + int(rng.integers(-3, 4)) * (i % 5 == 0), 0)
        seqs.append(rng.choice(pool, L).tobytes())
        quals.append(rng.integers(0, 256, Lq).astype(np.uint8).tobytes())
    return seqs, quals


@pytest.mark.parametrize("entry", ["two_half", "composite"])
@pytest.mark.parametrize("which", ["1", "2", "grid-1", "grid", "grid+1",
                                   "3grid+5"])
def test_encode_kernel_b_around_the_grid(dev, which, entry):
    """B of 1, 2, one less than, as many as and one more than the warps of
    a full grid (`grid_warps`: a warp takes several reads past it), and
    several times them: every row exact, through the pinned staging."""
    from sicelore_tpu_torch.ops import encode_cuda as enc
    gw = enc.grid_warps(dev)
    B = {"1": 1, "2": 2, "grid-1": gw - 1, "grid": gw, "grid+1": gw + 1,
         "3grid+5": 3 * gw + 5}[which]
    seqs, quals = _many_reads(B)
    want = getattr(enc, f"encode_{entry}_plain")(
        *enc.chunk_inputs(seqs, quals, "cpu"))
    got = getattr(enc, f"encode_{entry}_dev")(
        *enc.chunk_inputs(seqs, quals, dev))
    for w, g in zip(want, got):
        assert g.shape[0] == B and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("entry", ["two_half", "composite"])
def test_encode_kernel_shape_reads_pageable(dev, entry):
    """encode_shape_reads through the pageable staging (a chunk over
    STAGING_BYTES) in spans of rebased offsets: exact."""
    from sicelore_tpu_torch.ops import encode_cuda as enc
    seqs, quals = chip_smoke.encode_shape_reads(np.random.default_rng(40))
    spans = [(0, 1), (1, 30), (30, len(seqs))]
    want = getattr(enc, f"encode_{entry}_plain")(
        *enc.chunk_inputs(seqs, quals, "cpu"))
    limit = enc.STAGING_BYTES
    enc.STAGING_BYTES = 1024
    try:
        st = enc.Staged(enc.join(seqs, quals), spans, "cuda")
    finally:
        enc.STAGING_BYTES = limit
    assert st.ring_index is None
    kern = getattr(enc, f"encode_{entry}_dev")
    parts = [kern(*st.upload(dev, a, b)) for a, b in spans]
    for w, g in zip(want, zip(*parts)):
        assert torch.equal(torch.cat(g).cpu(), w)


# ---------------------------------------------------------------------------
# the host engine's alignment (csrc/hostnw.cu)
# ---------------------------------------------------------------------------

def _long_pairs(rng, n=12):
    """Centers of 2,100-2,300 nt against noisy reads up to 200 nt shorter,
    some with an N."""
    out = []
    for i in range(n):
        a = synth.random_seq(rng, int(rng.integers(2_100, 2_301))).encode()
        b = bytearray(synth.mutate_np(rng, a, 0.04))
        del b[: int(rng.integers(0, 200))]
        if i % 3 == 0:
            b[len(b) // 2] = ord("N")
        out.append((a, bytes(b)))
    return out


def _mixed_pairs(rng, n=240):
    """n pairs of every kind: the host-alignment cases, regular molecules'
    pairs of 400-899 nt and long centers."""
    out = [p for name in chip_smoke.HOSTNW_CASES
           for p in chip_smoke.hostnw_pairs(name)]
    out += _long_pairs(rng, 8)
    while len(out) < n:
        a = synth.random_seq(rng, int(rng.integers(400, 900))).encode()
        out.append((a, synth.mutate_np(rng, a, 0.05)))
    return out[:n]


def _hostnw_vs_plain(pairs, dev):
    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    from sicelore_tpu_torch.ops import poa
    seq, a_off, la, b_off, lb = chip_smoke.hostnw_packed(pairs)
    table = hn.pair_table(a_off, la, b_off, lb)
    before = hn.host_nw.launches
    mv, n = hn.host_nw(torch.from_numpy(seq.copy()).to(dev),
                       torch.from_numpy(table).to(dev), table)
    torch.cuda.synchronize()
    assert hn.host_nw.launches == before + 1
    mv_p, n_p = hn.host_nw_plain(torch.from_numpy(seq.copy()),
                                 torch.from_numpy(table))
    mv, n, mv_p, n_p = (x.cpu().numpy() for x in (mv, n, mv_p, n_p))
    np.testing.assert_array_equal(n, n_p)
    for p, (a, b) in enumerate(pairs):
        s = slice(table[p, 5], table[p, 5] + n[p])
        np.testing.assert_array_equal(mv[s], mv_p[s])
        assert chip_smoke.hostnw_aligned(a, b, mv[s]) == \
            poa.nw_align_banded(a, b), (p, len(a), len(b))


@pytest.mark.parametrize("name", chip_smoke.HOSTNW_CASES
                         + ("long", "mixed240"))
def test_hostnw_kernel_matches_plain_and_host(dev, name):
    """csrc/hostnw.cu's moves equal the plain version's and, as aligned
    strings, `poa.nw_align_banded`'s, on the host-alignment cases, 2.1-2.3
    kb centers and a batch of 240 mixed pairs (int32 exact at those
    sizes); one launch each."""
    rng = np.random.default_rng(91)
    pairs = (_long_pairs(rng) if name == "long" else _mixed_pairs(rng)
             if name == "mixed240" else chip_smoke.hostnw_pairs(name))
    _hostnw_vs_plain(pairs, dev)


def test_hostnw_kernel_rejects_other_inputs(dev):
    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    seq, a_off, la, b_off, lb = chip_smoke.hostnw_packed(
        chip_smoke.hostnw_pairs("tiny"))
    table = hn.pair_table(a_off, la, b_off, lb)
    s = torch.from_numpy(seq.copy()).to(dev)
    t = torch.from_numpy(table).to(dev)
    with pytest.raises(ValueError, match="host_table"):
        hn.host_nw(s, t)
    with pytest.raises(ValueError, match="one device"):
        hn.host_nw(s, t.cpu(), table)


@pytest.mark.parametrize("name", ("equal", "short_read", "all_n",
                                  "band_edge", "repeats", "long",
                                  "mixed240"))
def test_hostnw_kernel_rows_in_the_slab(dev, name, monkeypatch):
    """With the block's shared memory for rows cut to 128 ints, every pair
    of a stride over 64 keeps its rows in the slab and walks back on it
    (the path of reads too long for shared memory), the rest take stripes
    of two rows or more: the moves stay the plain version's and the
    host's."""
    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    monkeypatch.setattr(hn, "SMEM_INTS", 128)
    rng = np.random.default_rng(93)
    pairs = (_long_pairs(rng, 6) if name == "long" else _mixed_pairs(rng)
             if name == "mixed240" else chip_smoke.hostnw_pairs(name))
    st = hn.strides([len(a) for a, _ in pairs], [len(b) for _, b in pairs])
    assert (2 * st > hn.SMEM_INTS).any()
    _hostnw_vs_plain(pairs, dev)


@pytest.mark.parametrize("kind", ["wta", "deep"])
def test_host_routes_on_the_card_are_the_host_engine(dev, kind):
    """The engine on the card gives `poa.consensus_reads`'s bytes for every
    molecule of a wta-like and a deep-like set of N, long-center and one-
    or two-read molecules, with one host-alignment launch (routes n and
    long together) and no plain body; every pair counted on the card."""
    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    from sicelore_tpu_torch.ops import poa
    from sicelore_tpu_torch.utils import trace
    mols = chip_smoke.host_molecules(np.random.default_rng(92), kind)
    before = (hn.host_nw.launches, hn.host_nw_plain.launches)
    trace.enable()
    try:
        got = pc.BatchedConsensusEngine(device="cuda")(mols)
        torch.cuda.synchronize()
        snap = trace.snapshot()
    finally:
        trace.disable()
    assert (hn.host_nw.launches, hn.host_nw_plain.launches) == \
        (before[0] + 1, before[1])
    for m, seqs in enumerate(mols):
        assert got[m] == poa.consensus_reads(seqs, 3, 20), m
    assert _pairs_where(snap) == {
        "card": sum(len(s) - 1 for s in mols if len(s) > 2)}


def _pairs_where(snap):
    where = {}
    for c in snap["counters"]:
        if c["name"] == "consensus.host_pairs":
            where[c["attrs"]["where"]] = where.get(c["attrs"]["where"], 0) \
                + c["value"]
    return where


def test_host_routes_with_rows_in_the_slab(dev, monkeypatch):
    """The engine's host routes with every pair's rows in the slab (shared
    memory for rows cut to 128 ints) give `poa.consensus_reads`'s bytes."""
    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    from sicelore_tpu_torch.ops import poa
    monkeypatch.setattr(hn, "SMEM_INTS", 128)
    mols = chip_smoke.host_molecules(np.random.default_rng(94), "wta")
    before = (hn.host_nw.launches, hn.host_nw_plain.launches)
    got = pc.BatchedConsensusEngine(device="cuda")(mols)
    assert (hn.host_nw.launches, hn.host_nw_plain.launches) == \
        (before[0] + 1, before[1])
    for m, seqs in enumerate(mols):
        assert got[m] == poa.consensus_reads(seqs, 3, 20), m


def test_host_route_of_a_pair_too_wide_for_shared_memory(dev):
    """A molecule of a 39.2 kb center, a read of its first ~28.75 kb and
    a 600 nt read: the long pair's score row (min(2 band + 1, lb), band
    |la - lb| + la // 10, some 14,400) is over half the block's shared
    memory for rows, so its rows stay in the slab; the engine on the card
    gives `poa.consensus_reads`'s bytes (the host's matrix of that pair:
    9 GB), in one launch with no plain body, every pair counted on the
    card."""
    from sicelore_tpu_torch.ops import hostnw_cuda as hn
    from sicelore_tpu_torch.ops import poa
    from sicelore_tpu_torch.utils import trace
    rng = np.random.default_rng(95)
    center = synth.random_seq(rng, 39_200).encode()
    mol = [center, synth.mutate_np(rng, center[:28_750], 0.03),
           synth.mutate_np(rng, center[20_000:20_600], 0.03)]
    st = hn.strides([len(center)] * 2, [len(mol[1]), len(mol[2])])
    assert 2 * st[0] > hn.SMEM_INTS >= 2 * st[1]
    before = (hn.host_nw.launches, hn.host_nw_plain.launches)
    trace.enable()
    try:
        got = pc.BatchedConsensusEngine(device="cuda")([mol])
        torch.cuda.synchronize()
        snap = trace.snapshot()
    finally:
        trace.disable()
    assert (hn.host_nw.launches, hn.host_nw_plain.launches) == \
        (before[0] + 1, before[1])
    assert _pairs_where(snap) == {"card": 2}
    assert got[0] == poa.consensus_reads(mol, 3, 20)
