"""Mesh mode of the port on CPU meshes: `ScanFastqPipeline(mesh=...)` and
`BatchedConsensusEngine(mesh=...)` must write what one device writes, and
what the JAX package writes with an 8-device CPU mesh, byte for byte
(tests/test_multichip_pipeline.py's fixture and molecules)."""
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sicelore_tpu.ops.poa_tpu import BatchedConsensusEngine as JaxEngine
from sicelore_tpu.parallel import consensus_step as jax_step
from sicelore_tpu.pipeline.scanfastq import ScanFastqPipeline as JaxPipeline
from sicelore_tpu.utils import synth
from sicelore_tpu.utils.config import PipelineConfig
from sicelore_tpu_torch.models.readscan import ReadScanModel
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.parallel import shard
from sicelore_tpu_torch.pipeline.scanfastq import ScanFastqPipeline
from sicelore_tpu_torch.utils import dna
from sicelore_tpu_torch.utils import synth as tsynth
from sicelore_tpu_torch.utils.config import PipelineConfig as TorchConfig


def _jax_mesh(n=8):
    devs = jax.devices()
    assert len(devs) >= n, "tests/conftest.py gives JAX 8 CPU devices"
    return Mesh(np.array(devs[:n]), ("data",))


@pytest.fixture
def spans_seen(monkeypatch):
    """The number of spans of every `shard.map_shards` call."""
    seen = []
    inner = shard.map_shards

    def spy(devices, spans, fn):
        seen.append(len(spans))
        return inner(devices, spans, fn)

    monkeypatch.setattr(shard, "map_shards", spy)
    return seen


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """tests/test_multichip_pipeline.py's run: seed 7, 400 reads of 8 cells
    from a 128-barcode whitelist and 10 garbage reads."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("mcrun")
    wl = synth.make_whitelist(rng, 128)
    cells = wl[:8]
    recs = []
    for i in range(400):
        cell = cells[int(rng.integers(0, 8))]
        r = synth.make_read(rng, cell, cdna_len=int(rng.integers(150, 500)),
                            error_rate=0.05, reverse=bool(rng.random() < 0.5))
        recs.append((f"r{i}".encode(), r["seq"], r["qual"]))
    for i in range(10):
        s = synth.random_seq(rng, 300).encode()
        recs.append((f"g{i}".encode(), s, b"I" * len(s)))
    with gzip.open(d / "reads.fastq.gz", "wb") as fh:
        for n, s, q in recs:
            fh.write(b"@" + n + b"\n" + s + b"\n+\n" + q + b"\n")
    return d, wl


def _files(out, html=True):
    return {str(f.relative_to(out)): f.read_bytes()
            for f in sorted(out.rglob("*")) if f.is_file()
            and (html or f.name != "ReadScanner.html")}


@pytest.fixture(scope="module")
def single(run_dir, tmp_path_factory):
    """The port on one CPU device: (pipeline, stats, files)."""
    d, wl = run_dir
    out = tmp_path_factory.mktemp("one")
    pipe = ScanFastqPipeline(TorchConfig(), whitelist=wl, user_max_ed=2,
                             chunk_size=128, device="cpu")
    stats = pipe.run([d], out)
    return pipe, stats, _files(out)


@pytest.fixture(scope="module")
def jax_mesh_run(run_dir, tmp_path_factory):
    """The JAX pipeline on an 8-device CPU mesh."""
    d, wl = run_dir
    out = tmp_path_factory.mktemp("jaxmesh")
    pipe = JaxPipeline(PipelineConfig(), whitelist=wl, user_max_ed=2,
                       chunk_size=128, mesh=_jax_mesh(8))
    stats = pipe.run([d], out)
    return pipe, stats, _files(out, html=False)


@pytest.mark.parametrize("n,cache", [(2, None), (8, None), (8, False)])
def test_scan_pipeline_mesh_equals_single_and_jax(run_dir, single,
                                                  jax_mesh_run, tmp_path,
                                                  spans_seen, n, cache):
    """Every file (passed/, failed/, BarcodeList.tsv, BarcodesAssigned.tsv,
    scanner_stats.json, the report) equals the port's one-device run, and
    all but the report the JAX 8-device mesh run; cached pass 1 (the
    default here) and the streaming passes."""
    d, wl = run_dir
    pipe = ScanFastqPipeline(TorchConfig(), whitelist=wl, user_max_ed=2,
                             chunk_size=128, mesh=["cpu"] * n, device="cpu",
                             cache_pass1=cache)
    stats = pipe.run([d], tmp_path / "mesh")
    got = _files(tmp_path / "mesh")
    s_pipe, s_stats, s_files = single
    j_pipe, j_stats, j_files = jax_mesh_run
    assert max(spans_seen) == n
    assert stats.to_json() == s_stats.to_json()
    assert stats.bc_assigned == j_stats.bc_assigned > 300
    assert pipe.used_strs == s_pipe.used_strs == j_pipe.used_strs
    assert got == s_files
    assert {k: v for k, v in got.items()
            if not k.endswith("ReadScanner.html")} == j_files
    assert any(k.startswith("passed/") for k in got)


@pytest.fixture(scope="module")
def three_reads():
    """Three reads for an 8-shard mesh: two stranded reads and a 3 kb
    chimera whose interior makes a few tiles."""
    rng = np.random.default_rng(21)
    wl = synth.make_whitelist(rng, 16)
    reads = [synth.make_read(rng, wl[i], cdna_len=300, error_rate=0.03,
                             reverse=bool(i))
             for i in range(2)]
    reads.append(synth.make_chimera(rng, wl[2], wl[3], cdna_len=1500))
    pats, _ = dna.encode_batch([w.encode() for w in wl], 16)
    return [r["seq"] for r in reads], [r["qual"] for r in reads], pats


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("method", ["pass1", "pass1_full", "search",
                                    "sweep", "tiles"])
def test_chunk_smaller_than_mesh(three_reads, spans_seen, method):
    """3 reads on 8 shards: each sharded method gives the one-device
    result, and only the shards with rows run (no empty launch)."""
    seqs, quals, pats = three_reads
    models = [ReadScanModel(TorchConfig(), device="cpu"),
              ReadScanModel(TorchConfig(), device="cpu", mesh=["cpu"] * 8)]
    outs, want = [], 3
    for m in models:
        m.prepare_search(pats, len(pats))
        if method == "pass1":
            outs.append(m.finish_pass1(m.scan_pass1_async(seqs, quals)))
        elif method == "pass1_full":
            outs.append(m.finish_pass1_full(
                m.scan_pass1_full_async(seqs, quals)))
        elif method == "search":
            outs.append(m.finish_search(m.scan_search_async(seqs, quals)))
        elif method == "sweep":
            wins = m.finish_pass1_full(m.scan_pass1_full_async(seqs,
                                                               quals))[1]
            outs.append(m.finish_bc_sweep(m.bc_sweep_async(wins)))
        else:
            h = m.internal_tiles_async(seqs)
            want = len(h[1])         # tiles, fewer than the shards too
            assert 1 < want < 8
            outs.append(m.finish_internal_tiles(h))
    _same(outs[0], outs[1])
    assert spans_seen[-1] == want and max(spans_seen) < 8


@pytest.mark.parametrize("n,shards,want", [
    (0, 8, [(0, 0)]), (3, 8, [(0, 1), (1, 2), (2, 3)]),
    (10, 4, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (16, 8, [(i, i + 2) for i in range(0, 16, 2)]), (7, 1, [(0, 7)])])
def test_cuts_cover_every_row_once(n, shards, want):
    got = shard.cuts(n, shards)
    assert got == want
    assert len(got) <= shards
    assert [i for a, b in got for i in range(a, b)] == list(range(n))


@pytest.mark.parametrize("mesh,device,err", [
    ([], "cpu", ValueError), (["cpu", "cuda:0"], "cpu", RuntimeError),
    (["cpu"], "cuda", RuntimeError)])
def test_mesh_errors(mesh, device, err):
    """An empty mesh, a mesh naming a card that is not there (here: no card
    at all) and a device of another type raise; nothing falls back."""
    if err is RuntimeError and torch.cuda.is_available():
        err = (RuntimeError, ValueError)
    with pytest.raises(err):
        shard.resolve_mesh(mesh, device)
    with pytest.raises(err):
        ReadScanModel(TorchConfig(), device=device, mesh=mesh)


@pytest.mark.parametrize("model_mesh,mesh,ok", [
    (["cpu"] * 2, ["cpu"] * 4, False), (None, ["cpu"] * 2, False),
    (["cpu"] * 2, ["cpu", "cpu"], True)])
def test_model_and_mesh_conflict(run_dir, model_mesh, mesh, ok):
    """A shared model carries its mesh: another mesh beside it raises."""
    _, wl = run_dir
    model = ReadScanModel(TorchConfig(), device="cpu", mesh=model_mesh)
    if ok:
        pipe = ScanFastqPipeline(whitelist=wl, model=model, mesh=mesh)
        assert pipe.model is model
        return
    with pytest.raises(ValueError, match="model= and mesh= conflict"):
        ScanFastqPipeline(whitelist=wl, model=model, mesh=mesh)


@pytest.fixture(scope="module")
def molecules():
    """test_consensus_mesh_equals_single's 37 molecules (rng(3), 60-220 nt,
    1-6 reads each)."""
    rng = np.random.default_rng(3)
    mols = []
    for _ in range(37):
        truth = synth.random_seq(rng, int(rng.integers(60, 220)))
        n = int(rng.integers(1, 7))
        mols.append([synth.mutate(rng, truth, 0.04).encode()
                     for _ in range(n)])
    return mols


@pytest.mark.parametrize("refine", [False, True])
def test_consensus_mesh_equals_single_and_jax(molecules, spans_seen,
                                              refine):
    """The port's engine on an 8-CPU mesh against its one-device engine and
    the JAX engines: the production route in interpret mode and the
    8-device mesh."""
    got = poa_cuda.BatchedConsensusEngine(mesh=["cpu"] * 8, device="cpu")(
        molecules, refine=refine)
    assert max(spans_seen) > 1
    one = poa_cuda.BatchedConsensusEngine(device="cpu")(molecules,
                                                        refine=refine)
    ref = JaxEngine(force="pallas-interpret")(molecules, refine=refine)
    jmesh = JaxEngine(mesh=_jax_mesh(8))(molecules, refine=refine)
    assert got == one == ref == jmesh
    assert sum(len(c) > 0 for c, _ in got) == len(molecules)


def test_consensus_mesh_molecules_without_pairs(spans_seen):
    """Molecules whose reads all fall outside the band (no pair) in the
    middle and at the end of a bucket, split over 3 shards, and a molecule
    with an N (the host engine), at maxps 20 and 64."""
    rng = np.random.default_rng(10)
    mols, _ = tsynth.molecule_set(rng, 7, 4, 0.06, 150)
    for at in (3, len(mols)):
        truth = tsynth.random_seq(rng, 200)
        mols.insert(at, [truth.encode(), truth[:150].encode(),
                         truth[:160].encode()])
    mols[1][2] = mols[1][2][:40] + b"N" + mols[1][2][41:]
    for maxps in (20, 64):
        one = poa_cuda.BatchedConsensusEngine(device="cpu")(mols,
                                                            maxps=maxps)
        got = poa_cuda.BatchedConsensusEngine(mesh=["cpu"] * 3,
                                              device="cpu")(mols, maxps=maxps)
        assert got == one
    assert 3 in spans_seen


def test_engine_votes_on_a_mesh_match_jax_and_one_device(spans_seen):
    """`BatchedConsensusEngine._votes` on a 4-CPU mesh: the pairs cut into
    four runs at molecule boundaries (the last molecule has no pair),
    their votes summed, against one device's and against the JAX sharded
    jnp step on a 4-device mesh over the same pairs."""
    rng = np.random.default_rng(33)
    mols, _ = tsynth.molecule_set(rng, 9, 4, 0.05, 180)
    arrs = tsynth.pair_arrays(mols, 256, 32)
    P = len(arrs[4]) // 4 * 4
    arrs = [a[:P] for a in arrs]
    center, clens, reads, rlens, mids = arrs
    M = len(mols)
    cmol, clm = (torch.from_numpy(a) for a in dna.encode_batch(
        [max(s, key=len) for s in mols], 256))

    def votes(**mesh):
        engine = poa_cuda.BatchedConsensusEngine(device="cpu", **mesh)
        cv, iv, pc = engine._votes(reads, rlens, mids, cmol, clm, 256, 32,
                                   0, {})
        # consensus_votes' col_votes carry one more column, an empty one
        return torch.cat([cv, torch.zeros((M, 1, 5), dtype=cv.dtype)],
                         1), iv, pc

    got = votes(mesh=["cpu"] * 4)
    assert spans_seen == [4]
    one = votes()
    assert spans_seen == [4, 1]
    jstep, jn = jax_step.make_sharded_consensus_step(_jax_mesh(4), 32, M)
    ref = jstep(*(jnp.asarray(a) for a in arrs))
    assert jn == 4
    for g, r, o in zip(got, ref, one):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), o.numpy())
    assert int(got[2].sum()) > P // 2 and int(got[2][-1]) == 0
