"""The long-cDNA cell on the CPU at a size a test run holds: every seed
gives the same set of (depth, length band, N) molecules, each band's share
of molecules by longest read is the traffic file's, the reference's first
five numbers are `reference.consensus.judge`'s, a sound run is correct, and
a run whose long molecules get each other's consensus or lose their first
100 columns, or the control in the program's place, is not. The three new
metrics read None where the program has no such span or counter, and the
roofline reads the counters' work over the launches' time."""
import numpy as np
import pytest

from benchmark.drivers import consensus_longcdna as drv
from benchmark.gen import longcdna as gen
from benchmark.harness import cell
from benchmark.harness.work import HBM_BYTES_PER_S, INT32_OPS_PER_S
from benchmark.metrics import _program
from benchmark.reference import consensus as rc
from benchmark.reference import longcdna as ref

CELL = "tenx3p_v3_longcdna.consensus_longcdna"
SEED = 2**32 + 61
MIX = cell.load_json(cell.BENCH / "traffic" / "consensus_longcdna.json")[
    "mix"]
# three short and three long molecules of three reads: the long route at a
# size the plain versions take in seconds
SMALL = {"molecules": 6, "depth_range": [3, 4], "n_share": 0,
         "bands": [[0.5, 400, 500], [0.5, 2100, 2200]]}


def key_set(mols, mix):
    bands = gen.band_of(np.array([len(t) for t in mols.truths]), mix)
    return sorted(zip((len(r) for r in mols.reads), bands.tolist(),
                      (any(b"N" in s for s in r) for r in mols.reads)))


def test_every_seed_gives_the_same_set():
    a = gen.make_molecules(np.random.default_rng(SEED), MIX)
    b = gen.make_molecules(np.random.default_rng(2**31 + 3), MIX)
    assert key_set(a, MIX) == key_set(b, MIX)
    assert sorted(map(len, a.truths)) == sorted(map(len, b.truths))
    assert a.truths != b.truths
    depth, length, with_n = gen.design(MIX)
    assert sorted(zip(depth.tolist(), gen.band_of(length, MIX).tolist(),
                      with_n.tolist())) == key_set(a, MIX)
    assert depth.min() == 3 and depth.max() == 12
    assert with_n.sum() == round(MIX["n_share"] * MIX["molecules"])
    assert a.n_records == depth.sum()


def test_bands_by_longest_read_hold_the_traffic_file():
    """Over 2,048 nt (the long route): the last band exactly; 1,025-2,048
    (the Lc 2,048 bucket): the middle band but its truths that reads keep
    at 1,024 or under; the rest under 1,025."""
    mols = gen.make_molecules(np.random.default_rng(SEED), MIX)
    top = np.array([max(map(len, r)) for r in mols.reads])
    (s0, _, _), (s1, l1, e1), (s2, _, _) = MIX["bands"]
    n = MIX["molecules"]
    assert (top > 2048).sum() == round(s2 * n)
    mid = ((top > 1024) & (top <= 2048)).mean()
    # truths of 1,000-1,024 nt keep most reads at 1,024 or under
    edge = s1 * (1024 - l1) / (e1 - l1)
    assert s1 - edge - 0.01 <= mid <= s1
    assert s0 - 1 / n <= (top <= 1024).mean() <= s0 + edge + 0.01
    assert abs((top <= 512).mean() - s0 * (512 - 400) / 600) < 0.01


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    bench = cell.load_json(cell.ROOT / "BENCHMARK.json")
    _, config, traffic, _ = cell.load_cell(bench, CELL, {"mix": SMALL})
    c = cell.Cell(CELL, config, traffic["mix"], SEED,
                  tmp_path_factory.mktemp("longcdna"), "cpu")
    s = drv.setup(c)
    drv.call(s, c.workdir / "out")
    return s


def test_first_five_numbers_are_the_consensus_references(state, tmp_path):
    out = state.cell.workdir / "out" / "consensus.fastq"
    c = state.cell.config["consensus"]
    nums = ref.judge(out, state.mols, c)
    assert {k: nums[k] for k in rc.judge(out, state.mols, c)} == \
        rc.judge(out, state.mols, c)
    assert nums["long_errors_per_kb"] > 0 and nums["mid_errors_per_kb"] == 0
    # a file with every long record's first 100 bases dropped
    lines = out.read_bytes().split(b"\n")
    for i in range(1, len(lines) - 1, 4):
        if len(lines[i]) > 2048:
            lines[i], lines[i + 2] = lines[i][100:], lines[i + 2][100:]
    cut = tmp_path / "cut.fastq"
    cut.write_bytes(b"\n".join(lines))
    bad = ref.judge(cut, state.mols, c)
    assert {k: bad[k] for k in rc.judge(cut, state.mols, c)} == \
        rc.judge(cut, state.mols, c)
    assert bad["long_errors_per_kb"] > nums["long_errors_per_kb"] + 40


def run(seed=SEED):
    return cell.run_cell(CELL, seed, 0.01, False, device="cpu",
                         overrides={"mix": SMALL}, log=lambda *a, **k: None)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def _long(monkeypatch, alter):
    """The engine's answers for the molecules with a read over 2,048 nt
    altered by alter(list of their answers)."""
    from sicelore_tpu_torch.ops.poa_cuda import BatchedConsensusEngine
    orig = BatchedConsensusEngine.__call__

    def call(self, mols, **kw):
        res = orig(self, mols, **kw)
        idx = [i for i, m in enumerate(mols) if max(map(len, m)) > 2048]
        for i, r in zip(idx, alter([res[i] for i in idx])):
            res[i] = r
        return res
    monkeypatch.setattr(BatchedConsensusEngine, "__call__", call)


def _swapped(monkeypatch):
    """Each long molecule gets the next long molecule's consensus."""
    _long(monkeypatch, lambda rs: rs[1:] + rs[:1])


def _first_100_dropped(monkeypatch):
    _long(monkeypatch, lambda rs: [(c[100:], q[100:]) for c, q in rs])


def _control(monkeypatch):
    """The control's call (MAXPS one lower) in the program's place."""
    real = drv.call
    monkeypatch.setattr(drv, "call", lambda state, out, **kw:
                        real(state, out, maxps=state.cell.config[
                            "consensus"]["maxps"] - 1))


@pytest.mark.parametrize("fault,number", [
    (_swapped, "long_worst_error_pct"),
    (_first_100_dropped, "long_errors_per_kb"),
    (_control, "qv_cap_differing")],
    ids=["swapped", "first_100_dropped", "control"])
def test_fault_and_control_are_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    r = run()
    assert not r["correct"]
    assert r["failed"] == r["attempted"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


@pytest.fixture
def metrics():
    ms = {m: cell.load_file_module(cell.BENCH / "metrics" / f"{m}.py",
                                   "m_" + m.replace(".", "_"))
          for m in ("consensus.hostnw_align_ms_per_kumi",
                    "consensus.hostnw_rows_ms_per_kumi", "hostnw_roofline")}
    yield ms
    _program.trace.disable()        # the modules armed the tracer
    _program.trace.reset()


def trace_run(units=2000):
    return cell.TraceRun(units, 2, 51.0, {}, [], 0.0)


def test_new_metrics_read_none_without_their_records(metrics, monkeypatch):
    """A program without the long route's spans and counters (the parent's)
    and one without a tracer."""
    r = trace_run()
    monkeypatch.setattr(_program, "_taken", [r, {
        "spans": [{"name": "consensus.host", "start": 0, "end": 10**6,
                   "attrs": {"route": "long"}}],
        "counters": [], "clocks": {},
        "launches": [{"name": "hostnw", "start": 0, "end": 10**6}]}])
    assert all(m.read(r) is None for m in metrics.values())
    monkeypatch.setattr(_program, "trace", None)
    monkeypatch.setattr(_program, "_taken", [None, None])
    assert all(m.read(trace_run()) is None for m in metrics.values())


def test_new_metrics_arithmetic(metrics, monkeypatch):
    r = trace_run(4000)
    ms = 10**6
    snap = {"clocks": {}, "spans": [
        {"name": "hostnw.align", "start": 0, "end": 30 * ms, "attrs": {}},
        {"name": "hostnw.align", "start": 50 * ms, "end": 60 * ms,
         "attrs": {}},
        {"name": "hostnw.rows", "start": 30 * ms, "end": 38 * ms,
         "attrs": {}}],
        "counters": [
        {"name": "hostnw.band_cells", "attrs": {}, "value": 3 * 10**9},
        {"name": "hostnw.band_cells", "attrs": {}, "value": 10**9},
        {"name": "hostnw.pairs", "attrs": {}, "value": 1000},
        {"name": "hostnw.move_bytes", "attrs": {}, "value": 6 * 10**6}],
        "launches": [
        {"name": "hostnw", "start": 0, "end": 20 * ms},
        {"name": "hostnw", "start": 50 * ms, "end": 70 * ms},
        {"name": "bandalign", "start": 0, "end": 100 * ms}]}
    monkeypatch.setattr(_program, "_taken", [r, snap])
    assert metrics["consensus.hostnw_align_ms_per_kumi"].read(r) == \
        pytest.approx(40 * 1000 / 4000)
    assert metrics["consensus.hostnw_rows_ms_per_kumi"].read(r) == \
        pytest.approx(8 * 1000 / 4000)
    need = max(9 * 4e9 / INT32_OPS_PER_S,
               (2 * 6e6 + 52 * 1000) / HBM_BYTES_PER_S)
    assert metrics["hostnw_roofline"].read(r) == \
        pytest.approx(100 * need / 0.040)


def test_new_files_load_no_jax_and_the_reference_nothing_of_the_program():
    from benchmark.tests.test_bench_imports import FORBIDDEN, loaded_after
    top = loaded_after("from benchmark.reference import longcdna\n"
                       "from benchmark.gen import longcdna as g\n")
    assert not top & (set(FORBIDDEN) | {"sicelore_tpu_torch"})
    top = loaded_after(
        "from benchmark.drivers import consensus_longcdna\n"
        "from benchmark.harness import cell\n"
        "for m in ('consensus.hostnw_align_ms_per_kumi',\n"
        "          'consensus.hostnw_rows_ms_per_kumi', 'hostnw_roofline'):\n"
        "    cell.load_file_module(cell.BENCH / 'metrics' / (m + '.py'),\n"
        "                          'm_' + m.replace('.', '_'))\n")
    assert "sicelore_tpu_torch" in top and not top & set(FORBIDDEN)
