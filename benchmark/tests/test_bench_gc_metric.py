"""`consensus.gc_ms_per_kumi`: the program's counter `gc.ns` summed over
every generation per 1,000 molecules of the run, 0 where the window held
no collection, and None where the program has no tracer."""
import pytest

from benchmark.harness import cell
from benchmark.metrics import _program

SNAP = {"spans": [], "launches": [], "clocks": {}, "counters": [
    {"name": "gc.ns", "attrs": {"generation": 0}, "value": 3_000_000},
    {"name": "gc.ns", "attrs": {"generation": 1}, "value": 1_500_000},
    {"name": "gc.ns", "attrs": {"generation": 2}, "value": 5_500_000},
    {"name": "gc.collections", "attrs": {"generation": 0}, "value": 9},
    {"name": "consensus.parse_ns", "attrs": {"phase": "build"},
     "value": 70_000_000}]}


@pytest.fixture
def metric():
    m = cell.load_file_module(cell.BENCH / "metrics"
                              / "consensus.gc_ms_per_kumi.py",
                              "m_consensus_gc_ms_per_kumi")
    yield m
    _program.trace.disable()        # the module armed the tracer
    _program.trace.reset()


def run(units):
    return cell.TraceRun(units, 2, 51.0, {}, [], 0.0)


def test_sums_every_generation_per_kumi(metric, monkeypatch):
    r = run(2000)
    monkeypatch.setattr(_program, "_taken", [r, SNAP])
    assert metric.read(r) == pytest.approx(10.0 * 1000 / 2000)


def test_a_window_without_a_collection_reads_zero(metric, monkeypatch):
    r = run(2000)
    monkeypatch.setattr(_program, "_taken", [r, {
        **SNAP, "counters": [c for c in SNAP["counters"]
                             if c["name"] != "gc.ns"]}])
    assert metric.read(r) == 0.0


def test_none_without_a_snapshot(metric, monkeypatch):
    monkeypatch.setattr(_program, "trace", None)
    monkeypatch.setattr(_program, "_taken", [None, None])
    assert metric.read(run(2000)) is None
