"""The program's tracer (`sicelore_tpu_torch/utils/trace.py`): off it makes
nothing; on, spans nest with their parents and calls, counters key by name
and attributes, launches map onto the host's clock through the anchor, a
CPU `compute_consensus` counts each molecule's route exactly and writes the
same bytes traced or not, the benchmark's traced run reads the program's
spans, and `computeconsensus --trace` writes Chrome trace-event JSON. The
`gpu` test runs on the card with `python -m pytest tests/test_torch_trace.py
-q -m gpu --noconftest` (nothing here uses jax)."""
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sicelore_tpu_torch.io.bam import BamHeader, BamWriter
from sicelore_tpu_torch.ops import poa_cuda
from sicelore_tpu_torch.pipeline.consensus import compute_consensus
from sicelore_tpu_torch.utils import synth, trace

REPO = Path(__file__).resolve().parents[1]
HDR = BamHeader("@SQ\tSN:chr1\tLN:100000\n", [("chr1", 100000)])
ENGINE_CHILDREN = ("consensus.route", "consensus.host", "consensus.pack",
                   "consensus.upload", "consensus.device", "consensus.wait",
                   "consensus.decode")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def counters(snap, name):
    return {tuple(sorted(c["attrs"].items())): c["value"]
            for c in snap["counters"] if c["name"] == name}


# ---------------------------------------------------------------------------
# the tracer alone
# ---------------------------------------------------------------------------

def test_off_makes_nothing(monkeypatch):
    """Off: `span` and `call` give the one shared null context without
    building a span, `count` returns at once, and nothing is recorded."""
    monkeypatch.setattr(trace, "Span", None)     # building one would raise
    a, b = trace.span("x", k=1), trace.call("y")
    assert a is trace.NULL and b is trace.NULL
    with a as s:
        s.set(k=2)
        trace.count("n", 5, route="a")
    snap = trace.snapshot()
    assert snap == {"spans": [], "counters": [], "launches": [],
                    "clocks": {}}


@pytest.fixture
def no_auto_gc():
    """No collection opens a `gc` span in the middle of the test's own."""
    gc.disable()
    yield
    gc.enable()


def test_spans_nest_with_parent_and_call_ids(no_auto_gc):
    trace.enable()
    with trace.span("outside") as out:
        pass
    with trace.call("c1") as c1:
        with trace.span("a") as a:
            with trace.span("b", k=1) as b:
                b.set(n=2)
        with trace.span("d") as d:
            pass
    with trace.call("c2") as c2:
        with trace.span("e") as e:
            pass
    trace.disable()
    with trace.span("after"):
        pass
    snap = trace.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert [s["name"] for s in snap["spans"]] == [
        "outside", "c1", "a", "b", "d", "c2", "e"]
    assert out.call == 0 and by["outside"]["parent"] == 0
    assert by["c1"]["parent"] == 0 and c1.call > 0
    assert by["a"]["parent"] == c1.id and by["d"]["parent"] == c1.id
    assert by["b"]["parent"] == a.id and by["b"]["attrs"] == {"k": 1, "n": 2}
    assert a.call == b.call == d.call == c1.call
    assert c2.call != c1.call and e.call == c2.call
    assert by["e"]["parent"] == c2.id
    for s in snap["spans"]:
        assert s["start"] <= s["end"]
    own = trace.self_ns(snap["spans"])
    c = by["c1"]
    assert own[c1.id] == (c["end"] - c["start"]) - sum(
        by[n]["end"] - by[n]["start"] for n in ("a", "d"))
    assert own[b.id] == by["b"]["end"] - by["b"]["start"]


def test_self_time_counts_the_union_of_children():
    spans = [
        {"id": 1, "parent": 0, "start": 0, "end": 100},
        {"id": 2, "parent": 1, "start": 10, "end": 40},
        {"id": 3, "parent": 1, "start": 30, "end": 50},   # overlaps 2
        {"id": 4, "parent": 1, "start": 90, "end": 130},  # past the end
        {"id": 5, "parent": 2, "start": 15, "end": 20},
    ]
    assert trace.self_ns(spans) == {1: 100 - 40 - 10, 2: 30 - 5, 3: 20,
                                    4: 40, 5: 5}


def test_full_collections_are_spans_of_their_own():
    """On: a full collection is a `gc` span inside the span it stopped,
    which that span's self time leaves out, and every collection counts
    its time by generation. Off: the collector's callback is gone."""
    trace.enable()
    with trace.call("c") as c:
        gc.collect(0)
        gc.collect()
    trace.disable()
    assert trace._on_gc not in gc.callbacks
    gc.collect()
    snap = trace.snapshot()
    pauses = [s for s in snap["spans"] if s["name"] == "gc"]
    assert len(pauses) >= 1
    assert all(p["parent"] == c.id and p["call"] == c.call and
               p["attrs"]["generation"] == 2 for p in pauses)
    n = counters(snap, "gc.collections")
    assert n[(("generation", 0),)] >= 1 and n[(("generation", 2),)] == len(
        pauses)
    ns = counters(snap, "gc.ns")
    assert ns[(("generation", 2),)] >= sum(p["end"] - p["start"]
                                           for p in pauses) > 0
    call = next(s for s in snap["spans"] if s["name"] == "c")
    assert trace.self_ns(snap["spans"])[c.id] == \
        call["end"] - call["start"] - sum(p["end"] - p["start"]
                                          for p in pauses)


def test_counters_key_by_name_and_attributes():
    trace.enable()
    trace.count("x", 2, route="a")
    trace.count("x", 3, route="a")
    trace.count("x", route="b")
    trace.count("x", 4, route="a", refine=True)
    trace.count("y")
    snap = trace.snapshot()
    assert counters(snap, "x") == {(("route", "a"),): 5, (("route", "b"),): 1,
                                   (("refine", True), ("route", "a")): 4}
    assert counters(snap, "y") == {(): 1}
    trace.count("y", 10)
    assert counters(snap, "y") == {(): 1}        # a snapshot is a copy
    assert counters(trace.snapshot(), "y") == {(): 11}
    trace.disable()
    trace.count("y", 100)
    assert counters(trace.snapshot(), "y") == {(): 11}
    trace.reset()
    assert trace.snapshot()["counters"] == []


class FakeEvent:
    """A CUDA event at a fixed device time (ms)."""

    def __init__(self, t_ms):
        self.t_ms = t_ms

    def elapsed_time(self, other):
        return other.t_ms - self.t_ms

    def synchronize(self):
        pass


def test_launches_map_onto_the_host_clock_through_the_anchors(monkeypatch):
    """Device 0's first anchor event at 1,000 ms of its clock was seen done
    at host 5e9 ns, its second at 3,000 ms at host 7.00008e9 (the host's
    clock runs 40 ppm fast); device 1's at 20 and 1,020 ms, hosts 7e9 and
    8e9: each launch's events land at their distance from the first
    anchor, on their own device's clocks."""
    assert trace.to_host_ns(5_000_000_000, 1.5) == 5_001_500_000
    assert trace.to_host_ns(10, -0.000004) == 6
    assert trace.to_host_ns(0, 2.0, 1.5) == 3_000_000
    trace.enable()
    with trace.call("c") as c:
        with trace.span("consensus.device") as d:
            pass
    trace._S.anchors[0] = (FakeEvent(1000.0), 5_000_000_000)
    trace._S.anchors[1] = (FakeEvent(20.0), 7_000_000_000)
    ends = {0: (FakeEvent(3000.0), 7_000_080_000),
            1: (FakeEvent(1020.0), 8_000_000_000)}
    monkeypatch.setattr(trace, "_end_anchor", ends.get)
    trace._S.launches += [
        ("bandalign", d.id, 4_999_000_000, 0, FakeEvent(1000.25),
         FakeEvent(2000.0)),
        ("bandalign", 0, 6_000_000_000, 1, FakeEvent(21.0),
         FakeEvent(21.5))]
    snap = trace.snapshot()
    assert snap["clocks"] == {0: pytest.approx(1.00004, abs=1e-12), 1: 1.0}
    assert snap["launches"] == [
        {"name": "bandalign", "span": d.id, "device": 0,
         "enqueue": 4_999_000_000, "start": 5_000_250_010,
         "end": 6_000_040_000},
        {"name": "bandalign", "span": 0, "device": 1,
         "enqueue": 6_000_000_000, "start": 7_001_000_000,
         "end": 7_001_500_000}]
    assert c.call > 0


# ---------------------------------------------------------------------------
# Step 4b on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def routed_bam(tmp_path_factory):
    """Molecules of every route of an engine with max_center_len 512:
    four of one read and three of two (short), five of 4 reads of ~180 nt
    (device), one of 4 reads of ~200 nt with an N in a read (n), one of 3
    reads of 560 nt (long), and one of 3 reads of 400, 300 and 250 nt whose
    pairs the band filter drops, alone in the Lc 512 bucket (nopair)."""
    rng = np.random.default_rng(19)
    dev, _ = synth.molecule_set(rng, 5, 4, 0.05, 180)
    n_mol, _ = synth.molecule_set(rng, 1, 4, 0.05, 200)
    s = bytearray(n_mol[0][1])
    s[50] = ord("N")
    n_mol[0][1] = bytes(s)
    long_mol, _ = synth.molecule_set(rng, 1, 3, 0.0, 560)
    truth = synth.random_seq(rng, 400).encode()
    nopair = [[truth, truth[:300], truth[:250]]]
    two, _ = synth.molecule_set(rng, 3, 2, 0.05, 150)
    one, _ = synth.molecule_set(rng, 4, 1, 0.05, 120)
    mols = dev + n_mol + long_mol + nopair + two + one
    path = tmp_path_factory.mktemp("trace") / "tagged.bam"
    with BamWriter(path, HDR) as w:
        for r in synth.tagged_records(mols, rng):
            w.write(r)
    return path, len(mols)


def _run(bam, out, traced, engine=None):
    if traced:
        trace.enable()
    try:
        stats = compute_consensus(
            bam, out, engine=engine or poa_cuda.BatchedConsensusEngine(
                device="cpu", max_center_len=512),
            log_json=str(out) + ".log")
        snap = trace.snapshot()
    finally:
        trace.disable()
    return stats, snap


def test_cpu_consensus_routes_and_bytes(routed_bam, tmp_path, monkeypatch):
    """Traced: each route's counter is exact, the engine's spans are
    siblings under the call, and the fastq and .log are the untraced run's
    bytes. Untraced: no span object is built."""
    bam, n_mol = routed_bam
    stats, snap = _run(bam, tmp_path / "on.fastq", True)
    assert stats["molecules"] == stats["written"] == n_mol
    assert counters(snap, "consensus.molecules") == {
        (("route", "short"),): 7, (("route", "n"),): 1,
        (("route", "long"),): 1, (("route", "nopair"),): 1,
        (("route", "overflow"),): 0, (("route", "device"),): 5}
    assert counters(snap, "consensus.pairs_dropped") == {(): 2}
    assert sum(counters(snap, "consensus.h2d_bytes").values()) > 0
    assert sum(counters(snap, "consensus.d2h_bytes").values()) > 0
    spans = snap["spans"]
    (call,) = [s for s in spans if s["name"] == "consensus.call"]
    assert call["attrs"] == {"molecules": n_mol, "written": n_mol}
    assert all(s["call"] == call["call"] for s in spans if s["name"] != "gc")
    for name in ("consensus.parse", "consensus.group", "consensus.select",
                 "consensus.write", *ENGINE_CHILDREN):
        assert any(s["name"] == name and s["parent"] == call["id"]
                   for s in spans), name
    assert all(s["parent"] == call["id"] for s in spans
               if s["name"] in ENGINE_CHILDREN)
    host = {s["attrs"]["route"]: s["attrs"] for s in spans
            if s["name"] == "consensus.host"}
    assert host == {"short": {"route": "short", "molecules": 7, "reads": 10},
                    "n": {"route": "n", "molecules": 1, "reads": 4},
                    "long": {"route": "long", "molecules": 1, "reads": 3},
                    "nopair": {"route": "nopair", "molecules": 1,
                               "reads": 3}}
    parse = next(s for s in spans if s["name"] == "consensus.parse")
    assert parse["attrs"]["total_records"] == stats["total_records"]
    assert parse["attrs"]["valid_records"] == stats["valid_records"]
    inflate = [s for s in spans if s["name"] == "bam.inflate"]
    assert inflate and all(s["parent"] == parse["id"] for s in inflate)
    assert sum(c["value"] for c in snap["counters"]
               if c["name"] == "bam.inflate") > 0
    write = next(s for s in spans if s["name"] == "consensus.write")
    out = (tmp_path / "on.fastq").read_bytes()
    assert write["attrs"] == {"records": n_mol, "bytes": len(out)}
    assert snap["launches"] == []                 # no card on the CPU

    trace.reset()
    monkeypatch.setattr(trace, "Span", None)
    stats_off, snap_off = _run(bam, tmp_path / "off.fastq", False)
    assert stats_off == stats
    assert snap_off == {"spans": [], "counters": [], "launches": [],
                        "clocks": {}}
    assert (tmp_path / "off.fastq").read_bytes() == out
    assert (tmp_path / "off.fastq.log").read_bytes() == \
        (tmp_path / "on.fastq.log").read_bytes()


@pytest.mark.parametrize("refine", [False, True])
def test_cpu_consensus_host_engine_and_refine(routed_bam, tmp_path, refine):
    """The host engine asked for is one `consensus.host` span of route
    "asked"; the refine pass counts its molecules under `refine`; both
    write the untraced bytes."""
    import functools

    bam, n_mol = routed_bam
    if refine:
        def engine():
            return functools.partial(poa_cuda.BatchedConsensusEngine(
                device="cpu", max_center_len=512), refine=True)
    else:
        def engine():
            return "host"
    _, snap = _run(bam, tmp_path / "on.fastq", True, engine())
    _run(bam, tmp_path / "off.fastq", False, engine())
    assert (tmp_path / "on.fastq").read_bytes() == \
        (tmp_path / "off.fastq").read_bytes()
    host = [s["attrs"] for s in snap["spans"]
            if s["name"] == "consensus.host"]
    if not refine:
        assert host == [{"route": "asked", "molecules": n_mol,
                         "reads": 5 * 4 + 4 + 3 + 3 + 3 * 2 + 4}]
        return
    second = {c["attrs"]["route"]: c["value"] for c in snap["counters"]
              if c["name"] == "consensus.molecules" and c["attrs"].get(
                  "refine")}
    assert second["short"] == 0 and second["device"] >= 5


# ---------------------------------------------------------------------------
# the benchmark's traced run and the operator's export
# ---------------------------------------------------------------------------

NEW_METRICS = ("consensus.host_n_ms_per_kumi",
               "consensus.host_long_ms_per_kumi",
               "consensus.device_route_pct", "consensus.pack_ms_per_kumi",
               "consensus.wait_ms_per_kumi", "consensus.inflate_ms_per_kumi")


def test_benchmark_traced_run_reads_the_program_spans():
    """A `--trace 1` run of each consensus cell, shrunk for the CPU,
    reports the six metrics that read the program's trace beside the
    harness's own, and leaves the tracer off. In a fresh process: the
    harness refuses to run where jax is loaded (tests/conftest.py)."""
    code = (
        "import json\n"
        "from benchmark.harness import cell\n"
        "from sicelore_tpu_torch.utils import trace\n"
        "SMALL = {'tenx3p_v3.consensus_wta': {'mix': {'molecules': 160}},\n"
        "         'tenx3p_v3.consensus_deep': {'mix': {'molecules': 48}}}\n"
        "out = {}\n"
        "for w, o in SMALL.items():\n"
        "    r = cell.run_cell(w, 2**32 + 19, 0.01, True, device='cpu',\n"
        "                      overrides=o, log=lambda *a, **k: None)\n"
        "    out[w] = {'correct': r['correct'], 'metrics': r['metrics'],\n"
        "              'on': trace.ON}\n"
        "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for w, res in out.items():
        m = res["metrics"]
        assert res["correct"] and not res["on"], w
        for name in NEW_METRICS + ("consensus.host_engine_ms_per_kumi",
                                   "consensus.engine_self_ms_per_kumi",
                                   "consensus.parse_ms_per_kumi"):
            assert name in m, (w, name)
        assert 0 < m["consensus.device_route_pct"]["value"] <= 100, w
        assert m["consensus.device_route_pct"]["unit"] == "%"
        assert m["consensus.host_long_ms_per_kumi"]["value"] > 0, w
        assert m["consensus.pack_ms_per_kumi"]["value"] > 0, w
        assert m["consensus.inflate_ms_per_kumi"]["value"] > 0, w


def test_cli_trace_writes_chrome_trace_events(routed_bam, tmp_path):
    bam, n_mol = routed_bam
    out, tr = tmp_path / "cli.fastq", tmp_path / "trace.json"
    r = subprocess.run(
        [sys.executable, "-m", "sicelore_tpu_torch", "computeconsensus",
         "-I", str(bam), "-O", str(out), "--device", "cpu", "--trace",
         str(tr)], capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    assert f"computeconsensus done: {n_mol}/{n_mol} molecules" in r.stdout
    events = json.loads(tr.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"consensus.call", "consensus.parse", "consensus.host",
            "consensus.device", "consensus.write"} <= names
    (call,) = [e for e in events if e["name"] == "consensus.call"]
    assert call["tid"] == 1 and call["ts"] >= 0 and call["dur"] > 0
    c = {e["name"]: e["args"] for e in events if e["ph"] == "C"}
    assert c["consensus.molecules"]["route=short"] == 7
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {
        "host spans", "device launches"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_launches_sit_inside_their_spans_on_the_card(tmp_path):
    """Every bandalign launch starts on the host's clock after its enqueue
    instant, inside its `consensus.call`, and ends before the end of the
    first `consensus.wait` that opens after it (its sub-batch's); the
    fastq and .log are the untraced run's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the band kernel has no CPU mode)")
    rng = np.random.default_rng(23)
    mols = []
    for depth, length, n in ((4, 450, 120), (6, 800, 60), (3, 1500, 8)):
        mols += synth.molecule_set(rng, n, depth, 0.03, length)[0]
    mols += synth.molecule_set(rng, 40, 1, 0.03, 500)[0]
    bam = tmp_path / "card.bam"
    with BamWriter(bam, HDR) as w:
        for r in synth.tagged_records(mols, rng):
            w.write(r)
    outs = {}
    for traced in (False, True, False):
        out = tmp_path / f"cuda_{len(outs)}.fastq"
        if traced:
            trace.enable()
        try:
            compute_consensus(bam, out, device="cuda",
                              log_json=str(out) + ".log")
            snap = trace.snapshot() if traced else None
        finally:
            trace.disable()
        outs[traced] = (out.read_bytes(),
                        Path(str(out) + ".log").read_bytes())
        if traced:
            tsnap = snap
    assert outs[True] == outs[False]
    spans = tsnap["spans"]
    (call,) = [s for s in spans if s["name"] == "consensus.call"]
    waits = sorted((s for s in spans if s["name"] == "consensus.wait"),
                   key=lambda s: s["start"])
    by_id = {s["id"]: s for s in spans}
    launches = [x for x in tsnap["launches"] if x["name"] == "bandalign"]
    assert len(launches) >= 3
    for x in launches:
        assert x["enqueue"] <= x["start"] <= x["end"]
        assert call["start"] <= x["enqueue"] and x["end"] <= call["end"]
        assert by_id[x["span"]]["name"] == "consensus.device"
        wait = next(w for w in waits if w["start"] >= x["enqueue"])
        assert x["end"] <= wait["end"], (x, wait)
