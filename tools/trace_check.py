"""Checks of the program's Step 4b tracer (`sicelore_tpu_torch/utils/trace.py`)
on the card, from the root of a checkout:

    python3 tools/trace_check.py agree --workload tenx3p_v3.consensus_wta \\
        --seeds 11 12 --seconds 51
    python3 tools/trace_check.py cost --seed 11 --runs 10 \\
        [--workload tenx3p_v3_tagbam.consensus_wta_tagbam]

(`--device cpu --molecules N` rehearses either on the CPU at a small size;
its times are the CPU's.)

`agree`: a `--trace 1` run of the benchmark's cell a seed, in process
(`benchmark/harness/cell.run_cell`), with the program's snapshot that its
metrics read: the program's `consensus.host` spans of the routes that call
the host engine (`short`, `asked`) against the harness's host-engine hook
(`poa.consensus_reads`), the engine's sibling spans with the
`consensus.host` spans of the routes whose alignments run on the card
(`n`, `long`, `nopair`, `overflow`: no hook sees them) against the
harness's engine self (each also with the collector's full pauses inside
the host spans set apart, which fall between the hook's intervals), the
route counters against the molecules the generator made (after the
MAXREADS selection), each host route's and engine span's ms per 1,000
molecules, the host-alignment pairs by route and where they ran, and
where every launch lies among the spans (a band-kernel launch before its
sub-batch's `consensus.wait` ends, a host-alignment launch inside its
`hostnw.align` span), the long route's spans (`hostnw.align`, `hostnw.rows`)
inside their route's `consensus.host` span, its counters (`hostnw.pairs`,
`.band_cells`, `.move_bytes`) and the buckets' (`consensus.pairs` by `Lc`)
against the pair tables the generator's molecules give (the host counts
where no molecule took the `nopair` or `overflow` route, which add pairs
the generator cannot tell), each bucket's engine ms and band launches, the
`hostnw` launches a call, their device ms and the rest of `hostnw.align`
(the pack, upload and the downloads' waits), and the parse's phases (counter
`consensus.parse_ns`: `decode`, `build`) beside its span, whose time they
may not pass, with its counts (SEQ bases, SEQ bases spelled out, CIGAR
ops, each kept cDNA's source, each drop's reason), and the collector: its
ms a kUMI by generation, the holds a call (`gc.held`) and the tracked
objects a hold left (`gc.held_objects`), and by generation the
collections that started inside a `consensus.call` span (none while each
call holds the collector off), timed by a callback of this tool's own.
One JSON line a run.

`cost`: a consensus cell's inputs (wta's unless `--workload` names
another) through `compute_consensus` with the tracer off and on in turns
(off first), after one warm-up call: each side's median and quartiles of
the call's seconds, the spans and launch records a traced call makes, the
parse's phases, and whether both wrote the same bytes. With `--parse` it
times the BAM parse alone (`LongreadParser` as `compute_consensus` runs
it), which holds every check the tracer makes a record, after a full
collection each: each side's seconds and least, the quartiles of each
pair's difference (on - off) as a share of the off side's median and in ns
a record, and the ns of the clock read that the tracer makes three times a
record. One JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ENGINE = ("consensus.route", "consensus.pack", "consensus.upload",
          "consensus.device", "consensus.wait", "consensus.decode")
HOOKED = ("short", "asked")     # host routes that call poa.consensus_reads


def expected_routes(mols, maxreads: int, max_center_len: int = 2048) -> dict:
    """Molecules of 3+ selected reads by the host route the engine's screen
    gives them: `long` (a center over max_center_len) before `n`."""
    out = {"long": 0, "n": 0, "deep": 0}
    for reads, des in zip(mols.reads, mols.des):
        sel = [reads[i] for i in sorted(range(len(reads)),
                                        key=lambda i: des[i])[:maxreads]]
        if len(sel) <= 2:
            continue
        out["deep"] += 1
        if max(map(len, sel)) > max_center_len:
            out["long"] += 1
        elif any(s.translate(None, b"ACGTacgt") for s in sel):
            out["n"] += 1
    return out


def band_cells(la: int, lb: int) -> int:
    """The cells the host's `nw_align_banded` fills for a center of la and
    a read of lb: la rows of min(2 band + 1, lb), band max(32, |la - lb| +
    max(la, lb) // 10)."""
    band = max(32, abs(la - lb) + max(la, lb) // 10)
    return la * min(2 * band + 1, lb)


def expected_pairs(mols, maxreads: int, max_center_len: int = 2048):
    """What the pair tables of the molecules give, by the engine's rules:
    ({Lc: pairs a bucket sends to the device}, {"pairs", "band_cells",
    "move_bytes"} of the long and N routes' pairs; each molecule's center
    its first longest selected read)."""
    buckets: dict = {}
    host = {"pairs": 0, "band_cells": 0, "move_bytes": 0}
    for reads, des in zip(mols.reads, mols.des):
        sel = [reads[i] for i in sorted(range(len(reads)),
                                        key=lambda i: des[i])[:maxreads]]
        sel = [s for s in sel if s]
        if len(sel) <= 2:
            continue
        c = max(range(len(sel)), key=lambda i: len(sel[i]))
        la = len(sel[c])
        lbs = [len(s) for i, s in enumerate(sel) if i != c]
        if la > max_center_len or any(s.translate(None, b"ACGTacgt")
                                      for s in sel):
            for lb in lbs:
                host["pairs"] += 1
                host["band_cells"] += band_cells(la, lb)
                host["move_bytes"] += la + lb
            continue
        Lc = max(256, 1 << (la - 1).bit_length())
        W = 32 if Lc <= 512 else 64
        buckets[Lc] = buckets.get(Lc, 0) + sum(abs(lb - la) < W // 2 - 4
                                               for lb in lbs)
    return buckets, host


def bucket_of(snap) -> dict:
    """{span id: Lc} of the engine's spans: each from the bucket whose
    `consensus.pack` span (the one with an `Lc`) opened last before it in
    its call."""
    out, cur = {}, {}
    for s in snap["spans"]:
        if s["name"] == "consensus.pack" and "Lc" in s["attrs"]:
            cur[s["call"]] = s["attrs"]["Lc"]
        elif s["name"] in ENGINE and s["call"] in cur:
            out[s["id"]] = cur[s["call"]]
    return out


def ratio(a: float, b: float) -> float | None:
    """a / b; None where b is 0 (a cell with no 1-2-read molecule gives
    the host-engine hook nothing to time)."""
    return a / b if b else None


def quartiles(xs) -> list[float]:
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return [q1, q2, q3]


def parse_phases(snap) -> dict:
    """{phase: ns} of the parse's `consensus.parse_ns` counter."""
    out: dict = {}
    for c in snap["counters"]:
        if c["name"] == "consensus.parse_ns":
            out[c["attrs"]["phase"]] = out.get(c["attrs"]["phase"], 0) \
                + c["value"]
    return out


def parse_counters(snap) -> dict:
    """The parse's counts, keyed `name` or `name.attribute value`: the SEQ
    bases of the records decoded and those spelled out (`bam.seq_decoded`,
    0 where no record's `seq` was read), the CIGAR ops, each kept cDNA's
    source, each drop's reason."""
    out: dict = {"bam.seq_bases": 0, "bam.seq_decoded": 0}
    for c in snap["counters"]:
        if c["name"] in ("bam.seq_bases", "bam.seq_decoded", "bam.cigar_ops",
                         "consensus.cdna", "consensus.records_dropped"):
            key = ".".join([c["name"], *map(str, c["attrs"].values())])
            out[key] = out.get(key, 0) + c["value"]
    return out


def agree(args) -> None:
    from benchmark.gen import molecules as gen
    from benchmark.harness import cell
    from benchmark.metrics import _program
    from sicelore_tpu_torch.utils import trace
    bench = cell.load_json(ROOT / "BENCHMARK.json")
    over = {"mix": {"molecules": args.molecules}} if args.molecules else None
    _, config, traffic, drv = cell.load_cell(bench, args.workload, over)
    make = getattr(drv, "make_molecules", gen.make_molecules)
    for seed in args.seeds:
        starts = []         # (host ns, generation) of every collection

        def on_gc(phase, info):
            if phase == "start":
                starts.append((time.perf_counter_ns(), info["generation"]))
        gc.callbacks.append(on_gc)
        try:
            r = cell.run_cell(args.workload, seed, args.seconds, True,
                              args.device, bench=bench, overrides=over,
                              log=lambda *a, **k: None)
        finally:
            gc.callbacks.remove(on_gc)
        snap = _program._taken[1]
        m = {k: v["value"] for k, v in r["metrics"].items()}
        calls = [s for s in snap["spans"] if s["name"] == "consensus.call"]
        units = sum(s["attrs"]["molecules"] for s in calls)
        per_k = {}
        for s in snap["spans"]:
            key = s["name"] + ("." + s["attrs"]["route"]
                               if s["name"] == "consensus.host" else "")
            per_k[key] = per_k.get(key, 0.0) + (s["end"] - s["start"]) / 1e6
        per_k = {k: v * 1000 / units for k, v in sorted(per_k.items())}
        host = sum(per_k.get("consensus.host." + r, 0.0) for r in HOOKED)
        aligned = sum(v for k, v in per_k.items()
                      if k.startswith("consensus.host.")
                      and k.split(".")[-1] not in HOOKED)
        engine = sum(per_k.get(k, 0.0) for k in ENGINE) + aligned
        pairs: dict = {}
        for c in snap["counters"]:
            if c["name"] == "consensus.host_pairs":
                key = c["attrs"]["route"] + "." + c["attrs"]["where"]
                pairs[key] = pairs.get(key, 0) + c["value"]
        routes: dict = {}
        for c in snap["counters"]:
            if c["name"] == "consensus.molecules":
                routes[c["attrs"]["route"]] = routes.get(
                    c["attrs"]["route"], 0) + c["value"]
        mols = make(np.random.default_rng(seed), traffic["mix"])
        want = expected_routes(mols, config["consensus"]["maxreads"])
        want_lc, want_host = expected_pairs(mols,
                                            config["consensus"]["maxreads"])
        counted: dict = {}
        for c in snap["counters"]:
            if c["name"] == "consensus.pairs" and "refine" not in c["attrs"]:
                counted[c["attrs"]["Lc"]] = counted.get(c["attrs"]["Lc"],
                                                        0) + c["value"]
            elif c["name"].startswith("hostnw."):
                k = c["name"].split(".", 1)[1]
                counted[k] = counted.get(k, 0) + c["value"]
        n_calls = len(calls)
        host_exact = not routes.get("nopair") and not routes.get("overflow")
        pair_tables = {
            "by_lc": all(counted.get(lc, 0) == v * n_calls
                         for lc, v in want_lc.items())
            and {k for k in counted if isinstance(k, int)} <= set(want_lc),
            "host": all(counted.get(k, 0) == v * n_calls
                        for k, v in want_host.items()) if host_exact
            else None}
        by_id = {s["id"]: s for s in snap["spans"]}
        waits = sorted((s for s in snap["spans"]
                        if s["name"] == "consensus.wait"),
                       key=lambda s: s["start"])
        bad = 0
        for x in snap["launches"]:
            span = by_id[x["span"]]
            call = next(c for c in calls if c["call"] == span["call"])
            end = span["end"] if x["name"] == "hostnw" else next(
                w for w in waits if w["start"] >= x["enqueue"])["end"]
            bad += not (x["enqueue"] <= x["start"] <= x["end"] <= end
                        and call["start"] <= x["enqueue"]
                        and x["end"] <= call["end"])
        # the collector's full pauses (`gc` spans) inside each span
        gc_ms: dict = {}
        by_key = {s["id"]: s["name"] + ("." + s["attrs"]["route"]
                                        if s["name"] == "consensus.host"
                                        else "") for s in snap["spans"]}
        for p in snap["spans"]:
            if p["name"] == "gc" and p["parent"]:
                k = by_key[p["parent"]]
                gc_ms[k] = gc_ms.get(k, 0.0) + (p["end"] - p["start"]) \
                    / 1e6 * 1000 / units
        own = trace.self_ns(snap["spans"])
        host_self = sum(own[s["id"]] for s in snap["spans"]
                        if s["name"] == "consensus.host"
                        and s["attrs"]["route"] in HOOKED) / 1e6 * 1000 / units
        gc_host = host - host_self
        gc_counts = {c["attrs"]["generation"]: c["value"]
                     for c in snap["counters"] if c["name"] == "gc.ns"}
        held = {c["name"]: c["value"] for c in snap["counters"]
                if c["name"] in ("gc.held", "gc.held_objects")}
        in_calls: dict = {}
        for t, g in starts:
            if any(c["start"] <= t <= c["end"] for c in calls):
                in_calls[g] = in_calls.get(g, 0) + 1
        outside = 0
        for sp in snap["spans"]:
            if sp["name"] in ("hostnw.align", "hostnw.rows"):
                host_sp = by_id.get(sp["parent"])
                outside += not (
                    host_sp is not None and host_sp["name"] == "consensus.host"
                    and host_sp["start"] <= sp["start"] <= sp["end"]
                    <= host_sp["end"])
        lc_of = bucket_of(snap)
        lc_ms: dict = {}
        for sp in snap["spans"]:
            if sp["id"] in lc_of:
                k = f"{lc_of[sp['id']]}.{sp['name'].split('.')[-1]}"
                lc_ms[k] = lc_ms.get(k, 0.0) + (sp["end"] - sp["start"]) \
                    / 1e6 * 1000 / units
        band_by_lc: dict = {}
        hostnw_ms = 0.0
        for x in snap["launches"]:
            ms = (x["end"] - x["start"]) / 1e6
            if x["name"] == "hostnw":
                hostnw_ms += ms
            elif x["span"] in lc_of:
                k = lc_of[x["span"]]
                n0, t0 = band_by_lc.get(k, (0, 0.0))
                band_by_lc[k] = (n0 + 1, t0 + ms)
        align_ms = sum(sp["end"] - sp["start"] for sp in snap["spans"]
                       if sp["name"] == "hostnw.align") / 1e6
        t_first = min(x["enqueue"] for x in snap["launches"]) \
            if snap["launches"] else 0
        detail = []
        for x in snap["launches"]:
            end = by_id[x["span"]]["end"] if x["name"] == "hostnw" else next(
                w for w in waits if w["start"] >= x["enqueue"])["end"]
            detail.append([x["name"], round((x["enqueue"] - t_first) / 1e9, 3),
                           (x["start"] - x["enqueue"]) / 1e3,
                           (x["end"] - x["start"]) / 1e3,
                           (end - x["end"]) / 1e3])
        parse_ms = sum(s["end"] - s["start"] for s in snap["spans"]
                       if s["name"] == "consensus.parse") / 1e6
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": r["correct"], "calls": len(calls), "units": units,
            "host_spans_ms_per_kumi": host,
            "host_engine_ms_per_kumi": m.get(
                "consensus.host_engine_ms_per_kumi"),
            "host_ratio": ratio(host, m["consensus.host_engine_ms_per_kumi"]),
            "engine_spans_ms_per_kumi": engine,
            "engine_self_ms_per_kumi": m.get(
                "consensus.engine_self_ms_per_kumi"),
            "engine_ratio": ratio(engine,
                                  m["consensus.engine_self_ms_per_kumi"]),
            "routes_per_call": {k: v / len(calls) for k, v in
                                sorted(routes.items())},
            "generator_per_call": want,
            "host_pairs_per_call": {k: v / len(calls) for k, v in
                                    sorted(pairs.items())},
            "launches": len(snap["launches"]), "launches_outside": bad,
            "hostnw_spans_outside_route": outside,
            "pair_tables_agree": pair_tables,
            "pairs_per_call": {str(k): v / n_calls
                               for k, v in sorted(counted.items(),
                                                  key=lambda kv: str(kv[0]))},
            "pairs_per_call_generator": {
                **{str(k): v for k, v in sorted(want_lc.items())},
                **want_host},
            "bucket_ms_per_kumi": dict(sorted(lc_ms.items())),
            "band_launches_per_call_ms_by_lc": {
                str(k): [n / n_calls, t / n_calls]
                for k, (n, t) in sorted(band_by_lc.items())},
            "hostnw_launches_per_call": sum(
                x["name"] == "hostnw" for x in snap["launches"]) / n_calls,
            "hostnw_device_ms_per_kumi": hostnw_ms * 1000 / units,
            "hostnw_align_rest_ms_per_kumi": (align_ms - hostnw_ms) * 1000
            / units,
            "spans_per_call": len(snap["spans"]) / len(calls),
            "span_ms_per_kumi": per_k, "metrics": m,
            "host_less_gc_ratio": ratio(
                host_self, m["consensus.host_engine_ms_per_kumi"]),
            "engine_and_host_gc_ratio": ratio(
                engine + gc_host, m["consensus.engine_self_ms_per_kumi"]),
            "gc_full_ms_per_kumi_by_parent": gc_ms,
            "gc_ms_per_kumi_by_generation": {
                g: ns / 1e6 * 1000 / units for g, ns in gc_counts.items()},
            "gc_held_per_call": held.get("gc.held", 0) / len(calls),
            "gc_held_objects_per_call": held.get("gc.held_objects", 0)
            / len(calls),
            "gc_collections_inside_calls": in_calls,
            "parse_phases_ms_per_kumi": {
                **{ph: ns / 1e6 * 1000 / units
                   for ph, ns in parse_phases(snap).items()},
                "parse_span": parse_ms * 1000 / units},
            "phases_within_parse": sum(parse_phases(snap).values()) / 1e6
            <= parse_ms,
            "parse_counters_per_call": {
                k: v / len(calls) for k, v in parse_counters(snap).items()},
            "clocks": snap["clocks"],
            "launch_name_s_startlag_us_dur_us_margin_us": detail,
            "device": r["device"]}), flush=True)


def cost(args) -> None:
    import torch

    from benchmark.harness import cell
    from sicelore_tpu_torch.core.longread import LongreadParser
    from sicelore_tpu_torch.pipeline.consensus import compute_consensus
    from sicelore_tpu_torch.utils import trace
    bench = cell.load_json(ROOT / "BENCHMARK.json")
    over = {"mix": {"molecules": args.molecules}} if args.molecules else None
    _, config, traffic, drv = cell.load_cell(bench, args.workload, over)
    if args.parse:
        return cost_parse(args, cell, config, traffic, drv, LongreadParser,
                          trace)
    c = config["consensus"]
    cuda = args.device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bam = drv.setup(cell.Cell(args.workload, config, traffic["mix"],
                                  args.seed, tmp, args.device)).bam

        def one(out, traced):
            if traced:
                trace.enable()
            t = time.perf_counter()
            try:
                compute_consensus(bam, out,
                                  maxreads=c["maxreads"], minps=c["minps"],
                                  maxps=c["maxps"], device=args.device,
                                  log_json=str(out) + ".log")
                if cuda:
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t
                snap = trace.snapshot() if traced else None
            finally:
                trace.disable()
                trace.reset()
            return dt, snap

        one(tmp / "warm.fastq", False)
        secs = {False: [], True: []}
        made = None
        for i in range(2 * args.runs):
            traced = bool(i % 2)
            dt, snap = one(tmp / f"{int(traced)}.fastq", traced)
            secs[traced].append(dt)
            made = snap or made
        same = all((tmp / f"0{x}").read_bytes() == (tmp / f"1{x}").read_bytes()
                   for x in (".fastq", ".fastq.log"))
    off, on = quartiles(secs[False]), quartiles(secs[True])
    print(json.dumps({
        "workload": args.workload, "off_s": secs[False], "on_s": secs[True],
        "off_quartiles": off,
        "on_quartiles": on, "on_cost_pct": 100 * (on[1] / off[1] - 1),
        "spans_per_call": len(made["spans"]),
        "launch_records_per_call": len(made["launches"]),
        "counters": len(made["counters"]),
        "parse_phases_s": {k: v / 1e9 for k, v in parse_phases(made).items()},
        "same_bytes": same,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu"}),
        flush=True)


def cost_parse(args, cell, config, traffic, drv, parser, trace) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        bam = drv.setup(cell.Cell(args.workload, config, traffic["mix"],
                                  args.seed, Path(tmp), args.device)).bam

        def one(traced):
            gc.collect()
            if traced:
                trace.enable()
            t = time.perf_counter()
            try:
                p = parser(bam, keep_mapqv0=False, load_sequence=True,
                           gene_mandatory=False, umi_mandatory=True)
                return time.perf_counter() - t, p.stats.total_records
            finally:
                trace.disable()
                trace.reset()

        one(False)
        secs = {False: [], True: []}
        for i in range(2 * args.runs):
            dt, records = one(bool(i % 2))
            secs[bool(i % 2)].append(dt)
    clock = time.perf_counter_ns
    n = 1_000_000
    t = clock()
    for _ in range(n):
        clock()
    clock_ns = (clock() - t) / n
    off = quartiles(secs[False])
    diff = quartiles([b - a for a, b in zip(secs[False], secs[True])])
    print(json.dumps({
        "workload": args.workload, "parse": True, "records": records,
        "off_s": secs[False], "on_s": secs[True], "off_quartiles": off,
        "on_quartiles": quartiles(secs[True]),
        "off_least_s": min(secs[False]), "on_least_s": min(secs[True]),
        "diff_pct_quartiles": [100 * d / off[1] for d in diff],
        "diff_ns_per_record_quartiles": [1e9 * d / records for d in diff],
        "clock_read_ns": clock_ns}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("agree")
    a.add_argument("--workload", required=True)
    a.add_argument("--seeds", type=int, nargs="+", required=True)
    a.add_argument("--seconds", type=float, default=51)
    c = sub.add_parser("cost")
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--runs", type=int, default=10)
    c.add_argument("--workload", default="tenx3p_v3.consensus_wta")
    c.add_argument("--parse", action="store_true")
    for p in (a, c):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        p.add_argument("--molecules", type=int, default=None)
    args = ap.parse_args(argv)
    {"agree": agree, "cost": cost}[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
