"""One run of one cell: set up, measure for a number of seconds, judge the
outputs by the plain reference, and report.

Everything that belongs to one configuration, traffic mix, entry point or
per-layer metric is a file of its own, found by name:

  BENCHMARK.json                  the cells and the metrics
  benchmark/configs/<config>.json the deployment's settings
  benchmark/traffic/<mix>.json    the mix, the driver it takes, the limits
  benchmark/drivers/<driver>.py   set-up, one call, the control's call, and
                                  the numbers the reference reads off a call
  benchmark/metrics/<metric>.py   the spans it reads and its arithmetic
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "sicelore_tpu")


def process_start() -> float:
    """The epoch second this process started (Linux /proc)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as fh:
        btime = next(int(ln.split()[1]) for ln in fh
                     if ln.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def apply_fields(obj, d: dict):
    """Set a dataclass's fields (nested ones recursively) from a dict."""
    for k, v in d.items():
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur):
            apply_fields(cur, v)
        else:
            setattr(obj, k, tuple(v) if isinstance(cur, tuple) else v)
    return obj


@dataclass
class Cell:
    """What a driver is given: the cell's settings and a place to work."""
    name: str
    config: dict
    mix: dict
    seed: int
    workdir: Path
    device: str
    setup_parts: dict = field(default_factory=dict)


def with_pending(bench: dict, workload: str) -> dict:
    """BENCHMARK.json, with the entries of a cell that waits in
    pending/<workload>.json added when BENCHMARK.json does not name it, so
    that the cell runs as it will once they are moved there."""
    if any(w["name"] == workload for w in bench["workloads"]):
        return bench
    f = BENCH / "pending" / f"{workload}.json"
    if not f.is_file():
        return bench
    extra = load_json(f)
    return {**bench, **{k: bench[k] + [e for e in v if e["name"] not in
                                       {x["name"] for x in bench[k]}]
                        for k, v in extra.items()}}


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_cell(bench: dict, workload: str, overrides: dict | None = None):
    """(workload entry, config, traffic, driver module) of a cell; the
    traffic file holds the driver's name, the mix and the limits of the
    numbers `correct` compares."""
    wl = find_workload(bench, workload)
    config = load_json(BENCH / "configs" / f"{wl['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, "mix": {**traffic["mix"],
                                      **overrides.get("mix", {})}}
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return wl, config, traffic, driver


def digest(out: Path) -> str:
    """sha256 over the names and bytes of every file under out."""
    h = hashlib.sha256()
    for f in sorted(out.rglob("*")):
        if f.is_file():
            h.update(str(f.relative_to(out)).encode() + b"\0")
            with open(f, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    h.update(block)
    return h.hexdigest()


def check(driver, state, outs, limits: dict) -> tuple[dict, int]:
    """Each call's outputs judged by the plain reference (calls that wrote
    the same bytes once): ({number: (worst value over the calls, limit)},
    calls with a number over its limit)."""
    by_digest: dict = {}
    worst: dict = {}
    failed = 0
    for out in outs:
        d = digest(out)
        if d not in by_digest:
            by_digest[d] = driver.judge(state, out)
        nums = by_digest[d]
        if set(nums) != set(limits):
            raise SystemExit(f"numbers {sorted(nums)} against limits "
                             f"{sorted(limits)}")
        failed += any(v > limits[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return {k: (worst[k], limits[k]) for k in limits}, failed


def cell_metrics(bench: dict, workload: str, per_layer: bool) -> list[dict]:
    """The metrics a run of the cell reports."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def busy_union(kernels) -> tuple[float, list]:
    """Seconds covered by the kernels' intervals, and the gaps between the
    merged intervals [(start, end)]."""
    spans = sorted((a, b) for _, a, b, _ in kernels)
    busy, gaps, cur = 0.0, [], None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


@dataclass
class TraceRun:
    """What a per-layer metric reads."""
    units: int
    calls: int
    window_s: float
    span_s: dict
    kernels: list           # (name, start s, end s, work dict or None)
    busy_s: float


def breakdown(tr: TraceRun, gaps, intervals, t0) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost span open on the host at its middle
    (host and device clocks aligned at the window's start)."""
    by_op: dict[str, float] = {}
    for name, a, b, _ in tr.kernels:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for a, b in longest:
        mid = t0 + (a + b) / 2
        open_ = [(e - s, tgt) for tgt, s, e in intervals if s <= mid <= e]
        label = min(open_)[1].split(":")[-1] if open_ else "no span open"
        idle.append([label, b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             bench: dict | None = None, overrides: dict | None = None,
             log=print) -> dict:
    """One run of the cell; returns the result line as a dict. `overrides`
    ({"config": {...}, "mix": {...}}) shrinks a cell for the CPU tests."""
    t_start = time.time() if t_start is None else t_start
    bench = with_pending(bench or load_json(ROOT / "BENCHMARK.json"),
                         workload)
    wl, config, traffic, driver = load_cell(bench, workload, overrides)
    metrics = cell_metrics(bench, workload, trace)
    import torch
    parts = {"import_s": time.time() - t_start}
    cuda = device.startswith("cuda")
    if cuda:
        t = time.time()
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats()
        parts["cuda_context_s"] = time.time() - t
    tmp = Path(tempfile.mkdtemp(prefix=f"bench-{workload}-",
                                dir=os.environ.get("TMPDIR")))
    try:
        cell = Cell(workload, config, traffic["mix"], seed, tmp, device,
                    parts)
        state = driver.setup(cell)
        t = time.time()
        driver.call(state, tmp / "warmup")
        if cuda:
            torch.cuda.synchronize()
        parts["warmup_s"] = time.time() - t
        shutil.rmtree(tmp / "warmup")
        # the inputs on disk before the window: their writeback does not
        # land inside it
        t = time.time()
        os.sync()
        parts["sync_s"] = time.time() - t
        from sicelore_tpu_torch.ops import _build
        parts["kernel_build_s"] = _build.build_seconds
        tracer = None
        if trace:
            from benchmark.harness import trace as tr_mod
            from benchmark.harness import work as work_mod
            tracer = tr_mod.Tracer()
            readers = {m["name"]: load_file_module(
                BENCH / "metrics" / f"{m['name']}.py",
                "benchmark_metric_" + m["name"].replace(".", "__"))
                for m in metrics}
            targets = sorted({t for r in readers.values()
                              for t in getattr(r, "SPANS", ())}
                             | set(getattr(driver, "LABELS", ())))
            for t in targets:
                tracer.span(t)
            for kernel, (target, fn) in work_mod.WORK.items():
                tracer.work(target, kernel, fn)
            if cuda:
                tracer.hook_launches()
        if cuda:
            torch.cuda.synchronize()
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        outs, units, call_s = [], 0, []
        while not outs or time.perf_counter() - t0 < seconds:
            out = tmp / f"call{len(outs)}"
            t = time.perf_counter()
            units += driver.call(state, out)
            call_s.append(time.perf_counter() - t)
            outs.append(out)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if tracer:
            tracer.remove()
        found = forbidden_modules()
        if found:
            raise SystemExit(f"loaded after the window: {', '.join(found)}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        result = {"correct": False, "attempted": len(outs), "failed": 0,
                  "metrics": {}, "device": {
                      "platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": wl["chips"], "memory_peak_bytes": int(peak)}}
        log(json.dumps({"setup_parts": parts, "setup_s": setup_s,
                        "window_s": window_s, "calls": len(outs),
                        "call_s": call_s, "units": units}), file=sys.stderr)
        if trace:
            kernels = tracer.kernels() if cuda else []
            busy, gaps = busy_union(kernels)
            run = TraceRun(units, len(outs), window_s, dict(tracer.span_s),
                           kernels, busy)
            for m in metrics:
                v = readers[m["name"]].read(run)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v),
                                                    "unit": m["unit"]}
            result["device"]["busy_s"] = busy
            result["device"]["window_s"] = window_s
            result["breakdown"] = breakdown(run, gaps, tracer.intervals,
                                            tracer.t0)
        else:
            rate = units / window_s
            for m in metrics:
                v = {"setup_s": setup_s}.get(m["name"], rate)
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if cuda:        # the calls' state is gone: only the cache is left
            torch.cuda.empty_cache()
        t = time.time()
        checks, failed = check(driver, state, outs, traffic["limits"])
        log(json.dumps({"check_s": time.time() - t}), file=sys.stderr)
        result["failed"] = failed
        result["correct"] = failed == 0 and all(
            v <= lim for v, lim in checks.values())
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        for k, (v, lim) in checks.items():
            log(f"check {k}: {v} (limit {lim})", file=sys.stderr)
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
