"""Per-layer metrics read from the program's own tracer
(`sicelore_tpu_torch/utils/trace.py`), not from the harness's hooks.

A metric file calls `arm()` in its module body: the harness loads metric
files only in a `--trace 1` run, after the warm-up and before the window,
and afresh for each run, so the program records exactly the window's calls.
`arm()` switches the tracer on and empties it, and may be called any number
of times. The first `snapshot(run)` of a run takes the tracer's snapshot,
keeps it for that run and switches the tracer off, so nothing stays on for
the reference's check or a later run in the same process. A program
without the tracer (an older tree) gives no snapshot: every metric that
reads one returns None."""
from __future__ import annotations

try:
    from sicelore_tpu_torch.utils import trace
except ImportError:             # a program that has no tracer
    trace = None

_taken: list = [None, None]     # [run, its snapshot]


def arm() -> None:
    if trace is not None:
        trace.enable()


def snapshot(run) -> dict | None:
    if trace is None:
        return None
    if _taken[0] is not run:
        _taken[:] = [run, trace.snapshot()]
        trace.disable()
    return _taken[1]


def span_ms_per_k(run, name: str, routes=None) -> float | None:
    """Host ms in the program's spans called `name` (those whose `route`
    attribute is in `routes`, when given) per 1,000 units of the run."""
    snap = snapshot(run)
    if snap is None or not run.units:
        return None
    ns = sum(s["end"] - s["start"] for s in snap["spans"]
             if s["name"] == name
             and (routes is None or s["attrs"].get("route") in routes))
    return ns / 1e6 * 1000 / run.units

