"""Arithmetic the per-layer metric files share."""
from __future__ import annotations

from benchmark.harness.work import bound_s


def per_k(run, targets) -> float | None:
    """Host milliseconds in the targets' spans per 1,000 units."""
    if not run.units:
        return None
    return sum(run.span_s.get(t, 0.0) for t in targets) * 1e6 / run.units


def roofline(run, kernels) -> float | None:
    """Percent: the least time the card could take for the reckoned work of
    the named kernels' launches over the time those launches took; None
    when no launch of them carries work."""
    need = spent = 0.0
    for name, a, b, work in run.kernels:
        if name in kernels and work is not None:
            need += bound_s(work)
            spent += b - a
    return 100.0 * need / spent if spent > 0 else None


def launches_per_call(run) -> float | None:
    return len(run.kernels) / run.calls if run.kernels else None


def idle_share(run) -> float | None:
    if not run.kernels:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
