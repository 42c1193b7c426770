"""Kernel launches through the program's launch site per Step 1 run."""
from benchmark.metrics._common import launches_per_call


def read(run):
    return launches_per_call(run)
