"""Percent of the window in which no kernel of the program ran (the union of
the launches' event intervals; copies and PyTorch's own kernels are not
counted as busy)."""
from benchmark.metrics._common import idle_share


def read(run):
    return idle_share(run)
