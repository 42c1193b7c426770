"""Percent of its roofline that csrc/bandalign.cu reaches: the least time the
card could take for its launches' work (harness/work.py) over their event
intervals."""
from benchmark.metrics._common import roofline


def read(run):
    return roofline(run, ("bandalign",))
