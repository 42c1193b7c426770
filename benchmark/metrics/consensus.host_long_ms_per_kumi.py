"""Host ms in the host engine on the molecules the device route cannot take
for their size (the program's `consensus.host` spans of routes `long`: a
center over max_center_len; `nopair`: a bucket with no pair left;
`overflow`: an assembly longer than the device's output row) per 1,000
molecules."""
from benchmark.metrics import _program

_program.arm()


def read(run):
    return _program.span_ms_per_k(run, "consensus.host",
                                  ("long", "nopair", "overflow"))
