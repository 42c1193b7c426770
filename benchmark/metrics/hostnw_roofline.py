"""Percent of its roofline that csrc/hostnw.cu reaches: the least time the
card could take for the window's `host_nw` work over the time its launches
took.

The launches are the program's records named `hostnw` (`utils/trace.py`:
CUDA events before and after each launch on its stream, on the host's
clock). The work comes from the program's counters, one count a `host_nw`
call, and is reckoned here, so the same work reads the same whatever
implements it: 9 int32 operations a band cell (`hostnw.band_cells`, the
cells the host's `nw_align_banded` fills, la x min(2 band + 1, lb) a pair;
PERF.md's count for the kernel), and the bytes read or written once: the
packed bases each pair reads and the moves it writes (`hostnw.move_bytes`,
la + lb a pair, each), its row of the pair table (48) and its move count
(4). The slab of score rows is the kernel's scratch and counts no byte.
The peaks are `harness/work.py`'s. None where the program records no such
launch or counter."""
from benchmark.harness.work import bound_s
from benchmark.metrics import _program

_program.arm()

OPS_PER_CELL = 9
PAIR_BYTES = 6 * 8 + 4


def read(run):
    snap = _program.snapshot(run)
    if snap is None:
        return None
    count: dict = {}
    for c in snap["counters"]:
        if c["name"].startswith("hostnw."):
            count[c["name"]] = count.get(c["name"], 0) + c["value"]
    spent = sum(x["end"] - x["start"] for x in snap["launches"]
                if x["name"] == "hostnw") / 1e9
    if spent <= 0 or "hostnw.band_cells" not in count:
        return None
    need = bound_s({"ops": OPS_PER_CELL * count["hostnw.band_cells"],
                    "bytes": 2 * count["hostnw.move_bytes"]
                    + PAIR_BYTES * count["hostnw.pairs"]})
    return 100.0 * need / spent
