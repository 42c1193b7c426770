"""The program's tracer: host spans, counters and kernel launches, kept in
memory and off by default.

  span(name, **attrs)      a context manager recording the name, start and
                           end on the host's clock (`time.perf_counter_ns`),
                           a span id, the parent span's id (the innermost
                           span open in the same thread, 0 for none) and
                           the call id (the innermost `call`'s, 0 outside
                           any); `.set(**attrs)` adds attributes before it
                           closes
  call(name, **attrs)      a span that opens a new call id: one a
                           `compute_consensus`, shared by every span in it
  count(name, n=1, **attrs)  adds n to the counter keyed by the name and
                           its attributes
  enable(), disable(), reset(), snapshot(), dump(snap, path), self_ns(spans)

Off, `span` and `call` return one shared null context and `count` returns
at once: each checks the module's one boolean `ON`, and nothing is made.
Callers keep spans and counts out of loops over reads, records and
molecules: they count in local variables and record once a phase.

Launches: `ops._build.launch`, the one launch site, calls `launch_begin`
and `launch_end` when `ON`. A record holds the kernel's name, the id of
the innermost open span, the host instant just before the launch (read
before its first event is recorded, so the card cannot start the kernel
earlier) and CUDA events before and after the launch on its stream.
`enable()` and `reset()` take an anchor on the current CUDA device when
CUDA is initialised (a device first launched on later is anchored at that
launch): synchronise, record an event, wait for it, read the host clock,
best of three. `snapshot()` synchronises once, takes a second anchor, and
puts every launch's events on the host's clock through its device's two
anchors: the card's clock and the host's drift apart by some microseconds
a second, which one anchor would leave in the launches of a long window.
Host spans and device intervals then share one timeline.

The interpreter's garbage collector: while on, every collection adds its
host ns to the counter `gc.ns` and one to `gc.collections` (by
`generation`), and each full collection (generation 2, tens to hundreds of
milliseconds with a parsed BAM in memory) is a `gc` span, a child of the
span it interrupted, so that span's self time leaves the pause out.

  hold_gc()                a context manager that keeps the collector off
                           for a block whose objects die by reference
                           count (one `compute_consensus`), and puts back
                           the state it found on every exit; while on,
                           counter `gc.held` (one a hold) and
                           `gc.held_objects` (the generation-0 count at
                           release less at hold: the tracked objects the
                           block left alive, which the first collection
                           after it scans)
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import threading
import time

ON = False


class _Null:
    """The one context `span` and `call` return while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()


class _State:
    def __init__(self):
        # reentrant: a collection inside a locked section counts itself
        self.lock = threading.RLock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.calls = itertools.count(1)
        self.spans: list[Span] = []
        self.counters: dict[tuple, int] = {}
        # (name, span id, enqueue ns, device index, event before, after)
        self.launches: list[tuple] = []
        self.anchors: dict[int, tuple] = {}     # device -> (event, host ns)
        self.gc_start = 0


_S = _State()


def _stack() -> list:
    st = getattr(_S.local, "stack", None)
    if st is None:
        st = _S.local.stack = []
    return st


class Span:
    """An open span while inside its `with`, a record once closed."""
    __slots__ = ("id", "parent", "call", "name", "start", "end", "attrs",
                 "_new_call")

    def __init__(self, name: str, attrs: dict, new_call: bool):
        self.name = name
        self.attrs = attrs
        self._new_call = new_call
        self.id = self.parent = self.call = self.start = self.end = 0

    def _place(self, st: list) -> None:
        top = st[-1] if st else None
        self.id = next(_S.ids)
        self.parent = top.id if top else 0
        self.call = (next(_S.calls) if self._new_call
                     else top.call if top else 0)

    def __enter__(self):
        st = _stack()
        self._place(st)
        st.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _S.spans.append(self)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def _on_gc(phase: str, info: dict) -> None:
    """gc.callbacks entry while on: the collections' time, and a `gc` span
    for each full one."""
    t = time.perf_counter_ns()
    if phase == "start":
        _S.gc_start = t
        return
    g = info["generation"]
    count("gc.ns", t - _S.gc_start, generation=g)
    count("gc.collections", generation=g)
    if g == 2:
        sp = Span("gc", {"generation": g, "collected": info["collected"]},
                  False)
        sp._place(_stack())
        sp.start, sp.end = _S.gc_start, t
        _S.spans.append(sp)


@contextlib.contextmanager
def hold_gc():
    """No cyclic collection inside the block: a collection rescans every
    tracked object, and a block that parses a BAM keeps hundreds of
    thousands alive at once, which reference counting frees anyway. The
    collector is enabled again at the end only if it was enabled at the
    start; no threshold is touched and nothing is collected here."""
    was = gc.isenabled()
    gc.disable()
    n0 = gc.get_count()[0]
    try:
        yield
    finally:
        if ON:
            count("gc.held")
            count("gc.held_objects", gc.get_count()[0] - n0)
        if was:
            gc.enable()


def span(name: str, **attrs):
    if not ON:
        return NULL
    return Span(name, attrs, False)


def call(name: str, **attrs):
    if not ON:
        return NULL
    return Span(name, attrs, True)


def count(name: str, n: int = 1, **attrs) -> None:
    if not ON:
        return
    key = (name, tuple(sorted(attrs.items())))
    with _S.lock:
        _S.counters[key] = _S.counters.get(key, 0) + n


# ---------------------------------------------------------------------------
# launches (called by ops._build.launch only while ON)
# ---------------------------------------------------------------------------

def _anchor(index: int) -> tuple:
    """(event, host ns): an instant of device `index`'s CUDA clock on the
    host's, the event that the host saw done soonest after recording it,
    of three."""
    import torch
    best = None
    for _ in range(3):
        torch.cuda.synchronize(index)
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter_ns()
        ev.record(torch.cuda.current_stream(index))
        ev.synchronize()
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[2]:
            best = (ev, t1, t1 - t0)
    return best[:2]


def _end_anchor(index: int):
    """The second anchor a snapshot takes, or None without CUDA."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return _anchor(index)
    return None


def launch_begin(what: str, device):
    import torch
    if device.index not in _S.anchors:
        _S.anchors[device.index] = _anchor(device.index)
    st = _stack()
    stream = torch.cuda.current_stream(device)
    t = time.perf_counter_ns()
    a = torch.cuda.Event(enable_timing=True)
    a.record(stream)
    return what, st[-1].id if st else 0, t, device.index, a, stream


def launch_end(rec) -> None:
    import torch
    what, sid, t, index, a, stream = rec
    b = torch.cuda.Event(enable_timing=True)
    b.record(stream)
    _S.launches.append((what, sid, t, index, a, b))


def to_host_ns(anchor_ns: int, ms_after_anchor: float,
               rate: float = 1.0) -> int:
    """A device instant given as milliseconds after its device's anchor
    event, on the host's clock, which runs `rate` host ns a device ns."""
    return anchor_ns + round(ms_after_anchor * 1e6 * rate)


# ---------------------------------------------------------------------------
# switching, reading, writing
# ---------------------------------------------------------------------------

def reset() -> None:
    """Drop every record, and anchor the current CUDA device again."""
    with _S.lock:
        _S.spans = []
        _S.counters = {}
        _S.launches = []
        _S.anchors = {}
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        index = torch.cuda.current_device()
        _S.anchors[index] = _anchor(index)


def enable() -> None:
    """Reset, then record from here on."""
    global ON
    reset()
    ON = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def disable() -> None:
    """Stop recording; what was recorded stays until `reset`."""
    global ON
    ON = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def snapshot() -> dict:
    """What was recorded, as plain data on the host's clock (ns):
    {"spans": [{id, parent, call, name, start, end, attrs}] by start,
     "counters": [{name, attrs, value}],
     "launches": [{name, span, device, enqueue, start, end}],
     "clocks": {device: host ns a device ns, between the two anchors}}."""
    with _S.lock:
        spans = list(_S.spans)
        counters = dict(_S.counters)
        launches = list(_S.launches)
        anchors = dict(_S.anchors)
    rates = {}
    for d in sorted({rec[3] for rec in launches}):
        end = _end_anchor(d)       # waits for the device's work
        anchor, anchor_ns = anchors[d]
        dev_ms = anchor.elapsed_time(end[0]) if end else 0.0
        rates[d] = (end[1] - anchor_ns) / (dev_ms * 1e6) if dev_ms > 0 \
            else 1.0
    out_l = []
    for what, sid, t, index, a, b in launches:
        anchor, anchor_ns = anchors[index]
        r = rates[index]
        out_l.append({"name": what, "span": sid, "device": index,
                      "enqueue": t,
                      "start": to_host_ns(anchor_ns, anchor.elapsed_time(a),
                                          r),
                      "end": to_host_ns(anchor_ns, anchor.elapsed_time(b),
                                        r)})
    return {
        "spans": [{"id": s.id, "parent": s.parent, "call": s.call,
                   "name": s.name, "start": s.start, "end": s.end,
                   "attrs": dict(s.attrs)}
                  for s in sorted(spans, key=lambda s: (s.start, s.id))],
        "counters": [{"name": name, "attrs": dict(attrs), "value": v}
                     for (name, attrs), v in sorted(
                         counters.items(), key=lambda kv: repr(kv[0]))],
        "launches": out_l,
        "clocks": rates,
    }


def self_ns(spans: list[dict]) -> dict[int, int]:
    """{span id: its duration less the part of its interval that its
    children cover} for the snapshot's spans."""
    kids: dict[int, list] = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out = {}
    for s in spans:
        covered, cur = 0, None
        for a, b in sorted((max(c["start"], s["start"]),
                            min(c["end"], s["end"]))
                           for c in kids.get(s["id"], ())):
            if b <= a:
                continue
            if cur is None or a > cur[1]:
                if cur is not None:
                    covered += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            covered += cur[1] - cur[0]
        out[s["id"]] = s["end"] - s["start"] - covered
    return out


def dump(snap: dict, path) -> None:
    """Write a snapshot as Chrome trace-event JSON (chrome://tracing,
    Perfetto): host spans on one track, device launches on another, both
    on the host's clock in microseconds from the first record, and each
    counter as a `C` event at the end."""
    times = ([s["start"] for s in snap["spans"]]
             + [x["enqueue"] for x in snap["launches"]])
    t0 = min(times) if times else 0
    t_end = max([s["end"] for s in snap["spans"]]
                + [x["end"] for x in snap["launches"]] + [t0])

    def us(ns):
        return (ns - t0) / 1e3

    ev = [{"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
           "args": {"name": name}}
          for tid, name in ((1, "host spans"), (2, "device launches"))]
    for s in snap["spans"]:
        ev.append({"ph": "X", "pid": 1, "tid": 1, "name": s["name"],
                   "ts": us(s["start"]), "dur": (s["end"] - s["start"]) / 1e3,
                   "args": {**s["attrs"], "id": s["id"],
                            "parent": s["parent"], "call": s["call"]}})
    for x in snap["launches"]:
        ev.append({"ph": "X", "pid": 1, "tid": 2, "name": x["name"],
                   "ts": us(x["start"]), "dur": (x["end"] - x["start"]) / 1e3,
                   "args": {"span": x["span"], "device": x["device"],
                            "enqueue_us": us(x["enqueue"])}})
    series: dict[str, dict] = {}
    for c in snap["counters"]:
        key = ",".join(f"{k}={v}" for k, v in c["attrs"].items()) or "n"
        series.setdefault(c["name"], {})[key] = c["value"]
    for name, args in series.items():
        ev.append({"ph": "C", "pid": 1, "tid": 1, "name": name,
                   "ts": us(t_end), "args": args})
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, fh)
