"""What a traced run records, from the benchmark's own hooks around the
program's functions (nothing inside the program changes):

  spans     host seconds inside a function, patched where callers look it
            up ("module:attr.path"), with each call's interval for the
            breakdown's labels;
  launches  every kernel launch through the program's one launch site
            (`ops._build.launch`): its name, and CUDA events before and
            after it on the launch's stream, read against one event at the
            window's start after the window (no sync inside it);
  work      the problem's bytes and int32 operations of a launch, reckoned
            from the Python wrapper's arguments by `work.WORK` when the
            wrapper is called (a sum the device owes is queued there and
            read after the window), attached to the launch of that kernel
            made inside the wrapper's call.
"""
from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict

import torch

LAUNCH_SITE = "sicelore_tpu_torch.ops._build:launch"


def resolve(target: str):
    """"pkg.module:Attr.attr" -> (owner object, attribute name)."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Tracer:
    def __init__(self):
        self.span_s: dict[str, float] = defaultdict(float)
        self.intervals: list[tuple[str, float, float]] = []
        self.launches: list[tuple] = []     # (name, ev0, ev1, work)
        self._undo = []
        self._local = threading.local()
        self.t0 = self.ev0 = None

    # -- installing and removing hooks --------------------------------
    def _patch(self, target, make):
        owner, attr = resolve(target)
        fn = owner.__dict__[attr] if isinstance(owner, type) else \
            getattr(owner, attr)
        setattr(owner, attr, make(fn))
        self._undo.append((owner, attr, fn))

    def span(self, target: str) -> None:
        def make(fn):
            def wrapper(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    e = time.perf_counter()
                    self.span_s[target] += e - t
                    self.intervals.append((target, t, e))
            return wrapper
        self._patch(target, make)

    def work(self, target: str, kernel: str, fn_work) -> None:
        def make(fn):
            def wrapper(*a, **kw):
                prev = getattr(self._local, "ctx", None)
                self._local.ctx = [kernel, fn_work(*a, **kw)]
                try:
                    return fn(*a, **kw)
                finally:
                    self._local.ctx = prev
            # the wrappers count their launches on their own global name
            wrapper.launches = getattr(fn, "launches", 0)
            return wrapper
        self._patch(target, make)

    def hook_launches(self) -> None:
        def make(fn):
            def wrapper(f, what, device, *args):
                stream = torch.cuda.current_stream(device)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record(stream)
                fn(f, what, device, *args)
                b.record(stream)
                ctx = getattr(self._local, "ctx", None)
                work = None
                if ctx is not None and ctx[0] == what and ctx[1] is not None:
                    work, ctx[1] = ctx[1], None     # the wrapper's own launch
                self.launches.append((what, a, b, work))
            return wrapper
        self._patch(LAUNCH_SITE, make)

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    # -- the window -----------------------------------------------------
    def start(self) -> None:
        if torch.cuda.is_available():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()
        self.span_s.clear()
        self.intervals.clear()
        self.launches.clear()

    def kernels(self):
        """[(name, start s, end s, work dict or None)] on the device's
        timeline from the window's start (after a sync)."""
        torch.cuda.synchronize()
        out = []
        for name, a, b, work in self.launches:
            if work is not None:
                work = {k: int(v) for k, v in work.items()}
            out.append((name, self.ev0.elapsed_time(a) / 1e3,
                        self.ev0.elapsed_time(b) / 1e3, work))
        return out
