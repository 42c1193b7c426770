"""Build the CUDA kernels of `csrc/` with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>_<hash>.so <name>.cu

All sources build in parallel (one nvcc each) at the first kernel call of a
process. The library name carries a hash of the sources and flags, so an
edited source rebuilds and a stale library is never loaded. Every C entry
point takes device pointers and the stream as `void*`, returns
`cudaGetLastError()` after its launch, and the wrappers call it through
`launch`, which makes the tensors' device current and raises when the
result is not 0. While the program's tracer is on (`utils.trace`), `launch`
also records each launch with its host instant and CUDA events around it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from sicelore_tpu_torch.utils import trace

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None   # wall time of this process's build


def find_nvcc() -> str | None:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    return None


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu not yet built (all nvcc runs in parallel).
    Returns {stem: library path}. Raises with nvcc's output on failure."""
    global build_seconds
    srcs = sorted(CSRC.glob("*.cu"))
    paths = {s.stem: _lib_path(s) for s in srcs}
    todo = [s for s in srcs if not paths[s.stem].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for s in todo:
        tmp = paths[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for s, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {s.name} (rc {p.returncode}):\n"
                          + out.decode(errors="replace"))
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[s.stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    build_seconds = time.time() - t0
    return paths


def load(stem: str) -> ctypes.CDLL:
    """The ctypes library built from csrc/<stem>.cu (building on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no kernel source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            _libs[stem] = lib
        return lib


@functools.lru_cache(maxsize=None)
def bind(stem: str, fn: str, n_ptr: int, n_int: int):
    """C entry `fn` of library `stem` taking n_ptr pointers, n_int ints and
    the stream (in that order), returning a cudaError_t as int. Bound once
    a process: a wrapper's call costs a dictionary lookup."""
    f = getattr(load(stem), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def launch(fn, what: str, device, *args) -> None:
    """Call the C entry `fn` with `args` and the current stream of `device`
    (a CUDA tensor's device), with `device` the current CUDA device: a kernel
    goes to the current device whatever stream it is given, so a shard on
    cuda:1 must not launch from a thread whose current device is cuda:0.
    Raises when the entry returns a non-zero cudaError."""
    with torch.cuda.device(device):
        if trace.ON:
            rec = trace.launch_begin(what, device)
            check(fn(*args, stream_handle(device)), what)
            trace.launch_end(rec)
        else:
            check(fn(*args, stream_handle(device)), what)


def stream_handle(device) -> int:
    """The current CUDA stream of `device` (a CUDA tensor's device, so its
    index is set) as an integer handle: PyTorch's raw query, which builds no
    Stream object (the call its own generated kernels make)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
