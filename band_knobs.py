"""Where the band-alignment kernel's time goes: builds
sicelore_tpu_torch/csrc/bandalign.cu in variants with one part compiled out
each (shuffles, the byte stores of the move bits, the read/center loads, the
zero fill of `ins`, the walk), with fewer warps an SM, or with the prefix
maximum in log2(G) dependent shuffle levels instead of two radix-4 levels,
and times each at chip_smoke.py's band shapes.

    python3 band_knobs.py        # from the repo root, beside chip_smoke.py

A diagnostic beside chip_smoke.py, not part of the package: nothing imports
it. A variant with a part compiled out computes WRONG results (that is the
point: only its time is read); `logscan` computes the same results as
`base`. The knobs are applied to a copy of the source by exact text
replacement, so an edit of the kernel that moves one of the patched lines
makes this script fail loudly instead of timing something else. Needs a
CUDA GPU and nvcc. Prints one JSON line per shape: {"Lc", "W", "pairs",
"ms": {variant: mean ms of 5 back-to-back launches}}.

Variants: base; nowalk (no traceback: also no copy-out lookups); nozero;
fwd = nowalk + nozero (the forward pass and the repack alone); fwd_noshfl =
fwd with every shuffle replaced by an add; fwd_bare = fwd_noshfl without the
mask stores and the global loads (the recurrence's ALU work alone); logscan
and base2 = the log-step prefix maximum and the kernel as it is once more,
timed in turns (logscan, base2, base2, logscan; the least of each);
w1/w2/w4/w7 = one block of that many warps an SM."""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from sicelore_tpu_torch.ops import _build

PATCHES = (
    ("namespace {\n\nconstexpr int MATCH",
     "#ifdef KNOB_NOSHFL\n"
     "#define __shfl_up_sync(m, v, d, w) ((v) + (d))\n"
     "#define __shfl_down_sync(m, v, d, w) ((v) - (d))\n"
     "#endif\nnamespace {\n\nconstexpr int MATCH"),
    ("          sp[c * G] = (unsigned char)bits;\n        }\n      } else {",
     "#ifndef KNOB_NOSTS\n          sp[c * G] = (unsigned char)bits;\n#else\n"
     "          if (bits == 0x12345u) sp[c * G] = 1;\n#endif\n"
     "        }\n      } else {"),
    ("      const unsigned nnw =\n"
     "          (more && nx >= 0) ? *(const unsigned*)(rrow + nx) : 0u;\n"
     "      const unsigned ncw =\n"
     "          more ? *(const unsigned*)(crow + j0 + CPL - 1) : 0u;",
     "#ifdef KNOB_NOLDG\n"
     "      const unsigned nnw = nw * 1664525u + 1013904223u;\n"
     "      const unsigned ncw = (cw * 22695477u + 1u) & 0x03030303u;\n"
     "#else\n"
     "      const unsigned nnw =\n"
     "          (more && nx >= 0) ? *(const unsigned*)(rrow + nx) : 0u;\n"
     "      const unsigned ncw =\n"
     "          more ? *(const unsigned*)(crow + j0 + CPL - 1) : 0u;\n"
     "#endif"),
    ("      for (int k = lane; k < n; k += 32) dst[k] = make_int4(0, 0, 0, 0);",
     "#ifndef KNOB_NOZERO\n"
     "      for (int k = lane; k < n; k += 32) dst[k] = make_int4(0, 0, 0, 0);"
     "\n#endif"),
    ("      if (feas) {\n        int b = btc, j = clen;",
     "#ifdef KNOB_NOWALK\n      if (false) {\n#else\n      if (feas) {\n#endif\n"
     "        int b = btc, j = clen;"),
    ("__device__ __forceinline__ int group_prefix_max(int y) {\n",
     "__device__ __forceinline__ int group_prefix_max(int y) {\n"
     "#ifdef KNOB_LOGSCAN\n"
     "#pragma unroll\n"
     "  for (int d = 1; d < G; d <<= 1)\n"
     "    y = max(y, __shfl_up_sync(FULL, y, d, G));\n"
     "  return y;\n"
     "#endif\n"),
    ("  const size_t smem = wpb * wbytes;",
     "#ifdef KNOB_WARPS\n  wpb = KNOB_WARPS;\n#endif\n"
     "  const size_t smem = wpb * wbytes;"),
    ("  const int grid = min((nsets + wpb - 1) / wpb, sms * max(per_sm, 1));",
     "#ifdef KNOB_WARPS\n"
     "  const int grid = min((nsets + wpb - 1) / wpb, sms);\n"
     "#else\n"
     "  const int grid = min((nsets + wpb - 1) / wpb, sms * max(per_sm, 1));\n"
     "#endif"),
)
FWD = ["-DKNOB_NOWALK", "-DKNOB_NOZERO"]
VARIANTS = {
    "base": [], "nowalk": ["-DKNOB_NOWALK"], "nozero": ["-DKNOB_NOZERO"],
    "fwd": FWD, "fwd_noshfl": FWD + ["-DKNOB_NOSHFL"],
    "fwd_bare": FWD + ["-DKNOB_NOSHFL", "-DKNOB_NOSTS", "-DKNOB_NOLDG"],
    "logscan": ["-DKNOB_LOGSCAN"],
    "w1": ["-DKNOB_WARPS=1"], "w2": ["-DKNOB_WARPS=2"],
    "w4": ["-DKNOB_WARPS=4"], "w7": ["-DKNOB_WARPS=7"],
}


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("band_knobs: needs a CUDA GPU", file=sys.stderr)
        return 1
    nvcc = _build.find_nvcc()
    src = (_build.CSRC / "bandalign.cu").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"band_knobs: the kernel source no longer holds "
                             f"exactly once:\n{old}")
        src = src.replace(old, new)
    out = _build.BUILD_DIR.parent / "band_knobs"
    out.mkdir(parents=True, exist_ok=True)
    (out / "bandalign_knobs.cu").write_text(src)
    procs = {k: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(out / f"{k}.so"),
         str(out / "bandalign_knobs.cu")], stderr=subprocess.DEVNULL)
        for k, flags in VARIANTS.items()}
    for k, p in procs.items():
        if p.wait():
            raise SystemExit(f"band_knobs: nvcc failed on variant {k}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED + 100)
    stream = torch.cuda.current_stream().cuda_stream
    for Lc, W, n_pairs, lo, hi in chip_smoke.BAND_SHAPES:
        reads, rl, mids, cm, cl = chip_smoke.band_pairs(rng, Lc, W, n_pairs,
                                                        lo, hi, dev)
        P = reads.shape[0]
        al = torch.empty((P, Lc + 1), dtype=torch.int8, device=dev)
        ins = torch.empty((P, Lc + 1, 4, 4), dtype=torch.int8, device=dev)
        fe = torch.empty((P,), dtype=torch.int32, device=dev)
        ms = {}
        for k in [*VARIANTS, "base", "base", "logscan"]:
            if k[0] == "w" and int(k[1:]) * 32 * Lc > 232448:
                continue            # more shared memory than a block may ask
            fn = ctypes.CDLL(str(out / f"{k}.so")).bandalign_launch
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def launch(_):
                _build.check(fn(reads.data_ptr(), rl.data_ptr(),
                                mids.data_ptr(), cm.data_ptr(), cl.data_ptr(),
                                al.data_ptr(), ins.data_ptr(), fe.data_ptr(),
                                P, cm.shape[0], Lc, W, stream), k)
            t = chip_smoke.burst_ms(launch, [None] * 5)
            # the second round of base is kept apart: it is logscan's pair
            name = "base2" if k == "base" and "logscan" in ms else k
            ms[name] = min(t, ms.get(name, t))
        print(json.dumps({"Lc": Lc, "W": W, "pairs": P, "ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
