"""What the compiler made of the CUDA kernels: registers, shared memory and
spills of every kernel of a built library (`cuobjdump -res-usage`), its SASS
(`cuobjdump -sass`, written to a file) and, per kernel, the instruction mix
of its hottest loop: the longest loop (backward branch) that holds no other
loop, which for the unrolled kernels of this package is the inner loop.

    python -m sicelore_tpu_torch.utils.kernel_report [--out DIR] [stem ...]

Needs nvcc and cuobjdump (the CUDA toolkit); builds the libraries first if
they are not built. Prints one JSON line per kernel:
{"lib", "kernel", "registers", "shared", "stack", "loop_instructions",
"loop_mix": {opcode: count}, "instructions", "loops": [[first, length],
...], "outer_instructions"}. Divide `loop_instructions` by the columns (or
cells) the source unrolls into one trip of the loop to get the count a
column; the opcodes on the integer pipe are everything but
LDS/LDG/STS/STG, BRA/BAR and SHFL.
`instructions` counts the kernel's SASS; `loops` lists every innermost loop
(index of its first instruction, instructions a trip);
`outer_instructions` is the longest loop with the loops inside it (a
kernel whose per-item loop holds a wait loop, as csrc/encode.cu's read
loop does). `ptxas_usage` gives nvcc -Xptxas -v's registers and spills."""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from sicelore_tpu_torch.ops import _build


def _tool(name: str) -> str:
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit to ask")
    return str(Path(nvcc).with_name(name))


def _demangle(names: list[str]) -> dict[str, str]:
    try:
        out = subprocess.run([_tool("cu++filt"), *names],
                             capture_output=True, text=True)
    except OSError:
        return {n: n for n in names}
    got = out.stdout.strip().splitlines()
    return dict(zip(names, got)) if len(got) == len(names) else \
        {n: n for n in names}


def resources(lib: Path) -> dict[str, dict]:
    """{mangled kernel: {registers, shared, stack}} from -res-usage."""
    txt = subprocess.run([_tool("cuobjdump"), "-res-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    res, name = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line:
            f = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            res[name] = {"registers": f.get("REG"), "shared": f.get("SHARED"),
                         "stack": f.get("STACK")}
            name = None
    return res


def hottest_loops(sass: str) -> dict[str, dict]:
    """{mangled kernel: {loop_instructions, loop_mix}}: per function, the
    innermost loop (a backward branch around no other) with the most
    instructions."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ins = re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)"
            r"([^;]*);", fn)
        addr = [int(a, 16) for a, _, _ in ins]
        loops = []
        for i, (a, op, rest) in enumerate(ins):
            if not op.startswith("BRA"):
                continue
            m = re.search(r"0x([0-9a-f]+)", rest)
            if not m or int(m.group(1), 16) > addr[i]:
                continue
            loops.append((next((k for k, x in enumerate(addr)
                                if x >= int(m.group(1), 16)), i), i))
        inner = [lp for lp in loops if not any(
            lp != o and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        best = max(inner, key=lambda lp: lp[1] - lp[0], default=None)
        if best is None:
            out[name] = {"loop_instructions": 0, "loop_mix": {},
                         "instructions": len(ins), "loops": [],
                         "outer_instructions": 0}
            continue
        mix = Counter(op.split(".")[0] for _, op, _ in
                      ins[best[0]:best[1] + 1])
        outer = max(loops, key=lambda lp: lp[1] - lp[0])
        out[name] = {"loop_instructions": best[1] - best[0] + 1,
                     "loop_mix": dict(mix.most_common()),
                     "instructions": len(ins),
                     "loops": [[a, b - a + 1] for a, b in sorted(inner)],
                     "outer_instructions": outer[1] - outer[0] + 1}
    return out


def ptxas_usage(stem: str) -> dict[str, dict]:
    """{mangled kernel: {registers, spill_stores, spill_loads, stack}} of
    csrc/<stem>.cu as `nvcc -Xptxas -v` reports it (a build of its own,
    into a temporary file beside the libraries)."""
    src = _build.CSRC / f"{stem}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _build.BUILD_DIR / f"{stem}.ptxas.tmp"
    try:
        txt = subprocess.run(
            [_tool("nvcc"), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(tmp), str(src)], capture_output=True, text=True,
            check=True).stderr
    finally:
        tmp.unlink(missing_ok=True)
    out, name = {}, None
    for line in txt.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stems", nargs="*", help="csrc/<stem>.cu (default: all)")
    ap.add_argument("--out", default="build/sass",
                    help="directory for the <stem>.sass files")
    args = ap.parse_args(argv)
    paths = _build.build_all()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for stem in args.stems or sorted(paths):
        lib = paths[stem]
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        (out_dir / f"{stem}.sass").write_text(sass)
        res, loops = resources(lib), hottest_loops(sass)
        names = _demangle(sorted(set(res) | set(loops)))
        for k in sorted(names):
            print(json.dumps({"lib": stem, "kernel": names[k],
                              **res.get(k, {}), **loops.get(k, {})}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
