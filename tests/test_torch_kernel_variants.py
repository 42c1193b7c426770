"""kernel_variants.py's patches still apply: each variant's replaced text is
in its kernel source exactly once, so an edit of a kernel that moves a
patched line fails here, on the CPU, and not first on the card."""
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import kernel_variants as kv  # noqa: E402
from sicelore_tpu_torch.ops import _build  # noqa: E402

SETS = {
    "bandalign": (kv.BAND_PATCHES, {k: [] for k in kv.BAND_VARIANTS}),
    "win1": ((), {"rows64": [(kv.WIN1_ROWS, "constexpr int ROWS = 64;")]}),
    "tilescan": ((), kv.TILE_VARIANTS),
    "edgescan": (kv.EDGE_PATCHES,
                 {k: reps for k, (reps, _) in kv.EDGE_VARIANTS.items()}),
    "tilefeed": ((), kv.FEED_VARIANTS),
    "pairwise": ((), kv.PAIR_VARIANTS),
    "encode": ((), {k: [] for k in kv.ENCODE_VARIANTS}),
}

# the variants built with nvcc -D flags: {stem: (common patches,
# {name: flags})}
KNOBS = {
    "bandalign": (kv.BAND_PATCHES, kv.BAND_VARIANTS),
    "edgescan": (kv.EDGE_PATCHES,
                 {k: flags for k, (_, flags) in kv.EDGE_VARIANTS.items()}),
    "encode": ((), kv.ENCODE_VARIANTS),
}


@pytest.mark.parametrize("stem", sorted(SETS))
def test_every_variant_patch_applies(stem):
    common, variants = SETS[stem]
    src = kv.patched((_build.CSRC / f"{stem}.cu").read_text(), common)
    for name, reps in variants.items():
        out = kv.patched(src, reps)
        assert (out != src) == bool(reps), name


@pytest.mark.parametrize("stem", sorted(KNOBS))
def test_every_variant_knob_is_read(stem):
    """Each -D flag of a variant names a macro its (patched) kernel source
    tests, so a renamed knob fails here instead of building the base
    kernel under another name; encode's knobs each have a default."""
    common, variants = KNOBS[stem]
    src = kv.patched((_build.CSRC / f"{stem}.cu").read_text(), common)
    tested = set(re.findall(r"#\s*(?:ifn?def|if)\s+!?(\w+)", src))
    for name, flags in variants.items():
        for f in flags:
            knob = re.fullmatch(r"-D(\w+)(?:=\d+)?", f).group(1)
            assert knob in tested, (name, knob)
            if stem == "encode":
                assert f"#ifndef {knob}\n#define {knob} " in src, knob


def test_a_moved_line_fails_loudly():
    with pytest.raises(SystemExit, match="no longer holds"):
        kv.patched("constexpr int ROWS = 96;", [(kv.WIN1_ROWS, "")])


def test_script_imports_no_jax():
    """The script imports nothing of jax or the JAX package."""
    src = (REPO / "kernel_variants.py").read_text()
    assert "import jax" not in src and "sicelore_tpu." not in src.replace(
        "sicelore_tpu_torch", "")
