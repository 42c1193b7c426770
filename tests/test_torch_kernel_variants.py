"""kernel_variants.py's patches still apply: each variant's replaced text is
in its kernel source exactly once, so an edit of a kernel that moves a
patched line fails here, on the CPU, and not first on the card."""
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
}


@pytest.mark.parametrize("stem", sorted(SETS))
def test_every_variant_patch_applies(stem):
    common, variants = SETS[stem]
    src = kv.patched((_build.CSRC / f"{stem}.cu").read_text(), common)
    for name, reps in variants.items():
        out = kv.patched(src, reps)
        assert (out != src) == bool(reps), name


def test_a_moved_line_fails_loudly():
    with pytest.raises(SystemExit, match="no longer holds"):
        kv.patched("constexpr int ROWS = 96;", [(kv.WIN1_ROWS, "")])


def test_script_imports_no_jax():
    """The script imports nothing of jax or the JAX package."""
    src = (REPO / "kernel_variants.py").read_text()
    assert "import jax" not in src and "sicelore_tpu." not in src.replace(
        "sicelore_tpu_torch", "")
