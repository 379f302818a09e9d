"""Golden-image regression tests over the full reference scene corpus.

Goldens are small fixed-seed CPU renders (tools/make_goldens.py). The RNG is
counter-based, so a same-backend re-render reproduces the goldens almost
exactly; the loose tail tolerance absorbs backend numerics (CPU vs GPU) and
future kernel swaps (BVH/Pallas) which must not change path outcomes.
"""

import pathlib

import jax
import numpy as np
import pytest

from plutracer_tpu.render.renderer import render
from plutracer_tpu.scene import compile_scene, load_scene_file

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
SCENES = pathlib.Path("/root/reference/scenes")
REPO_SCENES = pathlib.Path(__file__).parent.parent / "scenes"
W, H, N, SEED = 64, 48, 2, 42

PATHS = {p.stem: p for p in sorted(SCENES.glob("*.urn"))}
PATHS.update({f"repo-{p.stem}": p for p in sorted(REPO_SCENES.glob("*.urn"))})
NAMES = sorted(PATHS)


def test_every_scene_has_a_golden():
    """Guard: adding a scenes/*.urn without running tools/make_goldens.py for
    it must fail loudly here (not as a FileNotFoundError mid-suite)."""
    missing = [n for n in NAMES if not (GOLDEN_DIR / f"{n}.npz").exists()]
    assert not missing, (
        f"goldens missing for {missing}: run "
        f"`JAX_PLATFORMS=cpu python tools/make_goldens.py {' '.join(missing)}`"
    )


@pytest.mark.parametrize("name", NAMES)
def test_golden(name):
    golden = np.load(GOLDEN_DIR / f"{name}.npz")["linear"].astype(np.float32)
    # render at the golden's stored resolution (big-P scenes use smaller
    # goldens — the CPU oracle is O(rays x P); see tools/make_goldens.py)
    h, w = golden.shape[:2]
    d = load_scene_file(str(PATHS[name]), ["/res", f"{w}x{h}"])
    s = compile_scene(d)
    img = np.asarray(render(s, w, h, N, jax.random.PRNGKey(SEED)))
    assert img.shape == golden.shape
    assert np.isfinite(img).all()
    # tonemapped comparison bounds the huge emissive dynamic range
    a = np.log1p(np.maximum(img, 0.0))
    b = np.log1p(np.maximum(golden, 0.0))
    diff = np.abs(a - b)
    # float16 golden quantization + cross-backend numerics tolerance
    assert np.quantile(diff, 0.99) < 0.05, f"{name}: p99 {np.quantile(diff, 0.99)}"
    assert diff.mean() < 0.01, f"{name}: mean {diff.mean()}"
