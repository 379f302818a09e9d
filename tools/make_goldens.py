"""Generate golden images for the regression suite.

Renders every reference scene at small resolution / fixed seed on CPU and
stores the linear images under tests/goldens/. Re-run only when a deliberate
semantics change is made; the test suite compares against these to catch
accidental drift while optimizing (BVH, Pallas kernels must not change
images beyond backend numerics).
"""

import os
import pathlib
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from plutracer_tpu.render.renderer import render
from plutracer_tpu.scene import compile_scene, load_scene_file

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "goldens"
SCENES = pathlib.Path("/root/reference/scenes")

W, H, N, SEED = 64, 48, 2, 42
# per-scene resolution overrides: the CPU brute-force oracle is O(B x P),
# so the 102k-prim scene gets a smaller golden (64x48 measured
# ~30 min per render on CPU; 24x18 is ~100 s). The golden test renders
# at whatever resolution the stored golden has.
RES_OVERRIDE = {"repo-mesh2": (24, 18)}


def all_scenes():
    """(golden-stem, path) for the reference corpus + this repo's scenes
    (repo scenes prefixed 'repo-' to avoid stem collisions)."""
    out = [(p.stem, p) for p in sorted(SCENES.glob("*.urn"))]
    out += [(f"repo-{p.stem}", p) for p in sorted((REPO / "scenes").glob("*.urn"))]
    return out


def main():
    # Optional CLI args: golden stems to (re)generate; default = all.
    only = set(sys.argv[1:])
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for stem, p in all_scenes():
        if only and stem not in only:
            continue
        w, h = RES_OVERRIDE.get(stem, (W, H))
        d = load_scene_file(str(p), ["/res", f"{w}x{h}"])
        s = compile_scene(d)
        img = np.asarray(render(s, w, h, N, jax.random.PRNGKey(SEED)))
        out = GOLDEN_DIR / f"{stem}.npz"
        np.savez_compressed(out, linear=img.astype(np.float16))
        print(f"{stem}: mean={img.mean():.4f} max={img.max():.2f} -> {out.name}")


if __name__ == "__main__":
    main()
