"""All intersect backends must render the same image (same seed)."""

import jax
import numpy as np
import pytest

from plutracer_tpu.render.renderer import render
from plutracer_tpu.scene import compile_scene, load_scene_file
from plutracer_tpu.semantics import DEFAULT_OPTIONS


@pytest.fixture(scope="module")
def scene(scenes_dir):
    d = load_scene_file(str(scenes_dir / "demo-box.urn"), ["/res", "24x24"])
    return compile_scene(d)


@pytest.fixture(scope="module")
def grid_scene(scenes_dir):
    d = load_scene_file(str(scenes_dir / "sphere-grid.urn"), ["/res", "24x18"])
    return compile_scene(d)


def _render(scene, backend, w=24, h=24, n=1):
    opts = DEFAULT_OPTIONS.replace(intersect_backend=backend)
    return np.asarray(
        render(scene, w, h, n, jax.random.PRNGKey(9), options=opts)
    )


def test_bvh_backend_matches_xla_no_dielectrics(grid_scene):
    """sphere-grid.urn has no glass: every accept test is numerically
    robust, so backends produce near-identical images (ulp-level t drift
    only)."""
    a = _render(grid_scene, "xla", h=18, n=4)
    b = _render(grid_scene, "bvh", h=18, n=4)
    diff = np.abs(a - b)
    assert np.quantile(diff, 0.99) < 1e-3, np.quantile(diff, 0.99)


def test_backends_structural_with_glass(scene):
    """Refracted rays re-enter their sphere on an fp knife edge (near root
    i1 within 1 ulp of 0, src/surfaces/sphere.cpp:21-23). The rounding is
    spatially correlated, so differently-fused graphs flip whole regions of
    the glass sphere — the reference's own output depends on the same coin
    (compiler fp flags). Cross-backend agreement with dielectrics is
    therefore only structural: most pixels identical, the rest bounded."""
    a = np.log1p(np.minimum(_render(scene, "xla", n=6), 20.0))
    b = np.log1p(np.minimum(_render(scene, "bvh", n=6), 20.0))
    diff = np.abs(a - b)
    # the bulk of the image is unaffected by the dielectric knife edge...
    assert np.quantile(diff, 0.5) < 1e-3
    # ...and the knife edge is confined to glass/mirror pixels: bound the
    # FRACTION of structurally differing pixels (not just the median) so a
    # genuinely divergent backend (whole image off) fails. Measured level
    # at this config: ~0.10 (the spheres cover ~1/3 of the 24x24 frame).
    frac_diff = (diff.max(axis=-1) > 0.05).mean()
    assert frac_diff < 0.25, f"{frac_diff:.3f} of pixels differ > 0.05"
    assert np.isfinite(b).all()


def test_grad_through_bvh_backend(scene):
    import jax.numpy as jnp

    from plutracer_tpu.parallel.sharded import apply_params, get_params
    from plutracer_tpu.render.renderer import render_pass

    opts = DEFAULT_OPTIONS.replace(intersect_backend="bvh")
    params = get_params(scene)

    def loss(params):
        sc = apply_params(scene, params)
        img = render_pass(sc, jax.random.PRNGKey(0), jnp.int32(0), 24, 24, 1, opts)
        return jnp.sum(jnp.minimum(img, 20.0) ** 2)

    g = jax.grad(loss)(params)
    assert bool(jnp.isfinite(g["mat_color"]).all())
    assert float(jnp.abs(g["mat_color"]).max()) > 0
