"""Gradient checks: pixel-loss gradients vs central finite differences.

BASELINE.md target: pixel gradients w.r.t. material albedo, light emission,
and texture parameters allclose vs finite differences. The estimator is
deterministic given a fixed key (counter-based RNG), so AD and FD evaluate
the *same* function and should match to FD truncation error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plutracer_tpu.parallel.sharded import apply_params, get_params
from plutracer_tpu.render.renderer import pixel_centers, render_pass
from plutracer_tpu.scene import compile_scene, load_scene_file
from plutracer_tpu.semantics import DEFAULT_OPTIONS


def make_loss(scene_path, w=24, h=18, n=2, seed=0):
    d = load_scene_file(scene_path, ["/res", f"{w}x{h}"])
    scene = compile_scene(d)
    key = jax.random.PRNGKey(seed)

    def loss(params):
        sc = apply_params(scene, params)
        img = render_pass(sc, key, jnp.int32(1), w, h, n)
        # clip super-bright emissive pixels (Lemit up to 1e4): they dominate
        # the float32 loss and sink the finite-difference signal below the
        # rounding noise. Gradients flow through the unclipped pixels.
        img = jnp.minimum(img, 20.0)
        return jnp.sum(img * img) / img.size

    return scene, loss


def fd_grad(loss, params, field, idx, eps=1e-2):
    # relative step: parameters span 0.05 (albedo) to 1e4 (emission)
    eps = eps * max(1.0, abs(float(params[field][idx])))
    p_plus = dict(params)
    p_minus = dict(params)
    delta = jnp.zeros_like(params[field]).at[idx].set(eps)
    p_plus[field] = params[field] + delta
    p_minus[field] = params[field] - delta
    return (float(loss(p_plus)) - float(loss(p_minus))) / (2 * eps)


@pytest.mark.parametrize(
    "scene_path,field,idx",
    [
        ("/root/reference/scenes/minimal1.urn", "mat_color", (1, 0)),
        ("/root/reference/scenes/minimal1.urn", "light_intensity", (0, 1)),
        ("/root/reference/scenes/minimal0.urn", "mat_color", (1, 2)),
        ("/root/reference/scenes/minimal0.urn", "light_intensity", (0, 0)),
        ("/root/reference/scenes/room.urn", "tex_c1", (0, 0)),
        ("/root/reference/scenes/room.urn", "mat_color", (2, 1)),
    ],
)
def test_grad_matches_fd(scene_path, field, idx):
    scene, loss = make_loss(scene_path)
    params = get_params(scene)
    g_ad = jax.grad(loss)(params)[field][idx]
    g_fd = fd_grad(loss, params, field, idx)
    assert np.isfinite(float(g_ad))
    if abs(g_fd) < 1e-7 and abs(float(g_ad)) < 1e-7:
        return  # both zero: parameter unreachable from these pixels
    np.testing.assert_allclose(float(g_ad), g_fd, rtol=2e-2, atol=1e-6)


def test_grad_emission_scales_linearly():
    # radiance is linear in Lemit along direct-view paths: d(sum)/dLemit
    # constant w.r.t. Lemit scale
    scene, loss = make_loss("/root/reference/scenes/minimal1.urn")
    params = get_params(scene)

    def total(params):
        sc = apply_params(scene, params)
        img = render_pass(sc, jax.random.PRNGKey(0), jnp.int32(1), 24, 18, 2)
        return jnp.sum(img)

    g1 = jax.grad(total)(params)["light_intensity"]
    params2 = dict(params)
    params2["light_intensity"] = params["light_intensity"] * 2.0
    g2 = jax.grad(total)(params2)["light_intensity"]
    # gradient wrt emission shouldn't change as emission scales (affine term)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-4)


def test_grads_finite_all_scenes():
    import pathlib

    for p in sorted(pathlib.Path("/root/reference/scenes").glob("*.urn")):
        if p.stem == "test1":
            continue  # 258 prims: slow on CPU
        scene, loss = make_loss(str(p), w=16, h=12, n=1)
        params = get_params(scene)
        g = jax.grad(loss)(params)
        for k, v in g.items():
            assert bool(jnp.isfinite(v).all()), f"{p.stem}: NaN in {k}"


def test_safemath_derivative_guards():
    """ops/safemath: primals bit-identical to the plain ops; transposes
    finite where the plain ops NaN. The plain patterns fail on CPU too
    (XLA flushes f32 denormals): grad of where(False, x/y, 0) at
    y=1e-20 is NaN because the transpose divides by y**2 = 0."""
    import jax.numpy as jnp

    from plutracer_tpu.ops import safemath

    mask = jnp.array(False)
    x = jnp.float32(3.0)

    # the raw pattern really is NaN-capable on this backend (guards the
    # test's own premise)
    g_raw = jax.grad(lambda y: jnp.sum(jnp.where(mask, x / y, 0.0)))(
        jnp.float32(1e-20)
    )
    assert not np.isfinite(float(g_raw))

    # zero-cotangent lanes: exact 0 gradients, never NaN
    g = jax.grad(lambda y: jnp.sum(jnp.where(mask, safemath.safe_div(x, y),
                                             0.0)))(jnp.float32(1e-20))
    assert float(g) == 0.0
    g = jax.grad(lambda y: jnp.sum(jnp.where(mask, safemath.safe_recip(y),
                                             0.0)))(jnp.float32(1e-20))
    assert float(g) == 0.0
    g = jax.grad(lambda u: jnp.sum(jnp.where(mask, safemath.safe_rsqrt(u),
                                             0.0)))(jnp.float32(1e-30))
    assert float(g) == 0.0

    # primals bit-identical to the plain ops
    ys = jnp.asarray([1e-20, 1e-3, 0.5, -2.0, 3e7], jnp.float32)
    np.testing.assert_array_equal(np.asarray(safemath.safe_div(x, ys)),
                                  np.asarray(x / ys))
    np.testing.assert_array_equal(np.asarray(safemath.safe_recip(ys)),
                                  np.asarray(1.0 / ys))
    us = jnp.asarray([1e-30, 1e-6, 1.0, 9.0], jnp.float32)
    np.testing.assert_array_equal(np.asarray(safemath.safe_rsqrt(us)),
                                  np.asarray(jax.lax.rsqrt(us)))

    # derivatives exact away from the guard floors (vs finite diff)
    for y0 in (0.37, -1.4):
        g = float(jax.grad(lambda y: safemath.safe_div(x, y))(jnp.float32(y0)))
        assert abs(g - (-3.0 / y0 ** 2)) < 1e-3 * abs(g)
    g = float(jax.grad(safemath.safe_rsqrt)(jnp.float32(4.0)))
    assert abs(g - (-0.5 * 4.0 ** -1.5)) < 1e-6
