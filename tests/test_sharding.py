"""Sharded rendering + training tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plutracer_tpu.parallel import make_mesh, make_train_step, render_sharded
from plutracer_tpu.parallel.sharded import apply_params, get_params
from plutracer_tpu.render.renderer import render
from plutracer_tpu.scene import compile_scene, load_scene_file


@pytest.fixture(scope="module")
def scene(scenes_dir):
    d = load_scene_file(str(scenes_dir / "demo-box.urn"), ["/res", "32x24"])
    return compile_scene(d)


def test_mesh_shapes(eight_devices):
    m = make_mesh()
    assert m.shape["tiles"] == 8 and m.shape["spp"] == 1
    m2 = make_mesh((4, 2))
    assert m2.shape["tiles"] == 4 and m2.shape["spp"] == 2


def _blocks(x, k=8):
    h, w, c = x.shape
    h, w = h - h % k, w - w % k
    return x[:h, :w].reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))


def test_sharded_render_matches_mean(scene, eight_devices):
    """Sharded render must estimate the SAME image as the single-device
    renderer. Bounds are calibrated from the single-device renderer's own
    seed-to-seed Monte-Carlo noise at identical total spp, so a broken
    psum / shard indexing (wrong strata weighting, dropped or doubled
    tiles) fails while honest MC noise passes."""
    m = make_mesh((4, 2))
    n = 4  # 16 spp everywhere
    a = np.log1p(np.maximum(np.asarray(
        render_sharded(scene, 32, 24, n, jax.random.PRNGKey(0), m)), 0))
    b1 = np.log1p(np.maximum(np.asarray(
        render(scene, 32, 24, n, jax.random.PRNGKey(1))), 0))
    b2 = np.log1p(np.maximum(np.asarray(
        render(scene, 32, 24, n, jax.random.PRNGKey(2))), 0))
    assert a.shape == (24, 32, 3)
    assert np.isfinite(a).all()
    noise_px = np.abs(b1 - b2).mean()
    noise_blk = np.abs(_blocks(b1) - _blocks(b2)).mean()
    dist_px = np.abs(a - b1).mean()
    dist_blk = np.abs(_blocks(a) - _blocks(b1)).mean()
    assert dist_px <= 1.75 * noise_px + 1e-3, (dist_px, noise_px)
    assert dist_blk <= 1.75 * noise_blk + 1e-3, (dist_blk, noise_blk)
    # a dropped/doubled shard shifts global brightness far beyond noise
    assert abs(a.mean() - b1.mean()) <= 1.75 * abs(b1.mean() - b2.mean()) + 5e-3


def test_sharded_render_tiles_only(scene, eight_devices):
    m = make_mesh((8, 1))
    img = render_sharded(scene, 32, 24, 2, jax.random.PRNGKey(0), m)
    assert np.isfinite(np.asarray(img)).all()


def test_train_step_reduces_loss(scene, eight_devices):
    m = make_mesh((4, 2))
    # target: render with TRUE albedo; start from perturbed albedo
    target = render(scene, 32, 24, 3, jax.random.PRNGKey(5))
    target_flat = jnp.asarray(np.asarray(target).reshape(-1, 3))
    step = make_train_step(scene, 32, 24, 3, m)
    true_params = get_params(scene)
    params = dict(true_params)
    params["mat_color"] = params["mat_color"] * 0.3
    opt_state = step.init(params)
    losses = []
    for i in range(8):
        params, opt_state, loss = step(
            params, opt_state, target_flat, jax.random.PRNGKey(100 + i),
            jnp.int32(i % 9),
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_gradients_flow_to_emission(scene, eight_devices):
    """d(loss)/d(light_intensity) must be nonzero: emission is reachable."""
    import jax

    from plutracer_tpu.parallel.sharded import _trace_stratum

    params = get_params(scene)

    def loss(params):
        sc = apply_params(scene, params)
        from plutracer_tpu.render.renderer import pixel_centers

        px = pixel_centers(32, 24)
        c = _trace_stratum(sc, px, jnp.int32(0), 2, jax.random.PRNGKey(0),
                           __import__("plutracer_tpu.semantics", fromlist=["DEFAULT_OPTIONS"]).DEFAULT_OPTIONS)
        return jnp.sum(c)

    g = jax.grad(loss)(params)
    assert float(jnp.abs(g["light_intensity"]).max()) > 0
    assert float(jnp.abs(g["mat_color"]).max()) > 0


def test_no_sanitized_gradient_lanes_cpu(eight_devices, scenes_dir):
    """The flagship train step must not rely on the non-finite gradient
    sanitizer: every zeroed entry is a wasted/biased step. Non-finite
    gradient entries are counted and surfaced via step.many / stats_out
    (sharded.shard_loss_grad); this test pins the count at exactly zero so
    the graph can't regress into producing them."""
    import jax
    import numpy as np

    from plutracer_tpu.parallel.mesh import make_mesh
    from plutracer_tpu.parallel.sharded import get_params, make_train_step
    from plutracer_tpu.render.renderer import render
    from plutracer_tpu.scene import compile_scene, load_scene_file

    scene = compile_scene(
        load_scene_file(str(scenes_dir / "demo-box.urn"), ["/res", "32x32"])
    )
    target = np.asarray(render(scene, 32, 32, 2, jax.random.PRNGKey(5)))
    step = make_train_step(
        scene, 32, 32, 2, make_mesh((4, 2)), loss_space="log",
        trainable=("mat_color", "light_intensity"),
    )
    params = get_params(scene)
    opt_state = step.init(params)
    _, _, losses, nf = step.many(
        params, opt_state, target.reshape(-1, 3), jax.random.PRNGKey(0), 0, 6
    )
    assert np.isfinite(np.asarray(losses)).all()
    assert float(np.asarray(nf).max()) == 0.0, np.asarray(nf)
