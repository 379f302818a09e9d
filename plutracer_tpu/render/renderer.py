"""Render driver: stratified multi-pass accumulation over pixel megabatches.

The reference splits the image into 32x32 tiles pulled by a thread pool
(src/renderer.cpp:98-151); each pixel gets an N x N stratified jittered
sample grid (spp = N^2, src/main.cpp:170). Here the whole image is one
megabatch of rays per stratum: pass s handles stratum cell (s%N, s//N) for
every pixel at once, and the N^2 passes accumulate into the framebuffer.
Each pass is one jit-compiled XLA program; passes are independent, which
also gives progressive (checkpointable) rendering for free.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from plutracer_tpu.ops.camera import generate_rays
from plutracer_tpu.render.integrator import ray_color
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions


def pixel_centers(width: int, height: int):
    """(H*W, 2) integer pixel coordinates (x, y)."""
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)
    return jnp.stack([gx.ravel(), gy.ravel()], -1)


def _trace_stratum(scene, px0, key, stratum, n: int, options: RenderOptions):
    """One stratified sample per pixel from the given stratum cell."""
    B = px0.shape[0]
    k_px, k_lens, k_path = jax.random.split(key, 3)
    # jittered stratified offsets: (cell + u*0.999)/n  (inc/sampler.h:44-50)
    cell = jnp.stack([stratum % n, stratum // n], -1).astype(jnp.float32)
    jit_px = jax.random.uniform(k_px, (B, 2)) * 0.999
    jit_lens = jax.random.uniform(k_lens, (B, 2)) * 0.999
    px = px0 + (cell + jit_px) / n
    lens = (cell + jit_lens) / n
    o, d = generate_rays(scene.camera, px, lens)
    return ray_color(scene, o, d, k_path, options)


@functools.partial(jax.jit, static_argnames=("width", "height", "n", "options"))
def render_pass(
    scene,
    key,
    stratum: jnp.ndarray,
    width: int,
    height: int,
    n: int,
    options: RenderOptions = DEFAULT_OPTIONS,
):
    """One stratified pass: every pixel gets one sample from the given
    stratum cell. Returns (H*W, 3) radiance."""
    px0 = pixel_centers(width, height)
    return _trace_stratum(scene, px0, key, stratum, n, options)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def zeros_accum(width: int, height: int):
    """Device-side (H*W, 3) zero accumulator (no host transfer)."""
    return jnp.zeros((height * width, 3))


@functools.partial(
    jax.jit, static_argnames=("width", "height", "n", "k_passes", "options")
)
def render_passes(
    scene,
    key,
    start: jnp.ndarray,
    width: int,
    height: int,
    n: int,
    k_passes: int,
    options: RenderOptions = DEFAULT_OPTIONS,
    accum: Optional[jnp.ndarray] = None,
):
    """k_passes stratified passes (strata start..start+k) accumulated into
    `accum` in ONE device dispatch via lax.scan. Bit-identical to summing
    render_pass over the same strata (same fold_in(key, s) per pass), but
    amortizes the per-dispatch overhead that dominated small renders (the
    reference, by contrast, has no dispatch at all — renderer.cpp:98-151
    streams tiles). Threading `accum` through the jit keeps a multi-chunk
    render free of eager device ops; with accum=None a fresh sum is
    returned (a second compiled variant — avoid in hot paths)."""
    px0 = pixel_centers(width, height)

    def body(acc, s):
        k = jax.random.fold_in(key, s)
        return acc + _trace_stratum(scene, px0, k, s, n, options), None

    acc0 = jnp.zeros((height * width, 3)) if accum is None else accum
    acc, _ = jax.lax.scan(body, acc0, start + jnp.arange(k_passes))
    return acc


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _finalize(accum, spp, width: int, height: int):
    # divide (not multiply-by-reciprocal): bit-identical to the historical
    # accum / spp average
    return (accum / spp).reshape(height, width, 3)


# strata per device dispatch: amortizes the per-dispatch host overhead while
# keeping checkpoint granularity and at most two compiled program shapes
# (chunk + remainder) per config
PASS_CHUNK = 16


def render(
    scene,
    width: int,
    height: int,
    n: int,
    key,
    options: RenderOptions = DEFAULT_OPTIONS,
    accum: Optional[jnp.ndarray] = None,
    start_pass: int = 0,
):
    """Full render: N^2 stratified passes accumulated, averaged by 1/spp.

    Returns the linear-radiance image (H, W, 3). `accum`/`start_pass` resume
    a partial render (progressive checkpointing).
    """
    spp = n * n
    if accum is None:
        accum = zeros_accum(width, height)
    s = start_pass
    while s < spp:
        k = min(PASS_CHUNK, spp - s)
        accum = render_passes(
            scene, key, jnp.int32(s), width, height, n, k, options, accum=accum
        )
        s += k
    return _finalize(accum, jnp.float32(spp), width, height)


def render_image(
    scene,
    width: int,
    height: int,
    n: int,
    seed: int = 0,
    options: RenderOptions = DEFAULT_OPTIONS,
):
    """Render + tonemap, returning a displayable (H, W, 3) image in [0,1]."""
    from plutracer_tpu.ops.tonemap import postprocess_image

    key = jax.random.PRNGKey(seed)
    linear = render(scene, width, height, n, key, options)
    return postprocess_image(linear)
