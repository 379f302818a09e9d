"""Sharded rendering and inverse-rendering over a device mesh.

Forward: the ray megabatch is sharded over the `tiles` axis and the
stratified passes over the `spp` axis; accumulation is one psum over `spp`.
Backward (inverse rendering): per-shard gradients of the pixel loss w.r.t.
differentiable scene parameters (material albedo, light emission, texture
colors) are psum-all-reduced over both axes — XLA overlaps the collective
with the backward pass.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from plutracer_tpu.ops import intersect
from plutracer_tpu.ops.camera import generate_rays
from plutracer_tpu.render.integrator import ray_color
from plutracer_tpu.render.renderer import pixel_centers
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions


def _pad_to(x, mult: int, axis: int = 0):
    """Pad axis to a multiple of `mult`, preserving host-vs-device-ness.

    Host numpy inputs stay numpy (uncommitted): that matters for
    multi-host, where every process holds the same host bytes so jit can
    assemble the global sharded array locally — a committed single-device
    jnp input cannot be resharded across processes. Device/tracer inputs
    are padded with jnp (no host round-trip on the single-host hot path).
    """
    xp = np if isinstance(x, np.ndarray) else jnp
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return xp.pad(x, widths), n


def check_vma(options) -> bool:
    """shard_map's varying-axes check, off when the closest-hit kernel is in
    the traced program: pallas_call declares no vma on its outputs."""
    return intersect._resolve_backend(options) != "pallas"


def _trace_stratum(scene, px0, stratum, n, key, options):
    """One stratified sample for each pixel in px0. Returns (B,3)."""
    k_px, k_lens, k_path = jax.random.split(key, 3)
    cell = jnp.stack([stratum % n, stratum // n], -1).astype(jnp.float32)
    B = px0.shape[0]
    jit_px = jax.random.uniform(k_px, (B, 2)) * 0.999
    jit_lens = jax.random.uniform(k_lens, (B, 2)) * 0.999
    px = px0 + (cell + jit_px) / n
    lens = (cell + jit_lens) / n
    o, d = generate_rays(scene.camera, px, lens)
    return ray_color(scene, o, d, k_path, options)


def render_sharded(
    scene,
    width: int,
    height: int,
    n: int,
    key,
    mesh: Mesh,
    options: RenderOptions = DEFAULT_OPTIONS,
):
    """Full sharded render -> linear (H, W, 3) image.

    Rays sharded over `tiles`; the n^2 strata are round-robined over `spp`
    and accumulated with a psum.
    """
    d_tiles = mesh.shape["tiles"]
    d_spp = mesh.shape["spp"]
    spp = n * n
    vma = check_vma(options)
    px_pad, n_px = _pad_to(np.asarray(pixel_centers(width, height)), d_tiles)

    strata_pad, _ = _pad_to(np.arange(spp, dtype=np.int32), d_spp)
    local_strata = strata_pad.shape[0] // d_spp

    def shard_fn(px_local, strata_local):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("spp")
        shard_key = jax.random.fold_in(jax.random.fold_in(key, ti), si)

        def body(s, acc):
            stratum = strata_local[s]
            k = jax.random.fold_in(shard_key, s)
            c = _trace_stratum(scene, px_local, stratum, n, k, options)
            valid = stratum < spp  # padding strata contribute nothing
            return acc + jnp.where(valid, 1.0, 0.0) * c

        # the loop body's output is varying over both mesh axes (rays over
        # `tiles`, strata/keys over `spp`), so the init carry must be too
        acc0 = jnp.zeros((px_local.shape[0], 3))
        if vma:
            acc0 = jax.lax.pcast(acc0, ("tiles", "spp"), to="varying")
        acc = jax.lax.fori_loop(0, local_strata, body, acc0)
        return jax.lax.psum(acc, "spp")

    out = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("tiles"), P("spp")),
            out_specs=P("tiles"),
            check_vma=vma,
        )
    )(px_pad, strata_pad)
    if jax.process_count() > 1:
        # the output is globally sharded across processes; gather the full
        # image to every host before the (host-side) slice + reshape
        from jax.experimental import multihost_utils

        out = multihost_utils.process_allgather(out, tiled=True)
    out = np.asarray(out)
    return (out[:n_px] / spp).reshape(height, width, 3)


# ---------------------------------------------------------------------------
# inverse rendering
# ---------------------------------------------------------------------------

DIFFERENTIABLE_FIELDS = ("mat_color", "light_intensity", "tex_c0", "tex_c1")


def get_params(scene) -> Dict[str, Any]:
    """Extract the differentiable parameter pytree from a scene."""
    return {f: getattr(scene, f) for f in DIFFERENTIABLE_FIELDS}


def apply_params(scene, params: Dict[str, Any]):
    """Return a scene with the parameter leaves swapped in."""
    return dataclasses.replace(scene, **params)


def make_train_step(
    scene,
    width: int,
    height: int,
    n: int,
    mesh: Mesh,
    optimizer=None,
    options: RenderOptions = DEFAULT_OPTIONS,
    loss_space: str = "ab",
    trainable=DIFFERENTIABLE_FIELDS,
    grad_mask: Optional[Dict[str, Any]] = None,
    project_nonnegative: bool = False,
    loss_downsample: int = 1,
    loss_clamp: float = 0.0,
):
    """Build a jitted, sharded inverse-rendering step.

    loss_downsample=k (k > 1, single-tile meshes only): average-pool the
    rendered and target LINEAR images over k x k blocks before the loss.
    Pooling commutes with expectation, so the 'ab' product loss stays
    unbiased — its optimum is still the true parameters — while each
    pooled residual averages k^2 pixels of Monte-Carlo noise. This is the
    variance-reduction lever that makes albedo recovery converge: raw
    per-pixel ab residuals are dominated by path-tracing fireflies
    (measured loss ~5e3 vs a signal of O(1)), burying the gradient
    signal-to-noise.

    step(params, opt_state, target, key, stratum) -> (params, opt_state, loss)

    Renders one stratified pass with the given params, compares against the
    target linear image, all-reduces parameter gradients over the mesh, and
    applies the optimizer update (replicated).

    loss_space:
    - "ab" (default): dual-buffer product loss (X_a - t) . (X_b - t) over
      two INDEPENDENT render passes. Its expectation is exactly
      (E[X] - t)^2 per pixel, so the optimum is the true parameters even
      though each X is a noisy Monte-Carlo estimate — a plain MSE of a
      stochastic estimator minimizes squared-bias PLUS estimator variance,
      which biases albedo-like parameters low (variance grows with albedo).
      Costs two renders per step.
    - "linear": naive MSE of one pass (biased by estimator variance).
    - "log": MSE of log1p radiances (bounded dynamic range, but Jensen- and
      variance-biased; useful for very high-dynamic-range emissive scenes).
    trainable: parameter fields to update (others get zero gradients).
    grad_mask: optional per-entry 0/1 mask (same field names/shapes as the
      params, broadcastable) multiplied into the gradients — e.g. freeze
      the mirror/glass rows of mat_color while fitting the diffuse walls.
    loss_clamp (> 0): clamp BOTH the rendered and the target linear
      radiance at this value before the loss — a bounded-influence
      firefly clamp. Path-traced radiance is heavy-tailed (degenerate
      specular chains reach the 1e12 throughput clamp), and under that
      skew adam's sign-following walks parameters AWAY from the optimum:
      measured at 512^2, the unclamped pooled-ab phase-2 runs albedo MAE
      0.115 -> 0.46 MONOTONICALLY while the loss sits at its ~4e7 noise
      floor. (r4's 256^2 run did not show this only because the NaN-step
      rejection was silently dropping exactly the firefly steps; the r5
      NaN fix unmasked the tail.) Clamping both sides keeps the
      objective consistent — its optimum is the parameters matching the
      clamped target, a tiny bias for diffuse-dominated parameters —
      while bounding every sample's influence.
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(1e-2)
    d_tiles = mesh.shape["tiles"]
    if loss_downsample > 1:
        assert d_tiles == 1, (
            "loss_downsample pools the whole image and needs a 1-tile mesh"
        )
        assert height % loss_downsample == 0 and width % loss_downsample == 0
    px_pad, n_px = _pad_to(np.asarray(pixel_centers(width, height)), d_tiles)
    target_spec = P("tiles")

    def _compare(c, t):
        if loss_space == "log":
            c = jnp.log1p(jnp.maximum(c, 0.0))
            t = jnp.log1p(jnp.maximum(t, 0.0))
        return jnp.sum((c - t) ** 2) / (px_pad.shape[0] * 3)

    def shard_loss_grad(params, px_local, target_local, key, stratum):
        ti = jax.lax.axis_index("tiles")
        si = jax.lax.axis_index("spp")
        k = jax.random.fold_in(jax.random.fold_in(key, ti), si)

        def pool(x):
            # k x k average pooling of the flat (H*W, 3) image (see the
            # loss_downsample docstring); only valid on 1-tile meshes
            # where the shard holds the whole image
            kk = loss_downsample
            x = x.reshape(height // kk, kk, width // kk, kk, 3)
            return x.mean(axis=(1, 3)).reshape(-1, 3)

        def clampf(x):
            return jnp.minimum(x, loss_clamp) if loss_clamp > 0 else x

        def local_loss(params):
            sc = apply_params(scene, params)
            if loss_space == "ab":
                ka, kb = jax.random.split(k)
                xa = clampf(_trace_stratum(sc, px_local, stratum, n, ka, options))
                xb = clampf(_trace_stratum(sc, px_local, stratum, n, kb, options))
                if loss_downsample > 1:
                    xa, xb = pool(xa), pool(xb)
                    tl = pool(clampf(target_local))
                else:
                    tl = clampf(target_local)
                da = xa - tl
                db = xb - tl
                # normalize by the GLOBAL (pooled) pixel count so the psum
                # over 'tiles' completes a true mean — da.shape[0] is the
                # per-shard count, which on multi-tile meshes is 1/d_tiles
                # of the image (pooling itself requires d_tiles == 1)
                return jnp.sum(da * db) / (da.shape[0] * 3 * d_tiles)
            c = clampf(_trace_stratum(sc, px_local, stratum, n, k, options))
            # mean over the full (padded) pixel count; psum completes it
            return _compare(c, clampf(target_local))

        loss, grads = jax.value_and_grad(local_loss)(params)
        # Non-finite gradients had two causes, both fixed: (1) the
        # differentiable-t recompute took prim_t_rows' _BIG sentinel onto
        # found=True lanes where the kernel's winner and the XLA accept
        # rules disagreed on a knife edge, putting hit points at ~4e37
        # whose dot products overflow to inf; (2) guard floors (1e-20/1e-30
        # class) whose transposes square the denominator, which flushes to
        # zero (FTZ) -> 0/0 = NaN even on zero-cotangent lanes. (1) is
        # fixed by accepting the recompute only when it agrees the ray
        # hits (integrator.py/intersect.query_closest); (2) by
        # derivative-guarded ops (ops/safemath.py). The counting below is
        # kept as a tripwire: the fraction is psum'd, returned from
        # step.many, surfaced by diff.optimize stats_out, and pinned at 0
        # by tests.
        grads = {
            f: (g if f in trainable else jnp.zeros_like(g))
            for f, g in grads.items()
        }
        if grad_mask is not None:
            # where(), not multiply: masked entries must become 0 even if
            # the unmasked gradient were non-finite
            grads = {
                f: (jnp.where(grad_mask[f] > 0, g, 0.0) if f in grad_mask
                    else g)
                for f, g in grads.items()
            }
        # count non-finites AFTER the trainable filter and grad_mask: a NaN
        # confined to frozen rows or untrained fields cannot update any
        # parameter, so it must neither reject the step (via _apply's
        # nf_frac > 0 gate) nor inflate the reported nonfinite fraction
        nf_count = sum(
            jnp.sum(~jnp.isfinite(g)).astype(jnp.float32)
            for g in grads.values()
        )
        n_entries = sum(g.size for g in grads.values())  # static
        grads = {f: jnp.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                 for f, g in grads.items()}
        loss = jax.lax.psum(loss, "tiles")
        grads = jax.lax.psum(grads, "tiles")
        nf_count = jax.lax.psum(jax.lax.psum(nf_count, "tiles"), "spp")
        # spp axis shards independent strata of the same estimator: average
        loss = jax.lax.pmean(loss, "spp")
        grads = jax.lax.pmean(grads, "spp")
        n_shards = d_tiles * mesh.shape["spp"]
        nf_frac = nf_count / (n_entries * n_shards)
        return loss, grads, nf_frac

    sharded = jax.shard_map(
        shard_loss_grad,
        mesh=mesh,
        in_specs=(P(), P("tiles"), target_spec, P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=check_vma(options),
    )

    def _apply(params, opt_state, loss, grads, nf_frac):
        updates, new_state = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        if project_nonnegative:
            # in-graph projection (albedo/emission/texture colors are
            # physically >= 0): doing it here instead of eagerly in the
            # host loop saves one device round-trip per parameter per step
            new_params = jax.tree.map(lambda x: jnp.maximum(x, 0.0),
                                      new_params)
        # REJECT steps whose backward produced non-finite entries: the
        # sanitizer has already zeroed them, but an all-zero update still
        # advances adam's count (decaying lr schedules lose the step) and
        # decays the moments. Skipping the whole update keeps the
        # trajectory identical to one that never drew the bad step.
        bad = nf_frac > 0.0
        keep = lambda old, new: jax.tree.map(
            lambda a, b: jnp.where(bad, a, b), old, new
        )
        params = keep(params, new_params)
        opt_state = keep(opt_state, new_state)
        return params, opt_state, loss

    @jax.jit
    def _step(params, opt_state, tgt_pad, key, stratum):
        loss, grads, nf = sharded(params, px_pad, tgt_pad, key, stratum)
        return _apply(params, opt_state, loss, grads, nf)

    spp = n * n

    @functools.partial(jax.jit, static_argnames=("k_steps",))
    def _steps(params, opt_state, tgt_pad, key0, start, k_steps: int):
        """k_steps optimization steps in ONE device dispatch (lax.scan).

        Bit-identical to calling _step k_steps times with
        key=fold_in(key0, i), stratum=i%spp for i=start..start+k-1, without
        a host round-trip per step. Returns per-step losses (k_steps,)."""

        def body(carry, j):
            params, opt_state = carry
            i = start + j
            loss, grads, nf_frac = sharded(
                params, px_pad, tgt_pad,
                jax.random.fold_in(key0, i),
                jnp.asarray(i % spp, jnp.int32),
            )
            params, opt_state, loss = _apply(
                params, opt_state, loss, grads, nf_frac
            )
            return (params, opt_state), (loss, nf_frac)

        (params, opt_state), (losses, nf_fracs) = jax.lax.scan(
            body, (params, opt_state), jnp.arange(k_steps)
        )
        return params, opt_state, losses, nf_fracs

    def step(params, opt_state, target_flat, key, stratum):
        # pad on host (numpy): keeps the target uncommitted so the global
        # P("tiles") sharding works across processes (see _pad_to)
        tgt_pad, _ = _pad_to(target_flat, d_tiles)
        return _step(params, opt_state, tgt_pad, key, stratum)

    def steps(params, opt_state, target_flat, key0, start: int, k_steps: int):
        """Run steps start..start+k_steps-1 in one dispatch; same RNG
        stream as the single-step API (key=fold_in(key0, i), i%spp).
        Returns (params, opt_state, losses (k,), nonfinite_grad_fracs (k,))
        — the last is the fraction of gradient entries sanitized by
        nan_to_num per step (see shard_loss_grad)."""
        tgt_pad, _ = _pad_to(target_flat, d_tiles)
        return _steps(params, opt_state, tgt_pad, key0,
                      jnp.int32(start), k_steps)

    def init(params):
        return optimizer.init(params)

    step.init = init
    step.many = steps
    return step
