"""Progressive, checkpointable rendering.

The reference has no checkpoint/resume at all (SURVEY §5); partial renders
die with the process. Here the sample accumulator + pass counter + seed are
serialized after every stratified pass, so an interrupted render resumes
exactly (the RNG is counter-based: pass s always uses fold_in(key, s)).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from plutracer_tpu.render.renderer import PASS_CHUNK, _finalize, render_passes
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions


def save_state(path: str, accum, next_pass: int, seed: int) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, accum=np.asarray(accum), next_pass=next_pass, seed=seed)
    os.replace(tmp + ".npz", path)


def load_state(path: str):
    z = np.load(path)
    return jnp.asarray(z["accum"]), int(z["next_pass"]), int(z["seed"])


def render_with_checkpoint(
    scene,
    width: int,
    height: int,
    n: int,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    options: RenderOptions = DEFAULT_OPTIONS,
):
    """Render n^2 stratified passes; optionally resume from / write to a
    checkpoint file. Returns the linear (H, W, 3) image."""
    from plutracer_tpu.render.renderer import zeros_accum

    spp = n * n
    key = jax.random.PRNGKey(seed)
    accum = zeros_accum(width, height)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        accum, start, ck_seed = load_state(checkpoint_path)
        if ck_seed != seed:
            raise ValueError(
                f"checkpoint seed {ck_seed} != requested seed {seed}"
            )
        print(f"resuming at pass {start}/{spp}")
    # strata are dispatched in chunks (one lax.scan per device program, see
    # renderer.render_passes) — bit-identical to per-pass dispatch with
    # fewer host round-trips. Checkpoints land on chunk
    # boundaries, aligned to checkpoint_every when checkpointing is on.
    chunk = min(PASS_CHUNK, checkpoint_every) if checkpoint_path else PASS_CHUNK
    s = start
    while s < spp:
        k = min(chunk, spp - s)
        if checkpoint_path:
            # align to the next checkpoint_every boundary for exact resume
            k = min(k, checkpoint_every - s % checkpoint_every)
        accum = render_passes(
            scene, key, jnp.int32(s), width, height, n, k, options, accum=accum
        )
        s += k
        if checkpoint_path and (s % checkpoint_every == 0 or s == spp):
            accum.block_until_ready()
            save_state(checkpoint_path, accum, s, seed)
    return _finalize(accum, jnp.float32(spp), width, height)
