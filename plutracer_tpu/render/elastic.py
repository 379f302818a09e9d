"""Elastic, fault-tolerant progressive rendering.

The reference has NO failure handling (SURVEY §5): `main.cpp` throws bare
exceptions on malformed scenes and a crash mid-render loses everything
(src/renderer.cpp:98-151 streams tiles into an in-memory framebuffer that
dies with the process). Here the stratified PASS is the unit of
migration:

- Pass ``s`` is a *full-image* program keyed by ``fold_in(key, s)`` — the
  exact per-pass sample stream of ``renderer.render_passes`` — so a pass
  produces bit-identical radiance no matter which device (or how many
  devices) computes it.
- A chunk of passes is sharded over a 1-D ``spp`` device mesh with
  ``shard_map``; each device returns its passes *unsummed* and the host
  accumulates them in stratum order with sequential float32 adds — the
  same reduction order as the single-device ``lax.scan`` accumulator.
- Render state is therefore device-topology-free: ``(accum, next_pass,
  seed)``. A job checkpointed on an 8-device mesh resumes on 4 devices,
  1 device, or a CPU host and the final image is unchanged (the supervisor
  tests assert bit-equality through a crash + re-mesh history).

``render/supervisor.py`` builds failure *detection* (exit codes +
heartbeat-stall) and automatic restart on top of this module.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from plutracer_tpu.parallel.sharded import check_vma
from plutracer_tpu.render.progressive import load_state, save_state
from plutracer_tpu.render.renderer import _trace_stratum, pixel_centers
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions

__all__ = ["render_elastic", "pass_stack"]


def pass_stack(
    scene,
    key,
    strata: np.ndarray,
    width: int,
    height: int,
    n: int,
    options: RenderOptions,
    mesh: Mesh,
):
    """Render the given strata as a stacked (len(strata), H*W, 3) array.

    Strata are distributed over the mesh's ``spp`` axis in contiguous
    blocks; every device evaluates the same full-image per-pass program
    as ``renderer.render_passes`` (``fold_in(key, s)`` then
    ``_trace_stratum`` over all pixels), so row ``i`` of the result is
    bit-identical regardless of the mesh size. Padding rows (added to
    make the strata count divide the device count) are returned too —
    callers slice them off; their contents are unspecified.
    """
    d = mesh.shape["spp"]
    strata = np.asarray(strata, np.int32)
    pad = (-len(strata)) % d
    strata_pad = np.concatenate([strata, strata[-1:].repeat(pad)]) if pad else strata

    def shard_fn(strata_local):
        def body(_, s):
            k = jax.random.fold_in(key, s)
            px0 = pixel_centers(width, height)
            return None, _trace_stratum(scene, px0, k, s, n, options)

        _, stack = jax.lax.scan(body, None, strata_local)
        return stack  # (k_local, H*W, 3)

    out = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("spp"),),
            out_specs=P("spp"),
            check_vma=check_vma(options),
        )
    )(strata_pad)
    return np.asarray(out)


def _parse_fault() -> Optional[tuple]:
    """Fault injection for the supervisor tests: PLUTRACER_FAULT=
    "crash:N" | "hang:N" faults after the chunk containing pass N is
    rendered but BEFORE its checkpoint is saved — the work since the last
    checkpoint is genuinely lost, which is the failure the supervisor
    must recover from. The supervisor sets this env only on the first
    launch, so the restarted worker runs clean."""
    spec = os.environ.get("PLUTRACER_FAULT", "")
    if not spec:
        return None
    kind, _, at = spec.partition(":")
    return (kind, int(at))


def render_elastic(
    scene,
    width: int,
    height: int,
    n: int,
    seed: int = 0,
    *,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    options: RenderOptions = DEFAULT_OPTIONS,
    devices: Optional[Sequence] = None,
    on_chunk: Optional[Callable[[int], None]] = None,
):
    """Render n^2 stratified passes over an elastic ``spp`` device mesh.

    Equivalent to ``renderer.render`` (same per-pass sample stream, same
    stratum-order float32 accumulation), but the pass set is sharded over
    ``devices`` (default: all local devices) and the accumulator lives on
    the host, so the checkpoint is valid for ANY later device topology.
    ``on_chunk(next_pass)`` fires after each checkpointed chunk — the
    supervisor worker uses it as a liveness heartbeat.

    Returns the linear (H, W, 3) image as a host numpy array.
    """
    devs = list(devices) if devices is not None else jax.devices()
    mesh = Mesh(np.asarray(devs), ("spp",))
    spp = n * n
    checkpoint_every = max(1, checkpoint_every)
    key = jax.random.PRNGKey(seed)
    accum = np.zeros((height * width, 3), np.float32)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck_accum, start, ck_seed = load_state(checkpoint_path)
        if ck_seed != seed:
            raise ValueError(f"checkpoint seed {ck_seed} != requested {seed}")
        accum = np.asarray(ck_accum, np.float32)
    fault = _parse_fault()
    s = start
    while s < spp:
        # chunk boundaries are absolute multiples of checkpoint_every, so a
        # resumed run re-issues the identical per-chunk programs
        k = min(checkpoint_every - s % checkpoint_every, spp - s)
        stack = pass_stack(
            scene, key, np.arange(s, s + k), width, height, n, options, mesh
        )
        for i in range(k):  # stratum-order sequential f32 adds
            accum = accum + stack[i]
        s += k
        if fault is not None and s > fault[1]:
            if fault[0] == "hang":
                while True:  # heartbeat goes stale; supervisor must kill us
                    time.sleep(1.0)
            os._exit(13)
        if checkpoint_path:
            save_state(checkpoint_path, accum, s, seed)
        if on_chunk is not None:
            on_chunk(s)
    return (accum / np.float32(spp)).reshape(height, width, 3)
