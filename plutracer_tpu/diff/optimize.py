"""Inverse rendering: fit scene parameters to a target image.

The BASELINE "cornell-box inverse rendering" config: optimize material
albedo + light emission from a target image, sharded over a device mesh.
Gradients flow through the full path-tracing estimator (NEE + MIS + bounce
scan); per-pass stochasticity acts as minibatch noise for the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from plutracer_tpu.parallel.mesh import make_mesh
from plutracer_tpu.parallel.sharded import (
    apply_params,
    get_params,
    make_train_step,
)
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions


@dataclasses.dataclass
class InverseRenderConfig:
    width: int = 128
    height: int = 128
    n: int = 2  # stratified grid per step (spp = n^2 per estimator pass)
    steps: int = 200
    learning_rate: float = 5e-3
    seed: int = 0
    mesh_shape: Optional[tuple] = None  # default: all devices on `tiles`
    log_every: int = 20
    options: RenderOptions = DEFAULT_OPTIONS
    loss_space: str = "ab"
    trainable: tuple = ("mat_color", "light_intensity", "tex_c0", "tex_c1")
    # project parameters to be nonnegative after each update (albedo,
    # emission, and texture colors are physically >= 0)
    project_nonnegative: bool = True
    # optional optax optimizer (overrides the default adam(learning_rate));
    # use e.g. optax.multi_transform for per-field learning rates when the
    # parameter scales differ by orders of magnitude (emission ~500 vs
    # albedo ~0.2)
    optimizer: Optional[object] = None
    # optional per-entry 0/1 gradient mask (see make_train_step)
    grad_mask: Optional[Dict] = None
    # k x k average-pool rendered/target images before the ab loss
    # (unbiased variance reduction; see make_train_step)
    loss_downsample: int = 1
    # firefly clamp: bound both rendered and target linear radiance
    # before the loss (bounded-influence estimator; see make_train_step)
    loss_clamp: float = 0.0
    # checkpoint/resume for long training jobs (the training analog of
    # render/elastic.py): params + optimizer state + step counter are
    # serialized after every chunk; an interrupted optimize_scene resumes
    # bit-exactly (chunk boundaries are absolute, the RNG is counter-based
    # in the absolute step index, and the state round-trips exactly)
    checkpoint_path: Optional[str] = None


def _save_train_ckpt(path, params, opt_state, next_i, seed, losses, nf_fracs):
    """Atomic checkpoint: params dict + flattened optimizer-state leaves
    (the treedef is reproducible from step.init on load) + progress."""
    import os

    oleaves = jax.tree_util.tree_leaves(opt_state)
    payload = {f"param_{k}": np.asarray(v) for k, v in params.items()}
    payload.update({f"opt_{i}": np.asarray(x) for i, x in enumerate(oleaves)})
    tmp = path + ".tmp"
    np.savez(
        tmp, next_i=next_i, seed=seed,
        losses=np.asarray(losses, np.float64),
        nf_fracs=np.asarray(nf_fracs, np.float64),
        param_keys=np.asarray(sorted(params.keys())),
        n_opt_leaves=len(oleaves),
        **payload,
    )
    os.replace(tmp + ".npz", path)


def _load_train_ckpt(path, opt_state_template, seed):
    z = np.load(path, allow_pickle=False)
    if int(z["seed"]) != seed:
        raise ValueError(f"checkpoint seed {int(z['seed'])} != config {seed}")
    params = {str(k): jnp.asarray(z[f"param_{k}"]) for k in z["param_keys"]}
    treedef = jax.tree_util.tree_structure(opt_state_template)
    n = int(z["n_opt_leaves"])
    opt_state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(z[f"opt_{i}"]) for i in range(n)]
    )
    return (
        params, opt_state, int(z["next_i"]),
        z["losses"].tolist(), z["nf_fracs"].tolist(),
    )


def optimize_scene(
    scene,
    target_linear,
    config: InverseRenderConfig = InverseRenderConfig(),
    init_params: Optional[Dict] = None,
    callback: Optional[Callable[[int, float, Dict], None]] = None,
    stats_out: Optional[Dict] = None,
):
    """Run the inverse-rendering loop.

    target_linear: (H, W, 3) linear-radiance target image.
    Returns (params, losses). If stats_out is a dict, records
    'nonfinite_grad_frac_mean'/'_max' — the fraction of gradient entries
    sanitized per step (should be 0; nonzero means the backward emitted
    NaN/Inf lanes that nan_to_num zeroed — see sharded.shard_loss_grad).
    """
    import optax

    mesh = make_mesh(config.mesh_shape)
    opt = config.optimizer or optax.adam(config.learning_rate)
    step = make_train_step(
        scene, config.width, config.height, config.n, mesh, optimizer=opt,
        options=config.options, loss_space=config.loss_space,
        trainable=config.trainable, grad_mask=config.grad_mask,
        project_nonnegative=config.project_nonnegative,
        loss_downsample=config.loss_downsample,
        loss_clamp=config.loss_clamp,
    )
    import os

    params = init_params if init_params is not None else get_params(scene)
    opt_state = step.init(params)
    target_flat = jnp.asarray(np.asarray(target_linear).reshape(-1, 3))
    key = jax.random.PRNGKey(config.seed)
    losses: List[float] = []
    # chunked: log_every optimization steps per device dispatch (lax.scan
    # inside the jit — see make_train_step.many). The per-step host loop
    # used to cost one dispatch + one scalar sync + 4 eager projection ops
    # per step.
    chunk = max(1, config.log_every)
    nf_fracs: List[float] = []
    i = 0
    ckpt = config.checkpoint_path
    if ckpt and os.path.exists(ckpt):
        params, opt_state, i, losses, nf_fracs = _load_train_ckpt(
            ckpt, opt_state, config.seed
        )
    while i < config.steps:
        # first chunk is a single step so the callback cadence matches the
        # historical per-step loop (fires at steps 0, log_every, 2*log_every
        # ..., last)
        k = 1 if i == 0 else min(chunk, config.steps - i)
        params, opt_state, loss_k, nf_k = step.many(
            params, opt_state, target_flat, key, i, k
        )
        losses.extend(np.asarray(loss_k, np.float64).tolist())
        nf_fracs.extend(np.asarray(nf_k, np.float64).tolist())
        if callback:
            callback(i + k - 1, losses[-1], params)
        i += k
        if ckpt:
            # checkpoints land on chunk boundaries, so a resumed run
            # re-issues the identical step.many programs (bit-exact)
            jax.block_until_ready(params)
            _save_train_ckpt(
                ckpt, params, opt_state, i, config.seed, losses, nf_fracs
            )
    if stats_out is not None:
        # steps == 0 is degenerate-but-legal: report 0.0, not np.mean([])
        stats_out["nonfinite_grad_frac_mean"] = (
            float(np.mean(nf_fracs)) if nf_fracs else 0.0
        )
        stats_out["nonfinite_grad_frac_max"] = (
            float(np.max(nf_fracs)) if nf_fracs else 0.0
        )
    return params, losses
