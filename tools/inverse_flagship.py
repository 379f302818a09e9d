#!/usr/bin/env python
"""Flagship inverse rendering at scale (BASELINE.md final row).

Recover the diffuse albedos (``mat_color``) and the area-light emission
(``light_intensity``) of a scene (default scenes/demo-box.urn) from a
rendered target image, with gradients flowing through the full NEE+MIS
path-tracing estimator. Two phases:

1. LOG loss, decaying-lr adam on emission: robust while emission is 4x
   off, converges it to ~2% rel err — but its Jensen/variance bias puts
   the ALBEDO optimum below truth, so phase 1 cannot finish the job.
2. Pooled unbiased 'ab' product loss at high spp: average-pooling the
   linear images (unbiased — pooling commutes with expectation) plus
   64 spp per buffer lifts the gradient SNR enough for adam to descend
   the true optimum without the skew-driven walk-away.

Mirror/glass tints stay frozen via the per-row gradient mask; per-field
adam lrs via optax.multi_transform; steps with non-finite gradients are
rejected wholesale by make_train_step.

Writes the convergence curve + per-parameter recovery errors to a json
file (--out) and (optionally) target/initial/recovered BMPs.

Reference being inverted: the estimator of src/renderer.cpp:59-96; the
reference has no differentiable mode — this capability is new here
(jax.grad through the bounce scan).

Usage: python tools/inverse_flagship.py [--res 512] [--steps 1500]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from plutracer_tpu.diff import InverseRenderConfig, optimize_scene
from plutracer_tpu.parallel.sharded import get_params
from plutracer_tpu.render.renderer import render
from plutracer_tpu.scene import compile_scene, load_scene_file
from plutracer_tpu.scene.types import MAT_DIFFUSE


def _albedo_err(params, true_p, diffuse_rows):
    a = np.asarray(params["mat_color"])[diffuse_rows]
    b = np.asarray(true_p["mat_color"])[diffuse_rows]
    return float(np.abs(a - b).mean())


def _emission_err(params, true_p):
    a = np.asarray(params["light_intensity"])
    b = np.asarray(true_p["light_intensity"])
    denom = np.maximum(np.abs(b), 1e-6)
    return float((np.abs(a - b) / denom).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=str(
        Path(__file__).resolve().parent.parent / "scenes" / "demo-box.urn"))
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--target-n", type=int, default=16,
                    help="stratified grid for the target render (spp=n^2)")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--n", type=int, default=2,
                    help="stratified grid per optimization step (spp = n^2 "
                         "per estimator pass; higher = less MC gradient "
                         "noise per step)")
    ap.add_argument("--loss", default="log", choices=["ab", "log", "l2"],
                    help="phase-1 loss: 'log' = log1p-space L2 (bounded "
                         "dynamic range; robust while emission is far off, "
                         "but its Jensen/variance bias pushes albedo LOW — "
                         "the r3 failure mode); 'ab' = dual-buffer unbiased "
                         "product")
    ap.add_argument("--lr-albedo", type=float, default=3e-2)
    ap.add_argument("--lr-emission", type=float, default=20.0,
                    help="initial adam lr for light_intensity (O(500) "
                         "parameter); decays exponentially to ~2%% of this "
                         "by the final step so early steps cover the "
                         "distance and late steps settle")
    ap.add_argument("--phase2-steps", type=int, default=300,
                    help="refinement phase: after phase 1 converges "
                         "emission under the biased-but-robust log loss, "
                         "switch to the UNBIASED 'ab' product loss (its "
                         "expectation is exactly (E[render]-target)^2, so "
                         "the optimum is the true parameters; estimator "
                         "variance no longer biases albedo low) with small "
                         "lrs to recover the albedos. 0 disables.")
    ap.add_argument("--phase2-loss", default="ab", choices=["ab", "log"],
                    help="phase-2 loss: 'ab' unbiased product, or 'log' at "
                         "high spp (its variance bias shrinks as 1/spp) — "
                         "useful with --phase2-lr-emission 0 to refine "
                         "albedo against a frozen converged emission")
    ap.add_argument("--phase2-n", type=int, default=4,
                    help="stratified grid per phase-2 step (spp = n^2): "
                         "more spp tames the ab-loss's variance")
    ap.add_argument("--phase2-downsample", type=int, default=8,
                    help="k x k average-pool images before the phase-2 ab "
                         "loss: unbiased (pooling commutes with E[]), and "
                         "each pooled residual averages k^2 pixels of MC "
                         "noise — the SNR lever that makes albedo converge")
    ap.add_argument("--phase2-lr-albedo", type=float, default=1e-2)
    ap.add_argument("--phase2-lr-emission", type=float, default=1.0)
    ap.add_argument("--phase2-clamp", type=float, default=0.0,
                    help="firefly clamp on linear radiance (render AND "
                         "target) in the phase-2 loss; bounded-influence "
                         "estimator against adam's sign-following walking "
                         "away under heavy-tailed MC noise (see "
                         "make_train_step loss_clamp)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize the bounce scan in the backward "
                         "(jax.checkpoint) — required at 1024^2, where "
                         "the residuals for a 1.05M-ray backward exceed "
                         "device memory (residuals grow with rays x bounces)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-from", default=None,
                    help="resume: initialize parameters from a prior run's "
                         "output json (recovered_albedo/recovered_emission) "
                         "instead of the canonical perturbation")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="crash-resumable training: write per-phase "
                         "optimize_scene checkpoints (params + optimizer "
                         "state + step counter) under DIR; rerunning with "
                         "the same flags resumes bit-exactly, replaying a "
                         "finished phase 1 instantly from its checkpoint")
    ap.add_argument("--out", default="inverse_flagship.json")
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import plutracer_tpu

    plutracer_tpu.enable_compilation_cache()

    import optax

    W = H = args.res
    desc = load_scene_file(args.scene, ["/res", f"{W}x{H}"])
    scene = compile_scene(desc)
    mat_type = np.asarray(scene.mat_type)
    diffuse_rows = np.nonzero(mat_type == MAT_DIFFUSE)[0]
    print(f"[flagship] scene={args.scene} res={W}x{H} "
          f"diffuse_rows={diffuse_rows.tolist()} "
          f"device={jax.devices()[0].platform}", flush=True)

    t0 = time.time()
    target = render(scene, W, H, args.target_n, jax.random.PRNGKey(100))
    target = np.asarray(target)
    t_target = time.time() - t0
    print(f"[flagship] target rendered: {args.target_n ** 2} spp "
          f"in {t_target:.1f}s", flush=True)

    target2 = target
    if args.phase2_clamp > 0:
        # CONSISTENT-ESTIMATOR clamped target for phase 2: average of
        # per-1-spp-pass CLAMPED renders — the same map theta ->
        # E[min(X_1spp, c)] the training loss sees, so the pooled-ab
        # optimum is exactly the true parameters. Clamping a high-spp
        # target instead is asymmetric (the 1-spp estimator loses
        # E[X 1(X>c)] that the concentrated 256-spp pixels keep) and was
        # measured to move the optimum: mean ab loss at truth 1.465 vs
        # 1.423 at flat-grey albedo -> phase 2 walked AWAY from truth.
        import functools
        import jax.numpy as jnp

        from plutracer_tpu.render.renderer import (_trace_stratum,
                                                   pixel_centers)
        from plutracer_tpu.semantics import DEFAULT_OPTIONS

        px0 = jnp.asarray(pixel_centers(W, H))
        nt = args.target_n

        @jax.jit
        def _clamped_target(key):
            def body(acc, i):
                c = _trace_stratum(scene, px0, jax.random.fold_in(key, i),
                                   i % (nt * nt), nt, DEFAULT_OPTIONS)
                return acc + jnp.minimum(c, args.phase2_clamp), None

            acc, _ = jax.lax.scan(
                body, jnp.zeros((px0.shape[0], 3)),
                jnp.arange(nt * nt, dtype=jnp.int32),
            )
            return acc / (nt * nt)

        t0 = time.time()
        target2 = np.asarray(_clamped_target(jax.random.PRNGKey(100))
                             ).reshape(H, W, 3)
        print(f"[flagship] clamped target ({args.phase2_clamp}) rendered "
              f"in {time.time()-t0:.1f}s", flush=True)

    true_p = get_params(scene)
    init = {k: np.asarray(v).copy() for k, v in true_p.items()}
    # perturb: diffuse walls -> flat grey, emission -> 25% of true
    init["mat_color"][diffuse_rows] = 0.25
    init["light_intensity"] = init["light_intensity"] * 0.25
    if args.init_from:
        prev = json.loads(Path(args.init_from).read_text())
        init["mat_color"][diffuse_rows] = np.asarray(
            prev["recovered_albedo"], np.float32
        )
        init["light_intensity"] = np.asarray(
            prev["recovered_emission"], np.float32
        )
        print(f"[flagship] resumed params from {args.init_from}", flush=True)
    init = {k: jax.numpy.asarray(v) for k, v in init.items()}

    # freeze every non-diffuse mat_color row (mirror/glass tints are at
    # their true values and must not random-walk under MC gradient noise)
    mask = {
        "mat_color": jax.numpy.asarray(
            (mat_type == MAT_DIFFUSE).astype(np.float32)[:, None]
        )
    }
    # adam steps are ~lr-sized regardless of gradient scale, so the O(500)
    # emission needs a large-but-decaying lr: constant-small stalls short of
    # the optimum with the albedo compensating (observed on CPU validation),
    # constant-large leaves ~lr-sized jitter around it
    # decay_rate 0.1 (not faster): albedo and emission descend a coupled
    # valley — albedo must fall as emission rises — so emission needs
    # usable step sizes through the WHOLE run, not just the first third
    em_sched = optax.exponential_decay(
        args.lr_emission, transition_steps=args.steps, decay_rate=0.1
    )
    opt = optax.multi_transform(
        {"albedo": optax.adam(args.lr_albedo),
         "emission": optax.adam(em_sched)},
        param_labels={"mat_color": "albedo", "light_intensity": "emission",
                      "tex_c0": "albedo", "tex_c1": "albedo"},
    )

    curve = []

    def cb(i, loss, params):
        rec = {
            "step": i,
            "loss": loss,
            "albedo_mae": _albedo_err(params, true_p, diffuse_rows),
            "emission_rel_err": _emission_err(params, true_p),
        }
        curve.append(rec)
        print(f"[flagship] step {i:4d} loss={loss:.5f} "
              f"albedo_mae={rec['albedo_mae']:.4f} "
              f"emission_rel={rec['emission_rel_err']:.4f}", flush=True)

    from plutracer_tpu.semantics import DEFAULT_OPTIONS as _DOPTS

    ropts = _DOPTS.replace(remat_bounces=True) if args.remat else _DOPTS
    ck1 = ck2 = None
    if args.checkpoint:
        os.makedirs(args.checkpoint, exist_ok=True)
        ck1 = os.path.join(args.checkpoint, "phase1.ckpt.npz")
        ck2 = os.path.join(args.checkpoint, "phase2.ckpt.npz")
    cfg = InverseRenderConfig(
        width=W, height=H, n=args.n, steps=args.steps, seed=args.seed,
        log_every=10, trainable=("mat_color", "light_intensity"),
        optimizer=opt, grad_mask=mask, loss_space=args.loss,
        options=ropts, checkpoint_path=ck1,
    )
    stats = {}
    t0 = time.time()
    params, losses = optimize_scene(
        scene, target, cfg, init_params=init, callback=cb, stats_out=stats
    )

    if args.phase2_steps > 0:
        # phase 2: unbiased ab-loss refinement from the phase-1 point.
        # The log loss minimizes E[(log1p X - log1p t)^2], whose optimum
        # under MC noise sits at albedo BELOW truth (variance grows with
        # albedo; Jensen bias) — exactly the r3 plateau. The ab product
        # loss E[(Xa-t)(Xb-t)] = (E[X]-t)^2 has the true parameters as its
        # optimum, and with emission already in place its variance is
        # manageable at phase2-n^2 spp.
        print(f"[flagship] phase 2: {args.phase2_loss} loss, {args.phase2_steps} steps "
              f"at {args.phase2_n ** 2} spp", flush=True)
        # adam with a decaying albedo lr: under the pooled ab loss the
        # gradient is signal+noise; a constant lr leaves an lr-sized
        # random walk around the optimum (measured: clip(1.0)+lr 2e-2
        # walked albedo MAE from its 0.075 minimum back up to 0.14), a
        # decaying one settles
        al_sched = optax.exponential_decay(
            args.phase2_lr_albedo, transition_steps=args.phase2_steps,
            decay_rate=0.05,
        )
        opt2 = optax.multi_transform(
            {"albedo": optax.adam(al_sched),
             "emission": optax.adam(args.phase2_lr_emission)},
            param_labels={"mat_color": "albedo",
                          "light_intensity": "emission",
                          "tex_c0": "albedo", "tex_c1": "albedo"},
        )

        def cb2(i, loss, p):
            cb(args.steps + i, loss, p)

        cfg2 = InverseRenderConfig(
            width=W, height=H, n=args.phase2_n, steps=args.phase2_steps,
            seed=args.seed + 1, log_every=10,
            trainable=("mat_color", "light_intensity"),
            optimizer=opt2, grad_mask=mask, loss_space=args.phase2_loss,
            loss_downsample=(args.phase2_downsample
                             if args.phase2_loss == "ab" else 1),
            loss_clamp=args.phase2_clamp,
            mesh_shape=(1, 1),
            options=ropts, checkpoint_path=ck2,
        )
        stats2 = {}
        # host round-trip: phase-1 params carry the phase-1 mesh's
        # sharding; numpy leaves are uncommitted and placeable on the
        # phase-2 (single-tile, pooling-capable) mesh
        params = {k: np.asarray(v) for k, v in params.items()}
        params, losses2 = optimize_scene(
            scene, target2, cfg2, init_params=params, callback=cb2,
            stats_out=stats2,
        )
        losses = losses + losses2
        stats["phase2"] = stats2
    t_opt = time.time() - t0

    err0_albedo = _albedo_err({k: np.asarray(v) for k, v in init.items()},
                              true_p, diffuse_rows)
    err0_emission = _emission_err({k: np.asarray(v) for k, v in init.items()},
                                  true_p)
    result = {
        "config": {
            "scene": args.scene, "res": [W, H],
            "target_spp": args.target_n ** 2, "steps": args.steps,
            "lr_albedo": args.lr_albedo, "lr_emission": args.lr_emission,
            "loss": args.loss,
            "phase2": {"steps": args.phase2_steps, "loss": "ab",
                       "n": args.phase2_n,
                       "lr_albedo": args.phase2_lr_albedo,
                       "lr_emission": args.phase2_lr_emission},
            "trainable": ["mat_color[diffuse rows]", "light_intensity"],
        },
        "grad_sanitize_stats": stats,
        "device": jax.devices()[0].platform,
        "target_render_s": round(t_target, 2),
        "optimize_s": round(t_opt, 2),
        "init": {"albedo_mae": err0_albedo, "emission_rel_err": err0_emission},
        "final": {
            "albedo_mae": _albedo_err(params, true_p, diffuse_rows),
            "emission_rel_err": _emission_err(params, true_p),
            "loss_mean_last20": float(np.mean(losses[-20:])),
        },
        "true_albedo": np.asarray(true_p["mat_color"])[diffuse_rows].tolist(),
        "recovered_albedo":
            np.asarray(params["mat_color"])[diffuse_rows].tolist(),
        "true_emission": np.asarray(true_p["light_intensity"]).tolist(),
        "recovered_emission":
            np.asarray(params["light_intensity"]).tolist(),
        "curve": curve,
    }
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"[flagship] wrote {args.out}: albedo_mae "
          f"{err0_albedo:.4f} -> {result['final']['albedo_mae']:.4f}, "
          f"emission_rel {err0_emission:.4f} -> "
          f"{result['final']['emission_rel_err']:.4f}", flush=True)

    if args.save_images:
        from plutracer_tpu.io.bmp import write_bmp
        from plutracer_tpu.ops.tonemap import postprocess_image
        from plutracer_tpu.parallel.sharded import apply_params

        outdir = Path("artifacts")
        outdir.mkdir(exist_ok=True)
        write_bmp(str(outdir / "inverse_target.bmp"),
                  np.asarray(postprocess_image(target)))
        rec = render(apply_params(scene, params), W, H, 8,
                     jax.random.PRNGKey(7))
        write_bmp(str(outdir / "inverse_recovered.bmp"),
                  np.asarray(postprocess_image(rec)))
        print(f"[flagship] images in {outdir}/", flush=True)
    return result


if __name__ == "__main__":
    main()
