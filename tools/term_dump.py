"""Dump our renderer's per-(term, bounce) linear radiance split.

Counterpart of the instrumented reference build (tools/refbuild/build_dump.sh):
writes <base>.linear.f32 (H, W, 3) and <base>.terms.f32 (H, W, 3, 8, 3) in the
same layout, so tools/term_diff.py can diff the two integrators contribution
site by contribution site.

Usage: python tools/term_dump.py SCENE.urn OUT_BASE [--res 512] [--smp 16]
       [--seed 0]   (smp is N: spp = N^2, matching the reference CLI)
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("out_base")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--smp", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default=None, help="cpu | gpu (default: ambient)")
    args = ap.parse_args()

    import functools

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from plutracer_tpu.render.integrator import ray_color
    from plutracer_tpu.render.renderer import pixel_centers
    from plutracer_tpu.ops.camera import generate_rays
    from plutracer_tpu.scene.compile import compile_scene
    from plutracer_tpu.scene.loader import load_scene_file
    from plutracer_tpu.semantics import DEFAULT_OPTIONS

    W = H = args.res
    n = args.smp
    spp = n * n
    options = DEFAULT_OPTIONS
    scene = compile_scene(
        load_scene_file(args.scene, ["/res", f"{W}x{H}", "/smp", str(n)])
    )

    @functools.partial(jax.jit, static_argnames=())
    def pass_terms(scene, key, stratum):
        # mirrors renderer._trace_stratum exactly (same key splits/jitter)
        px0 = pixel_centers(W, H)
        B = px0.shape[0]
        k_px, k_lens, k_path = jax.random.split(key, 3)
        cell = jnp.stack([stratum % n, stratum // n], -1).astype(jnp.float32)
        jit_px = jax.random.uniform(k_px, (B, 2)) * 0.999
        jit_lens = jax.random.uniform(k_lens, (B, 2)) * 0.999
        px = px0 + (cell + jit_px) / n
        lens = (cell + jit_lens) / n
        o, d = generate_rays(scene.camera, px, lens)
        L, ys = ray_color(scene, o, d, k_path, options, terms=True)
        return L, ys  # ys: (NB, 3, B, 3)

    key = jax.random.PRNGKey(args.seed)
    NB = options.max_bounces
    acc_L = np.zeros((H * W, 3), np.float64)
    acc_T = np.zeros((NB, 3, H * W, 3), np.float64)
    for s in range(spp):
        k = jax.random.fold_in(key, s)
        L, ys = pass_terms(scene, k, jnp.int32(s))
        acc_L += np.asarray(L, np.float64)
        acc_T += np.asarray(ys, np.float64)
        if (s + 1) % 32 == 0:
            print(f"  pass {s + 1}/{spp}", flush=True)

    lin = (acc_L / spp).astype(np.float32).reshape(H, W, 3)
    # (NB, 3, HW, 3) -> (HW, 3 terms, NB, 3)
    terms = (acc_T / spp).transpose(2, 1, 0, 3).astype(np.float32)
    terms = terms.reshape(H, W, 3, NB, 3)
    err = np.abs(terms.sum(axis=(2, 3)) - lin).max()
    print(f"self-check max|sum(terms) - L| = {err:.3e}")
    lin.tofile(args.out_base + ".linear.f32")
    terms.tofile(args.out_base + ".terms.f32")
    print(f"wrote {args.out_base}.linear.f32 / .terms.f32  "
          f"(linear mean {lin.mean():.4f})")


if __name__ == "__main__":
    main()
