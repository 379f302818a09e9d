"""Benchmark matrix: render throughput on the attached GPU.

Prints one JSON line per config; the LAST line is the headline metric
(cornell-box 512x512). Every line names the device it ran on (platform,
device_kind, device count); the bench refuses to run without a GPU.

Metric: pixel samples per second (W*H*passes / steady-state render time).
Each sample is a full path: up to 8 shading vertices with NEE, i.e. up to
25 scene-intersection queries per sample (RenderStats.rays_per_sec_upper).

Configs follow BASELINE.md: cornell 512^2 (headline), glass0 + refrac0
256^2 (dielectric/branching-BSDF stress), room 512^2 (textures + multiple
lights), test1 (259 prims via urn evaluation — exercises the one-hot
gather tier), and the in-repo meshes and textured scenes.
"""

from __future__ import annotations

import json
import pathlib
import time

REPO = pathlib.Path(__file__).parent
SCN = "/root/reference/scenes"


def bench_scene(name, path, w, h, passes=16, chunk=8, n=4):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from plutracer_tpu.render.renderer import render, render_passes, zeros_accum
    from plutracer_tpu.scene import compile_scene, load_scene_file
    from plutracer_tpu.semantics import DEFAULT_OPTIONS
    from plutracer_tpu.utils.profiling import RenderStats

    desc = load_scene_file(path, ["/res", f"{w}x{h}"])
    scene = compile_scene(desc)
    key = jax.random.PRNGKey(0)

    # warmup/compile
    acc = zeros_accum(w, h)
    for wpass in range(2):
        acc = render_passes(
            scene, jax.random.fold_in(key, 100 + wpass), jnp.int32(0),
            w, h, n, chunk, accum=acc,
        )
    acc.block_until_ready()

    t0 = time.perf_counter()
    acc = zeros_accum(w, h)
    for s in range(0, passes, chunk):
        acc = render_passes(scene, key, jnp.int32(s), w, h, n, chunk, accum=acc)
    acc.block_until_ready()
    stats = RenderStats(w, h, passes, time.perf_counter() - t0)

    # --- validation: a fast benchmark that renders garbage is worthless.
    # (a) the timed accumulator must be finite; (b) a small same-seed
    # render through the default path must agree with the forced-XLA
    # closest hit (catches a wrong-but-fast kernel; tolerances cover the
    # documented dielectric knife-edge lane flips).
    accn = np.asarray(acc)
    validated = bool(np.isfinite(accn).all())
    vkey = jax.random.PRNGKey(7)
    sv = compile_scene(load_scene_file(path, ["/res", "64x64"]))
    img_auto = np.asarray(render(sv, 64, 64, 2, vkey))
    img_xla = np.asarray(
        render(sv, 64, 64, 2, vkey,
               options=DEFAULT_OPTIONS.replace(intersect_backend="xla"))
    )
    a = np.log1p(np.maximum(img_auto, 0.0))
    b = np.log1p(np.maximum(img_xla, 0.0))
    validated &= bool(np.isfinite(img_auto).all())
    # systematic-error check: means must agree (a garbage-fast kernel fails
    # this by orders of magnitude); per-pixel threshold at 0.01 with a
    # knife-edge allowance (measured: mesh0 triangle edges flip 1.6% of
    # pixels > 0.01 at 4 spp with dlogmean 3e-4)
    validated &= abs(float(a.mean()) - float(b.mean())) < 0.02
    validated &= float((np.abs(a - b) > 0.01).mean()) < 0.025
    return stats, validated


def bench_train_step(w=256, h=256, n=2, steps=24):
    """Inverse-rendering train-step throughput (forward + backward +
    psum + adam) on cornell-box: the BASELINE gradient workload.

    Measures STEADY-STATE stepping: the train step is built once
    (make_train_step) and `steps` chunked optimization steps run in one
    device dispatch (step.many) — the shape real training has, where the
    one-time trace/compile is amortized over hundreds of steps."""
    import time

    import jax
    import numpy as np

    from plutracer_tpu.parallel.mesh import make_mesh
    from plutracer_tpu.parallel.sharded import get_params, make_train_step
    from plutracer_tpu.render.renderer import render
    from plutracer_tpu.scene import compile_scene, load_scene_file

    scene = compile_scene(
        load_scene_file(f"{SCN}/cornell-box.urn", ["/res", f"{w}x{h}"])
    )
    target = np.asarray(render(scene, w, h, 2, jax.random.PRNGKey(100)))
    target = target.reshape(-1, 3)
    step = make_train_step(
        scene, w, h, n, make_mesh(None), loss_space="log",
        trainable=("mat_color", "light_intensity"),
        project_nonnegative=True,
    )
    params = get_params(scene)
    opt_state = step.init(params)
    key = jax.random.PRNGKey(0)
    # warmup x2: the first call compiles the k-step scan; the second
    # recompiles once more because the RETURNED params/opt_state carry the
    # mesh's NamedSharding while the originals were single-device — from
    # the third call on, input shardings are stable (the state real
    # training loops are in after their first chunk)
    for wu in range(2):
        params, opt_state, losses, _ = step.many(
            params, opt_state, target, key, wu * steps, steps
        )
        float(np.asarray(losses).sum())
    t0 = time.perf_counter()
    params, opt_state, losses, nf = step.many(
        params, opt_state, target, key, 2 * steps, steps
    )
    ok = bool(np.isfinite(np.asarray(losses)).all())
    dt = time.perf_counter() - t0
    return w * h * steps / dt, ok  # forward samples/s through the train step


def device_info() -> dict:
    """The device every printed line names; refuses anything but a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX has {devs}")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def main() -> None:
    import plutracer_tpu

    dev = device_info()
    plutracer_tpu.enable_compilation_cache()

    configs = [
        # (key, scene path, W, H)
        ("glass0_256", f"{SCN}/glass0.urn", 256, 256),
        ("refrac0_256", f"{SCN}/refrac0.urn", 256, 256),
        ("room_512", f"{SCN}/room.urn", 512, 512),
        ("test1_256", f"{SCN}/test1.urn", 256, 256),
        ("mesh0_256", str(REPO / "scenes" / "mesh0.urn"), 256, 256),
        ("mesh1_256", str(REPO / "scenes" / "mesh1.urn"), 256, 256),
        ("textured0_256", str(REPO / "scenes" / "textured0.urn"), 256, 256),
        ("meshtex_256", str(REPO / "scenes" / "mesh-tex.urn"), 256, 256),
        ("mesh2_128", str(REPO / "scenes" / "mesh2.urn"), 128, 128),
        ("cornell512", f"{SCN}/cornell-box.urn", 512, 512),
    ]

    # gradient-workload throughput first (the LAST printed line must stay
    # the headline cornell512 metric)
    try:
        sps, ok = bench_train_step()
        line = {"metric": "cornell256_train_samples_per_sec",
                "value": round(sps, 1), "unit": "samples/s", "validated": ok}
    except Exception as e:  # never let the grad bench kill the headline
        line = {"metric": "cornell256_train_samples_per_sec", "value": 0.0,
                "unit": "samples/s", "validated": False, "error": str(e)[:120]}
    print(json.dumps({**line, **dev}), flush=True)

    for key, path, w, h in configs:
        stats, validated = bench_scene(key, path, w, h)
        line = {
            "metric": f"{key}_samples_per_sec",
            "value": round(stats.samples_per_sec, 1),
            "unit": "samples/s",
            "validated": validated,
        }
        print(json.dumps({**line, **dev}), flush=True)


if __name__ == "__main__":
    main()
