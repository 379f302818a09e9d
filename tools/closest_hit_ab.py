#!/usr/bin/env python
"""Closest hit on the GPU: the Pallas kernel against XLA's brute force.

Three measurements, all on the attached GPU (the script refuses to run
without one):

1. query time: one closest-hit query of B rays, `intersect_lite` (XLA)
   against the kernel, over scenes of growing primitive count;
2. end to end: `render` with intersect_backend "xla" and "pallas" at
   demo-box 512^2, mesh1 256^2 and mesh2 128^2 (n = 2), timed in turns
   (xla, pallas, pallas, xla);
3. one profiler trace per backend of the demo-box render, reduced to the
   device's busy share, the device time per bounce and the kernels that
   take the most time.

With --sweep it instead times the kernel's block sizes (BLOCK_R, CHUNK,
NUM_WARPS in ops/pallas/intersect_kernel.py) on the query of (1).

Usage: python tools/closest_hit_ab.py [--sweep] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from chip_smoke import _kernel_rays, load, log, median_time  # noqa: E402


def opts(backend):
    from plutracer_tpu.semantics import DEFAULT_OPTIONS

    return DEFAULT_OPTIONS.replace(intersect_backend=backend)


def query_sweep(B, reps):
    import jax

    from plutracer_tpu.ops import intersect
    from plutracer_tpu.ops.pallas.intersect_kernel import intersect_lite_pallas

    xla = jax.jit(intersect.intersect_lite)
    kern = jax.jit(intersect_lite_pallas)
    rows = []
    for name in ("demo-box.urn", "sphere-grid.urn", "mesh0.urn", "mesh1.urn",
                 "mesh2.urn"):
        scene = load(name, 8, 8)
        o, d = _kernel_rays(scene, B)
        row = {"scene": name, "P": int(scene.prim_type.shape[0]), "B": B}
        # the scene is an argument, as in a render (not a baked constant)
        fns = {
            "xla": lambda: xla(scene, o, d),
            "kernel": lambda: kern(o, d, scene.prims_packed),
        }
        for tag in ("xla", "kernel", "kernel", "xla"):
            try:
                med = median_time(fns[tag], reps)
                row.setdefault(f"{tag}_ms", []).append(1e3 * med)
            except Exception as e:  # an XLA query may not fit in memory
                row[f"{tag}_error"] = str(e)[:200]
        log(json.dumps(row))
        rows.append(row)
    return rows


def sweep(B, reps):
    """Query time of the kernel per (BLOCK_R, CHUNK, NUM_WARPS)."""
    import itertools

    import jax

    from plutracer_tpu.ops.pallas import intersect_kernel as K

    scenes = {name: load(name, 8, 8)
              for name in ("demo-box.urn", "mesh0.urn", "mesh2.urn")}
    rays = {name: _kernel_rays(s, B) for name, s in scenes.items()}
    rows = []
    for block_r, chunk, warps in itertools.product(
            (32, 64, 128), (8, 16, 32), (2, 4, 8)):
        K.BLOCK_R, K.CHUNK, K.NUM_WARPS = block_r, chunk, warps
        jax.clear_caches()  # the constants are read at trace time
        row = {"BLOCK_R": block_r, "CHUNK": chunk, "NUM_WARPS": warps}
        kern = jax.jit(K.intersect_lite_pallas)
        for name, scene in scenes.items():
            tabs = jax.device_put(K.pack_prims_np(scene))  # this CHUNK
            o, d = rays[name]
            try:
                med = median_time(lambda: kern(o, d, tabs), reps)
                row[name] = 1e3 * med
            except Exception as e:
                row[name] = str(e)[:120]
        log(json.dumps(row))
        rows.append(row)
    return rows


def end_to_end(reps):
    import jax

    from plutracer_tpu.render.renderer import render

    rows = []
    for name, w, n in (("demo-box.urn", 512, 2), ("mesh1.urn", 256, 2),
                       ("mesh2.urn", 128, 2)):
        scene = load(name, w, w)
        key = jax.random.PRNGKey(0)
        row = {"scene": name, "P": int(scene.prim_type.shape[0]),
               "res": w, "spp": n * n}
        for backend in ("xla", "pallas", "pallas", "xla"):
            o = opts(backend)
            try:
                t0 = time.perf_counter()
                jax.block_until_ready(render(scene, w, w, n, key, options=o))
                row.setdefault(f"{backend}_first_s", time.perf_counter() - t0)
                med = median_time(lambda: render(scene, w, w, n, key,
                                                 options=o), reps)
                row.setdefault(f"{backend}_s", []).append(med)
            except Exception as e:
                row[f"{backend}_error"] = str(e)[:200]
        for backend in ("xla", "pallas"):
            if f"{backend}_s" in row:
                row[f"{backend}_samples_per_s"] = (
                    w * w * n * n / float(np.median(row[f"{backend}_s"])))
        log(json.dumps(row))
        rows.append(row)
    return rows


def trace_summary(trace_dir, window_s, n_bounces):
    """Device busy share and per-kernel time from a jax.profiler trace."""
    import jax

    [path] = list(pathlib.Path(trace_dir).rglob("*.xplane.pb"))
    data = jax.profiler.ProfileData.from_file(str(path))
    out = {"plane_names": [p.name for p in data.planes], "planes": {}}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        spans, per_kernel = [], {}
        line_names = [line.name for line in plane.lines]
        # kernels run on the stream lines; the other lines are summaries
        streams = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in streams or plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_kernel[ev.name] = per_kernel.get(ev.name, 0) + ev.duration_ns
        spans.sort()
        busy, end = 0, None
        for s, e in spans:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
        out["planes"][plane.name] = {
            "lines": line_names, "events": len(spans),
            "busy_ms": busy / 1e6, "window_ms": 1e3 * window_s,
            "busy_share": busy / 1e9 / window_s,
            "device_ms_per_bounce": busy / 1e6 / n_bounces,
            "top_kernels_ms": [(k[:80], v / 1e6) for k, v in top],
        }
    return out


def profile_render(backend, w=512, n=2):
    import jax

    from plutracer_tpu.render.renderer import render

    scene = load("demo-box.urn", w, w)
    key = jax.random.PRNGKey(0)
    o = opts(backend)
    jax.block_until_ready(render(scene, w, w, n, key, options=o))
    with tempfile.TemporaryDirectory() as td:
        jax.profiler.start_trace(td)
        t0 = time.perf_counter()
        jax.block_until_ready(render(scene, w, w, n, key, options=o))
        window = time.perf_counter() - t0
        jax.profiler.stop_trace()
        res = trace_summary(td, window, n * n * o.max_bounces)
    res["backend"] = backend
    log(json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "closest_hit_ab.json"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--query-batch", type=int, default=3 * 128 * 128)
    ap.add_argument("--sweep", action="store_true",
                    help="time the kernel's block sizes instead")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX has {jax.devices()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"card: {card}")
    res = {"card": card, "device_kind": jax.devices()[0].device_kind}
    if args.sweep:
        res["sweep"] = sweep(args.query_batch, args.reps)
    else:
        res["query"] = query_sweep(args.query_batch, args.reps)
        res["end_to_end"] = end_to_end(max(1, args.reps // 2))
        res["profile"] = [profile_render("xla"), profile_render("pallas")]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    log(f"card: {card}")


if __name__ == "__main__":
    main()
