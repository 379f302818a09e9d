#!/usr/bin/env python
"""Smoke test of the renderer and the inverse-rendering step on a GPU.

Drives the user entry points once at real size, in one process:

1. supervised render: `cli.main([... "/supervise"])` on demo-box.urn at
   256^2, /smp 2, with one injected worker crash. It runs first, while this
   process has not touched the card: the worker needs the card to itself.
2. kernel compare: the closest-hit kernel against `intersect_lite` at
   demo-box (B = 512^2), mesh1 (256^2) and mesh2 (128^2), with timings.
3. main render: `cli.main` on demo-box.urn at its own 512^2 and 64 spp.
4. big-P render: `render` of mesh1.urn at 256^2, n = 2.
5. training: 8 steps of `make_train_step(...).many` on demo-box at 256^2.

Usage, from the repo root:

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # the sharded paths on four GPUs only

Any failure exits non-zero. Without a GPU it exits non-zero before any
phase. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SCENES = REPO / "scenes"
OUT = REPO / "chiprun_out" / "chip_smoke"
# kernel-vs-reference agreement (PERF.md, "Closest hit: kernel vs XLA")
T_RTOL = 1e-5
# image agreement, as bench.py: log-space means within 0.02, and fewer
# than 2.5% of pixels differing by more than 0.01
LOG_MEAN_TOL = 0.02
PIXEL_TOL, PIXEL_FRAC = 0.01, 0.025


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_probe() -> dict:
    """The card as nvidia-smi and JAX report it, from child processes, so
    that this process opens no device before phase 1's worker has run."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        raise SystemExit("no GPU: nvidia-smi not found")
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr.strip()}")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax, json; d = jax.devices(); print(json.dumps({"
         "'platform': d[0].platform, 'kind': d[0].device_kind, "
         "'count': len(d)}))"],
        capture_output=True, text=True, timeout=300,
    )
    if probe.returncode != 0:
        raise SystemExit(f"JAX probe failed: {probe.stderr.strip()[-2000:]}")
    dev = json.loads(probe.stdout.strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX reports {dev}")
    return {"nvidia_smi": smi.stdout.strip(), **dev}


def load(name: str, w: int, h: int):
    from plutracer_tpu.scene import compile_scene, load_scene_file

    return compile_scene(load_scene_file(str(SCENES / name), ["/res", f"{w}x{h}"]))


def median_time(fn, reps: int = 5) -> float:
    """Median wall seconds of fn(), each rep ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def images_agree(a, b) -> dict:
    a = np.log1p(np.maximum(np.asarray(a), 0.0))
    b = np.log1p(np.maximum(np.asarray(b), 0.0))
    dmean = abs(float(a.mean()) - float(b.mean()))
    frac = float((np.abs(a - b) > PIXEL_TOL).mean())
    ok = dmean < LOG_MEAN_TOL and frac < PIXEL_FRAC
    return {"ok": ok, "dlogmean": dmean, "frac_gt_0.01": frac}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_supervised(out_dir: pathlib.Path, w=256, h=256, smp=2) -> dict:
    """cli.main under /supervise with one injected crash; the crash lands
    after the first checkpoint, so the restart resumes from it."""
    import jax._src.xla_bridge as xb

    from plutracer_tpu import cli
    from plutracer_tpu.render import supervisor

    workdir = out_dir / "supervise"
    if workdir.exists():
        for f in workdir.iterdir():
            f.unlink()
    real = supervisor.supervise_render
    calls = []

    def with_fault(*a, **kw):
        kw.update(inject_fault=f"crash:{smp * smp // 2}",
                  checkpoint_every=max(1, smp * smp // 2))
        calls.append(real(*a, **kw))
        return calls[-1]

    supervisor.supervise_render = with_fault
    try:
        t0 = time.perf_counter()
        rc = cli.main([
            str(SCENES / "demo-box.urn"), "/res", f"{w}x{h}", "/smp", str(smp),
            "/supervise", "/checkpoint", str(workdir),
            "/o", str(out_dir / "supervised.bmp"),
        ])
        secs = time.perf_counter() - t0
    finally:
        supervisor.supervise_render = real
    check(rc == 0, f"cli rc {rc}")
    [res] = calls
    check(res.restarts == 1, f"restarts {res.restarts}")
    check(not xb.backends_are_initialized(),
          "the supervising process initialised a JAX backend")
    img = res.image
    check(img.shape == (h, w, 3) and np.isfinite(img).all(), "bad image")
    return {"restarts": res.restarts, "worker_platform": res.platform,
            "seconds": round(secs, 2), "events": [e for e, _ in res.events],
            "image": img}


def _kernel_rays(scene, B: int, seed: int = 0):
    """B rays: half camera rays, half random rays from inside the scene's
    bounds (the shape of bounce queries)."""
    import jax
    import jax.numpy as jnp

    from plutracer_tpu.ops.camera import generate_rays

    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    nc = B // 2
    w = h = int(np.sqrt(nc)) or 1
    px = jax.random.uniform(k1, (nc, 2)) * jnp.array([w, h], jnp.float32)
    lens = jax.random.uniform(k2, (nc, 2))
    cam = dataclasses.replace(scene.camera, inv_image_size=jnp.array(
        [1.0 / w, 1.0 / h], jnp.float32))
    oc, dc = generate_rays(cam, px, lens)
    lo = jnp.min(jnp.asarray(scene.prim_a), 0)
    hi = jnp.max(jnp.asarray(scene.prim_a), 0)
    orr = lo + (hi - lo) * jax.random.uniform(k3, (B - nc, 3))
    dr = jax.random.normal(k4, (B - nc, 3))
    dr = dr / jnp.linalg.norm(dr, axis=-1, keepdims=True)
    return jnp.concatenate([oc, orr]), jnp.concatenate([dc, dr])


def compare_hits(ref, got) -> dict:
    """§3 agreement: found on every lane; prim except on knife-edge lanes
    whose two winners' t agree within T_RTOL; t within T_RTOL where prim
    agrees."""
    fx, px, tx = (np.asarray(x) for x in ref)
    fk, pk, tk = (np.asarray(x) for x in got)
    found_mismatch = int((fx != fk).sum())
    hit = fx & fk
    rel = np.abs(tx - tk) / np.maximum(np.abs(tx), 1e-30)
    same = hit & (px == pk)
    knife = hit & (px != pk)
    knife_bad = int((knife & (rel > T_RTOL)).sum())
    t_bad = int((same & (rel > T_RTOL)).sum())
    return {
        "ok": found_mismatch == 0 and knife_bad == 0 and t_bad == 0,
        "lanes": int(fx.size), "hits": int(fx.sum()),
        "found_mismatch": found_mismatch, "knife_edge_lanes": int(knife.sum()),
        "knife_edge_beyond_tol": knife_bad, "t_beyond_tol": t_bad,
        "max_t_rel": float(rel[same].max()) if same.any() else 0.0,
    }


def phase_kernels(cases=(("demo-box.urn", 512 * 512), ("mesh1.urn", 256 * 256),
                         ("mesh2.urn", 128 * 128)), reps=5,
                  interpret=False) -> dict:
    """Closest-hit kernel vs intersect_lite on the same rays."""
    import jax

    from plutracer_tpu.ops import intersect
    from plutracer_tpu.ops.pallas.intersect_kernel import intersect_lite_pallas

    out = {}
    for name, B in cases:
        scene = load(name, 8, 8)
        o, d = _kernel_rays(scene, B)
        # the scene is an argument, as in a render (not a baked constant)
        plain = jax.jit(intersect.intersect_lite)
        kern = jax.jit(functools.partial(intersect_lite_pallas,
                                         interpret=interpret))
        args = {"xla": (scene, o, d), "kernel": (o, d, scene.prims_packed)}
        row = {"P": int(scene.prim_type.shape[0]), "B": B}
        for tag, f in (("xla", plain), ("kernel", kern)):
            t0 = time.perf_counter()
            compiled = f.lower(*args[tag]).compile()
            row[f"{tag}_compile_s"] = round(time.perf_counter() - t0, 3)
            log(f"  {name} {tag} memory_analysis: {compiled.memory_analysis()}")
            row[f"{tag}_ms"] = 1e3 * median_time(lambda: f(*args[tag]), reps)
        row.update(compare_hits(plain(*args["xla"]), kern(*args["kernel"])))
        log(f"  {name}: {json.dumps(row)}")
        check(row["ok"], f"kernel disagrees with intersect_lite on {name}")
        out[name] = row
    return out


def dots_in(lowered) -> dict:
    """Matrix products in a lowered program, and how many ask for HIGHEST."""
    text = lowered.as_text()
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    return {"dot_general": len(lines),
            "highest": sum("HIGHEST" in ln for ln in lines)}


def phase_main_render(out_dir: pathlib.Path, res=512, small=64,
                      supervised=None) -> dict:
    """cli.main at the scene's own size and spp (the checkpoint file gives
    back the linear image), then two agreement checks."""
    import jax
    import jax.numpy as jnp

    from plutracer_tpu import cli
    from plutracer_tpu.render.elastic import render_elastic
    from plutracer_tpu.render.progressive import load_state
    from plutracer_tpu.render.renderer import render, render_passes, zeros_accum
    from plutracer_tpu.semantics import DEFAULT_OPTIONS

    ck = out_dir / "demo-box.ckpt.npz"
    if ck.exists():
        ck.unlink()
    argv = [str(SCENES / "demo-box.urn"), "/checkpoint", str(ck),
            "/o", str(out_dir / "demo-box.bmp")]
    if res != 512:
        argv += ["/res", f"{res}x{res}", "/smp", "2"]
    t0 = time.perf_counter()
    check(cli.main(argv) == 0, "cli failed")
    secs = time.perf_counter() - t0
    accum, next_pass, _ = load_state(str(ck))
    img = np.asarray(accum) / next_pass
    check(np.isfinite(img).all(), "non-finite pixels")
    check(float(img.mean()) > 0.0, "black image")
    row = {"seconds": round(secs, 2), "spp": next_pass,
           "mean": float(img.mean())}

    scene = load("demo-box.urn", small, small)
    key = jax.random.PRNGKey(7)
    auto = render(scene, small, small, 2, key)
    for backend in ("xla", "pallas"):
        opts = DEFAULT_OPTIONS.replace(
            intersect_backend=backend,
            pallas_interpret=backend == "pallas" and jax.default_backend() != "gpu")
        row[f"auto_vs_{backend}"] = images_agree(
            auto, render(scene, small, small, 2, key, options=opts))
        check(row[f"auto_vs_{backend}"]["ok"], f"auto vs {backend}")

    if supervised is not None:
        h, w = supervised.shape[:2]
        s2 = load("demo-box.urn", w, h)
        direct = np.asarray(render_elastic(s2, w, h, 2, 0,
                                           devices=jax.devices()[:1]))
        diff = float(np.abs(direct - supervised).max())
        row["supervised_vs_direct"] = {
            "bit_equal": bool(np.array_equal(direct, supervised)),
            "max_abs": diff, **images_agree(direct, supervised)}
        check(row["supervised_vs_direct"]["ok"], "supervised vs direct")

    full = load("demo-box.urn", res, res)
    lowered = render_passes.lower(full, key, jnp.int32(0), res, res, 8, 16,
                                  DEFAULT_OPTIONS, accum=zeros_accum(res, res))
    row["render_passes_dots"] = dots_in(lowered)
    return row


def phase_big_p(w=256, n=2, small=32) -> dict:
    import jax

    from plutracer_tpu.render.renderer import render
    from plutracer_tpu.semantics import DEFAULT_OPTIONS

    scene = load("mesh1.urn", w, w)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    img = np.asarray(render(scene, w, w, n, key))
    first = time.perf_counter() - t0
    secs = median_time(lambda: render(scene, w, w, n, key), reps=3)
    check(np.isfinite(img).all() and img.mean() > 0, "mesh1 image")
    s = load("mesh1.urn", small, small)
    agree = images_agree(
        render(s, small, small, 2, key),
        render(s, small, small, 2, key,
               options=DEFAULT_OPTIONS.replace(intersect_backend="xla")))
    check(agree["ok"], "mesh1 auto vs xla")
    return {"P": int(scene.prim_type.shape[0]), "first_call_s": round(first, 2),
            "render_s": secs, "samples_per_s": w * w * n * n / secs,
            "mean": float(img.mean()), "auto_vs_xla_small": agree}


def phase_train(w=256, n=2, steps=8) -> dict:
    import jax

    from plutracer_tpu.parallel import make_mesh, make_train_step
    from plutracer_tpu.parallel.sharded import get_params
    from plutracer_tpu.render.renderer import render

    scene = load("demo-box.urn", w, w)
    target = np.asarray(render(scene, w, w, n, jax.random.PRNGKey(100)))
    step = make_train_step(scene, w, w, n, make_mesh((1, 1)),
                           trainable=("mat_color", "light_intensity"))
    params = jax.tree.map(lambda x: x * 0.8, get_params(scene))
    state = step.init(params)
    flat = target.reshape(-1, 3)
    key = jax.random.PRNGKey(0)
    many = jax.jit(lambda p, s, t, k: step.many(p, s, t, k, 0, steps))
    dots = dots_in(many.lower(params, state, flat, key))
    t0 = time.perf_counter()
    _, _, losses, nf = jax.block_until_ready(many(params, state, flat, key))
    first = time.perf_counter() - t0
    secs = median_time(lambda: many(params, state, flat, key), reps=3)
    losses, nf = np.asarray(losses), np.asarray(nf)
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(float(nf.max()) == 0.0, f"nonfinite grads {nf}")
    stats = jax.devices()[0].memory_stats() or {}
    return {"losses": [float(x) for x in losses], "nf_max": float(nf.max()),
            "first_call_s": round(first, 2), "steps_s": secs,
            "samples_per_s": w * w * steps / secs, "dots": dots,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def _within(x, samples, k=4.0) -> dict:
    """x against K independent one-device estimates of the same quantity:
    the distance of x from their mean, over their spread (RMS distance from
    the mean, times sqrt(1 + 1/K)), must stay below k."""
    samples = np.asarray(samples, np.float64).reshape(len(samples), -1)
    mean = samples.mean(0)
    spread = np.sqrt(((samples - mean) ** 2).sum(1).mean() * (1 + 1 / len(samples)))
    ratio = float(np.linalg.norm(np.ravel(x) - mean) / max(spread, 1e-30))
    return {"ratio": ratio, "limit": k, "ok": ratio <= k}


def phase_four(w=128, n=2, seeds=5) -> dict:
    """The sharded paths on four devices against one device. render_elastic
    draws the one-device sample stream; render_sharded and the sharded train
    step draw other samples (one key per tile shard), so they are held to
    the one-device seed-to-seed spread (`_within`)."""
    import jax
    import optax

    from plutracer_tpu.parallel import make_mesh, make_train_step, render_sharded
    from plutracer_tpu.parallel.sharded import get_params
    from plutracer_tpu.render.elastic import render_elastic
    from plutracer_tpu.render.renderer import render

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, have {len(devs)}")
    scene = load("demo-box.urn", w, w)
    ones = [np.asarray(render(scene, w, w, n, jax.random.PRNGKey(s)))
            for s in range(seeds)]
    row = {}

    el = np.asarray(render_elastic(scene, w, w, n, 0, devices=devs[:4]))
    el1 = np.asarray(render_elastic(scene, w, w, n, 0, devices=devs[:1]))
    row["elastic4_vs_elastic1_bit_equal"] = bool(np.array_equal(el, el1))
    row["elastic4_vs_render"] = {
        "bit_equal": bool(np.array_equal(el, ones[0])),
        "max_abs": float(np.abs(el - ones[0]).max()),
        **images_agree(el, ones[0])}
    check(row["elastic4_vs_elastic1_bit_equal"], "elastic 4 != elastic 1")
    check(row["elastic4_vs_render"]["ok"], "elastic vs render")

    sh = np.asarray(render_sharded(scene, w, w, n, jax.random.PRNGKey(0),
                                   make_mesh((4, 1))))
    check(np.isfinite(sh).all(), "sharded render not finite")
    row["sharded_mean"] = {"sharded": float(sh.mean()),
                           **_within(sh.mean(), [x.mean() for x in ones])}
    check(row["sharded_mean"]["ok"], "sharded render mean")

    target = ones[0].reshape(-1, 3)
    params = jax.tree.map(lambda x: x * 0.8, get_params(scene))
    trainable = ("mat_color", "light_intensity")

    def grad_steps(shape, keys):
        # sgd(1.0): params - new_params is the step's all-reduced gradient
        step = make_train_step(scene, w, w, n, make_mesh(shape),
                               optimizer=optax.sgd(1.0), trainable=trainable)
        out = []
        for k in keys:
            new, _, loss = step(params, step.init(params), target,
                                jax.random.PRNGKey(k), 0)
            out.append((float(loss), np.concatenate([
                np.ravel(np.asarray(params[f]) - np.asarray(new[f]))
                for f in trainable])))
        return out

    [(l4, g4)] = grad_steps((4, 1), [100])
    ref = grad_steps((1, 1), range(100, 100 + seeds))
    check(np.isfinite(g4).all() and np.isfinite(l4), "sharded step not finite")
    row["train_loss"] = {"loss4": l4, **_within(l4, [l for l, _ in ref])}
    row["train_grad"] = {"grad_norm4": float(np.linalg.norm(g4)),
                         **_within(g4, [g for _, g in ref])}
    check(row["train_loss"]["ok"], "sharded train loss")
    check(row["train_grad"]["ok"], "sharded train gradient")
    row["peak_bytes_in_use"] = [
        (d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs[:4]]
    return row


# ---------------------------------------------------------------------------


def run_phase(name: str, fn, results: dict):
    log(f"== {name}")
    t0 = time.perf_counter()
    res = fn()
    shown = {k: v for k, v in res.items() if k != "image"}
    shown["phase_s"] = round(time.perf_counter() - t0, 2)
    log(f"{name}: {json.dumps(shown, default=str)}")
    results[name] = shown
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    card = gpu_probe()
    log(f"card: {card['nvidia_smi']}")
    OUT.mkdir(parents=True, exist_ok=True)
    import plutracer_tpu

    plutracer_tpu.enable_compilation_cache()
    results = {}
    if args.four:
        run_phase("four", phase_four, results)
    else:
        sup = run_phase("supervised", functools.partial(phase_supervised, OUT),
                        results)
        run_phase("kernels", phase_kernels, results)
        run_phase("main_render", functools.partial(
            phase_main_render, OUT, supervised=sup["image"]), results)
        run_phase("big_p", phase_big_p, results)
        run_phase("train", phase_train, results)

    import jax

    devs = jax.devices()
    (OUT / ("four.json" if args.four else "smoke.json")).write_text(
        json.dumps({"card": card, **results}, indent=1, default=str))
    log(f"card: {card['nvidia_smi']}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if args.four else len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
