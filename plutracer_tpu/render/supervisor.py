"""Failure detection + automatic restart for long renders.

The reference crashes on any error and loses the partial render
(SURVEY §5: "no retry, no checkpoint of partial renders" —
src/main.cpp, scene.h:90-98). This module supervises a render worker
subprocess and recovers from the two real failure modes of accelerator
jobs:

- **Crash** (nonzero exit / killed process): detected by the exit code.
- **Hang** (wedged device, stuck collective): detected by a liveness
  heartbeat — the worker touches a heartbeat file at start, once the
  scene is compiled, and after every checkpointed chunk; a stale
  heartbeat past ``heartbeat_timeout`` gets the worker's process group
  killed. The timeout must cover the first chunk, which includes the
  cold compile of the render program.

Either way the supervisor relaunches the worker, which resumes from the
last checkpoint written by ``render/elastic.py``. Because the elastic
checkpoint is device-topology-free, each relaunch may use a DIFFERENT
device count (``device_counts`` — e.g. a job that lost devices resumes
on the survivors) and the final image is still bit-identical to the same
supervised job run with no failures at all (the tests assert this
through crash, hang and re-mesh histories; comparisons are
worker-to-worker because an interpreter configured differently — e.g. a
site hook that pre-tunes jax — may legitimately differ in float
rounding from this one).

The supervising process never touches JAX's devices: only the worker
opens the accelerator, which keeps to one process per card. The worker
also returns the tonemapped image, so the CLI needs no device either.

Worker entry point: ``python -m plutracer_tpu.render.supervisor --worker …``
(kept in-module so the subprocess needs nothing beyond the package).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["supervise_render", "SuperviseResult", "WorkerFailure"]


class WorkerFailure(RuntimeError):
    """Raised when the worker keeps failing past max_restarts."""


@dataclass
class SuperviseResult:
    image: np.ndarray  # linear (H, W, 3)
    display: np.ndarray  # tonemapped (H, W, 3) in [0, 1]
    platform: str  # the worker's JAX platform
    restarts: int
    events: List[Tuple[str, str]] = field(default_factory=list)


def _launch(args, env, log_path):
    log = open(log_path, "ab")
    # own session => one killpg stops the worker and anything it spawned,
    # by exact pgid (never by pattern)
    return subprocess.Popen(
        args, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True,
    ), log


def supervise_render(
    scene_path: str,
    width: int,
    height: int,
    n: int,
    seed: int,
    workdir: str,
    *,
    scene_args: Optional[Sequence[str]] = None,
    max_restarts: int = 3,
    heartbeat_timeout: float = 900.0,
    checkpoint_every: int = 8,
    device_counts: Optional[Sequence[Optional[int]]] = None,
    inject_fault: Optional[str] = None,
    poll: float = 0.5,
) -> SuperviseResult:
    """Run a supervised render; returns the finished linear image.

    ``device_counts[i]`` is the CPU-mesh device count for launch ``i``
    (None = the worker's natural devices, e.g. the GPUs); the
    last entry is reused for later launches. ``inject_fault`` (fault-spec
    for PLUTRACER_FAULT, e.g. "crash:4") is applied to the FIRST launch
    only — the test hook for the recovery path.
    """
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "render.ckpt.npz")
    hb = os.path.join(workdir, "heartbeat")
    out = os.path.join(workdir, "result.npz")
    log_path = os.path.join(workdir, "worker.log")
    events: List[Tuple[str, str]] = []
    restarts = 0
    # the worker must be able to import this package regardless of its cwd
    # (the supervisor may run from anywhere — e.g. the CLI in an output dir)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    for launch in range(max_restarts + 1):
        env = dict(os.environ)
        env.pop("PLUTRACER_FAULT", None)
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        if inject_fault and launch == 0:
            env["PLUTRACER_FAULT"] = inject_fault
        counts = device_counts or [None]
        count = counts[min(launch, len(counts) - 1)]
        if count is not None:
            env["JAX_PLATFORMS"] = "cpu"
            flags = [
                f for f in env.get("XLA_FLAGS", "").split()
                if "xla_force_host_platform_device_count" not in f
            ]
            flags.append(f"--xla_force_host_platform_device_count={count}")
            env["XLA_FLAGS"] = " ".join(flags)
        args = [
            sys.executable, "-m", "plutracer_tpu.render.supervisor",
            "--worker", "--scene", scene_path, "--res", f"{width}x{height}",
            "--n", str(n), "--seed", str(seed), "--ckpt", ckpt,
            "--heartbeat", hb, "--out", out,
            "--checkpoint-every", str(checkpoint_every),
        ]
        for a in scene_args or []:
            args += ["--scene-arg", a]
        # the heartbeat must predate the launch so a worker that wedges
        # before its first chunk still times out; a result from an earlier
        # launch must not pass for this one's
        with open(hb, "w"):
            pass
        if os.path.exists(out):
            os.remove(out)
        proc, log = _launch(args, env, log_path)
        events.append(("launch", f"#{launch} devices={count} pid={proc.pid}"))
        failed = None
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc != 0:
                    failed = f"exit code {rc}"
                elif not os.path.exists(out):
                    failed = "exit code 0 without a result"
                break
            if time.time() - os.path.getmtime(hb) > heartbeat_timeout:
                failed = f"heartbeat stale > {heartbeat_timeout}s"
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
                break
            time.sleep(poll)
        log.close()
        if failed is None:
            z = np.load(out)
            events.append(("done", f"after {restarts} restart(s)"))
            return SuperviseResult(
                z["linear"], z["display"], str(z["platform"]), restarts, events
            )
        events.append(("failure", failed))
        restarts += 1
    raise WorkerFailure(
        f"worker failed {max_restarts + 1} times; events: {events}"
    )


# --------------------------------------------------------------------------
# worker entry point (subprocess side)
# --------------------------------------------------------------------------


def _worker(argv: List[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--res", required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--heartbeat", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--scene-arg", action="append", default=[])
    a = ap.parse_args(argv)

    def beat_now() -> None:
        with open(a.heartbeat, "a"):
            pass
        os.utime(a.heartbeat, None)

    beat_now()  # liveness from process start (imports/compiles count)

    import plutracer_tpu

    # a restarted worker must not pay the cold kernel compile again
    plutracer_tpu.enable_compilation_cache()

    from plutracer_tpu.render.elastic import render_elastic
    from plutracer_tpu.scene import compile_scene, load_scene_file

    w, h = (int(v) for v in a.res.split("x"))
    # refuse a checkpoint left by a DIFFERENT job in the same workdir
    # (same seed but another scene/resolution would silently blend): the
    # job fingerprint rides next to the checkpoint
    job = f"{os.path.abspath(a.scene)}|{a.res}|n={a.n}|seed={a.seed}"
    tag = a.ckpt + ".job"
    if os.path.exists(a.ckpt) and os.path.exists(tag):
        with open(tag) as f:
            if f.read() != job:
                raise SystemExit(
                    f"checkpoint {a.ckpt} belongs to a different job; "
                    "remove it or use a fresh workdir"
                )
    with open(tag, "w") as f:
        f.write(job)

    desc = load_scene_file(a.scene, ["/res", a.res, *a.scene_arg])
    scene = compile_scene(desc)
    beat_now()  # the first chunk (with its cold compile) starts here

    def beat(next_pass: int) -> None:
        beat_now()

    img = render_elastic(
        scene, w, h, a.n, a.seed,
        checkpoint_path=a.ckpt, checkpoint_every=a.checkpoint_every,
        on_chunk=beat,
    )
    import jax

    from plutracer_tpu.ops.tonemap import postprocess_image

    tmp = a.out + ".tmp"
    np.savez(
        tmp,
        linear=np.asarray(img, np.float32),
        display=np.asarray(postprocess_image(img), np.float32),
        platform=jax.default_backend(),
    )
    os.replace(tmp + ".npz", a.out)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
