"""Command-line driver (reference: src/main.cpp:115-215).

Usage parity with the reference:

    python -m plutracer_tpu [/i] <scene.urn> [/res WxH] [/smp N]

- ``/i`` opens the urn REPL first (``:!q`` continues, ``:!x`` exits 42);
- ``/res WxH`` and ``/smp N`` override scene resolution / AA samples
  (spp = N^2, matching src/main.cpp:170's uvec2(N) stratified grid);
- output: ``image_<epoch-ns>.bmp`` with the watermark (scene path + phase
  timings + mode tag) drawn twice for a drop shadow.

Extensions over the reference (flags, all optional):
- ``/o PATH`` explicit output path;
- ``/seed N`` RNG seed (renders are deterministic per seed);
- ``/profile DIR`` capture a jax.profiler trace of the render phase;
- ``/checkpoint PATH`` save/resume progressive accumulation state;
- ``/supervise`` run the render under the failure-detecting supervisor
  (render/supervisor.py): the render happens in a worker subprocess with
  heartbeat liveness + checkpointing, and crashes/hangs are detected and
  restarted from the last checkpoint (resumable across device counts).
  With ``/supervise``, ``/checkpoint`` names the supervisor's work
  DIRECTORY (heartbeat + checkpoint + result live there); without it, a
  per-(scene, resolution, seed) directory is created in the cwd.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np


def pathlib_stem(path: str) -> str:
    import pathlib

    return pathlib.Path(path).stem


def _pop_flag(args: List[str], flag: str, has_value: bool = True):
    if flag in args:
        i = args.index(flag)
        if has_value:
            v = args[i + 1]
            del args[i : i + 2]
            return v
        del args[i]
        return True
    return None if has_value else False


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)

    if args and args[0] == "/i":
        args.pop(0)
        from plutracer_tpu.urn.repl import run_repl

        run_repl()
        if not args:
            return 0

    if not args:
        print(
            "usage: plutracer [/i] <scene.urn> [/res WxH] [/smp N] "
            "[/o out.bmp] [/supervise]"
        )
        return 2

    out_path = _pop_flag(args, "/o")
    seed = int(_pop_flag(args, "/seed") or 0)
    profile_dir = _pop_flag(args, "/profile")
    checkpoint = _pop_flag(args, "/checkpoint")
    supervise = _pop_flag(args, "/supervise", has_value=False)

    scn_path = args.pop(0)
    print(f"loading scene {scn_path}")

    import plutracer_tpu

    plutracer_tpu.enable_compilation_cache()

    # --- init phase: parse (+ compile, unless supervised) scene ---
    init_start = time.perf_counter()
    from plutracer_tpu.scene import compile_scene, load_scene_file

    desc = load_scene_file(scn_path, args)
    width, height = desc.resolution
    if not supervise:
        scene = compile_scene(desc)
    init_end = time.perf_counter()

    # --- render phase ---
    print("rendering... ")

    render_start = time.perf_counter()
    if supervise:
        # device work happens in the worker subprocess only: the driver
        # just watches the heartbeat and restarts from the checkpoint
        if profile_dir:
            print("(/profile is ignored under /supervise: the render "
                  "runs in a worker process)")
        from plutracer_tpu.render.supervisor import supervise_render

        workdir = checkpoint or (
            f".supervise_{pathlib_stem(scn_path)}_{width}x{height}_s{seed}"
        )
        result = supervise_render(
            scn_path, width, height, desc.samples, seed, workdir
        )
        if result.restarts:
            print(f"(recovered from {result.restarts} worker failure(s))")
        linear = result.image
        platform = result.platform
    else:
        import jax

        platform = jax.default_backend()
        from plutracer_tpu.render.progressive import render_with_checkpoint

        if profile_dir:
            jax.profiler.start_trace(profile_dir)
        linear = render_with_checkpoint(
            scene,
            width,
            height,
            desc.samples,
            seed=seed,
            checkpoint_path=checkpoint,
        )
        linear.block_until_ready()
        if profile_dir:
            jax.profiler.stop_trace()
    render_end = time.perf_counter()

    # --- postprocess phase ---
    print("postprocessing... ")
    from plutracer_tpu.ops.tonemap import postprocess_image

    pp_start = time.perf_counter()
    # the supervised worker tonemaps on its device: this process stays off it
    img = np.array(result.display if supervise else postprocess_image(linear))
    pp_end = time.perf_counter()
    print("... finished")

    init_ms = int((init_end - init_start) * 1000)
    render_ms = int((render_end - render_start) * 1000)
    pp_ms = int((pp_end - pp_start) * 1000)
    watermark = (
        f"scene: {scn_path}\n"
        f"init took: {init_ms}ms\n"
        f"render took: {render_ms}ms\n"
        f"postprocess took: {pp_ms}ms\n"
        f"{platform}\n"
    )
    print(watermark, end="")

    from plutracer_tpu.io.font import draw_text

    draw_text(img, watermark, (9, 10), (0.2, 0.2, 0.2))  # drop shadow
    draw_text(img, watermark, (8, 8), (1.0, 0.6, 0.0))

    from plutracer_tpu.io.bmp import write_bmp

    if out_path is None:
        out_path = f"image_{time.time_ns()}.bmp"
    write_bmp(out_path, img)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
