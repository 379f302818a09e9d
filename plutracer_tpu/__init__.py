"""plutracer: a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
plutracer reference renderer (C++14, CPU):

- the **urn** scene-description DSL (tokenizer / values / evaluator / stdlib / REPL)
- a scene compiler producing structure-of-arrays scene representations
- wavefront path tracing with next-event estimation + MIS on megabatches of rays
- sphere / box / triangle-mesh geometry, BVH acceleration
- Lambert / specular-reflection / specular-transmission / glass BSDFs,
  procedural + image textures
- point and diffuse-area lights
- Reinhard tonemapping, BMP I/O, bitmap-font watermarks
- end-to-end differentiability (pixel loss -> material/texture/light params)
- multi-device scaling via jax.sharding meshes + shard_map

Scenes are arrays, rays are megabatches, the bounce loop is a fixed-depth
`lax.scan` with alive masks, RNG is counter-based `jax.random`, and
accelerator control flow is branchless masked select.
"""

__version__ = "0.1.0"

import os as _os


# default persistent compile cache: a fixed directory inside the checkout
# (listed in .gitignore), so every process of this checkout finds it again
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache so repeat CLI / bench /
    worker processes skip recompiles. The directory is
    JAX_COMPILATION_CACHE_DIR when that is set, else CACHE_DIR. Opt out
    with PLUTRACER_NO_CACHE=1 (the tests do)."""
    if _os.environ.get("PLUTRACER_NO_CACHE"):
        return
    import jax

    cache = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    _os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


from plutracer_tpu.semantics import RenderOptions  # noqa: F401
