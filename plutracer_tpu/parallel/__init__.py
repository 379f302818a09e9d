"""Multi-device scaling: device meshes, sharded rendering, sharded training.

The reference's only parallelism is a shared-memory tile queue over
std::threads (src/renderer.cpp:106-149). Here the analog axes are:

- ``tiles``: data parallelism over the pixel/ray batch (each device owns a
  contiguous shard of the megabatch; no communication in the forward pass);
- ``spp``: parallelism over stratified sample passes (accumulation is a
  single psum over the axis).

Scene/BVH arrays are replicated (they're small); ray state is sharded.
Inverse rendering all-reduces parameter gradients with psum, which XLA
overlaps with the backward pass. Multi-host runs use jax.distributed +
the same mesh spanning all processes.
"""

from plutracer_tpu.parallel.mesh import make_mesh
from plutracer_tpu.parallel.sharded import render_sharded, make_train_step

__all__ = ["make_mesh", "render_sharded", "make_train_step"]
