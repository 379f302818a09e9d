"""Postprocess: white-preserving luma-based Reinhard tonemap + gamma 1/2.2.

Reference: plu::postprocesser (src/main.cpp:77-112). Deviation: the
reference divides by luma unguarded, turning pure-black pixels into NaN; we
map black to black.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WHITE = 2.0


def reinhard(color):
    """(..., 3) linear -> tonemapped + gamma. Vectorized over any batch."""
    luma = jnp.sum(color * jnp.array([0.2126, 0.7152, 0.0722]), axis=-1, keepdims=True)
    tone = luma * (1.0 + luma / (WHITE * WHITE)) / (1.0 + luma)
    scale = jnp.where(luma > 0.0, tone / jnp.where(luma == 0.0, 1.0, luma), 0.0)
    c = jnp.maximum(color * scale, 0.0)
    return c ** (1.0 / 2.2)


# one fused program instead of ~8 eager ops
postprocess_image = jax.jit(reinhard)
postprocess_image.__doc__ = "Tonemap a full (H, W, 3) image (the reference's scanline pool)."
