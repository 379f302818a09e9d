"""Derivative-guarded elementary ops for the differentiable path.

Root cause of NaN gradients through the bounce scan: XLA flushes
float32 denormals to zero (FTZ) on accelerators and CPU, and the
reverse-mode rule of ``x / y`` contains ``-ct * x / y**2``. Guard floors
like ``jnp.maximum(y, 1e-20)`` keep the PRIMAL finite, but
``y**2 = 1e-40`` flushes to 0, so a lane whose cotangent is already
zero still computes ``0 * x / 0 = NaN`` — and one NaN lane poisons the
whole summed parameter gradient. Same story for ``rsqrt(u + 1e-30)``:
its derivative factor ``u**-1.5 = 1e45`` overflows float32 outright.
Micro-repro (both backends):

    jax.grad(lambda y: jnp.sum(jnp.where(mask_false, x / y, 0.0)))(1e-20)
    -> NaN   # y*y flushes to 0; 0/0 in the transpose

These wrappers keep the primal BIT-IDENTICAL (raw inputs) and clamp
only inside the derivative, so every transpose factor stays a normal
float32 no matter how extreme the guarded lane is. The clamp floors are
chosen so the distorted-derivative region (|y| < 1e-15, u < 1e-20) lies
far below any lane that can contribute non-negligible radiance — such
lanes are exactly the masked/garbage ones whose cotangent is zero.

custom_jvp (not custom_vjp) keeps the ops forward-differentiable too;
JAX transposes the (linear-in-tangents) jvp for reverse mode, and the
transpose applies the cotangent BEFORE the huge-but-finite factors, so
zero-cotangent lanes yield exact zeros.

No reference counterpart: the reference is forward-only C++
(src/renderer.cpp); this module exists because jax.grad through the
estimator is a capability the reference lacks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# |y| floor inside derivatives: y, y**2 and their reciprocals all stay
# normal float32 (min normal 1.18e-38) with headroom for chain products
DIV_EPS = 1e-15
# u floor inside rsqrt derivatives: uc**-1.5 <= 1e30 << f32 max 3.4e38
RSQRT_EPS = 1e-20


def _mag_clamp(y, eps):
    """y pushed away from 0 to at least +-eps, preserving sign (exact
    zeros become +eps; guarded call sites never pass exact zeros)."""
    return jnp.where(jnp.abs(y) < eps, jnp.where(y < 0.0, -eps, eps), y)


@jax.custom_jvp
def safe_div(x, y):
    """x / y with a derivative that treats |y| as >= DIV_EPS.

    Primal is exactly x / y. Use at sites where y carries a small guard
    floor (1e-20-class) whose square would flush to zero in the
    transpose."""
    return x / y


@safe_div.defjvp
def _safe_div_jvp(primals, tangents):
    x, y = primals
    dx, dy = tangents
    out = x / y
    yc = _mag_clamp(y, DIV_EPS)
    # d(x/y) = dx/y - (x/y) dy/y; reusing the primal quotient avoids y**2
    # entirely, and the transpose applies ct before multiplying by `out`
    return out, (dx - out * dy) / yc


@jax.custom_jvp
def safe_recip(y):
    """1 / y with a derivative that treats |y| as >= DIV_EPS."""
    return 1.0 / y


@safe_recip.defjvp
def _safe_recip_jvp(primals, tangents):
    (y,) = primals
    (dy,) = tangents
    yc = _mag_clamp(y, DIV_EPS)
    rc = 1.0 / yc
    return 1.0 / y, -rc * rc * dy


@jax.custom_jvp
def safe_rsqrt(u):
    """rsqrt(u) with a derivative that treats u as >= RSQRT_EPS.

    The usual epsilon trick rsqrt(u + 1e-30) has an UNGUARDABLE
    derivative: -0.5 * u**-1.5 overflows float32 below u ~ 5e-26."""
    return jax.lax.rsqrt(u)


@safe_rsqrt.defjvp
def _safe_rsqrt_jvp(primals, tangents):
    (u,) = primals
    (du,) = tangents
    uc = jnp.maximum(u, RSQRT_EPS)
    rc = jax.lax.rsqrt(uc)
    return jax.lax.rsqrt(u), (-0.5) * rc * rc * rc * du


def normalize(v, axis=-1, eps=1e-30):
    """v / |v| via the guarded rsqrt: primal identical to
    v * rsqrt(sum(v*v) + eps), derivative finite even at |v| -> 0."""
    return v * safe_rsqrt(jnp.sum(v * v, axis, keepdims=True) + eps)
