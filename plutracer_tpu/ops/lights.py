"""Light sampling: point lights and diffuse area lights.

Reference: inc/light.h:15-35 (point), inc/lights/area_light.h:12-43 (area),
carrier-surface sampling inc/surfaces/{sphere,box,triangle}, and the
solid-angle pdf surface::pdf(p, wi) (inc/surface.h:27-33) whose distance
term is the squared distance of the hit point from the WORLD ORIGIN — a
reference bug that changes images, replicated behind
RenderOptions.origin_distance_pdf.

The primary implementations operate on pre-gathered packed rows
(ops.tables.LightRows / PrimRows) so a bounce issues a handful of gathers
instead of dozens; the scene-based wrappers at the bottom keep the simple
API for tests and tools.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from plutracer_tpu.ops import intersect, safemath
from plutracer_tpu.ops.sampling import uniform_sphere_sample
from plutracer_tpu.ops.tables import (
    LightRows,
    PrimRows,
    gather_light,
    gather_prim,
    pack_tables,
)
from plutracer_tpu.scene.types import (
    LIGHT_AREA,
    LIGHT_POINT,
    PRIM_BOX,
    PRIM_SPHERE,
)
from plutracer_tpu.semantics import RenderOptions


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v):
    # guarded rsqrt: the plain rsqrt derivative overflows f32 below
    # |v|^2 ~ 5e-26 (ps ~ p when the shading point sits on the carrier
    # surface) and one overflowed lane NaNs the summed parameter
    # gradient — see ops/safemath.py
    return v * safemath.safe_rsqrt(jnp.sum(v * v, -1, keepdims=True) + 1e-30)


# ---------------------------------------------------------------------------
# carrier-surface sampling (surface::sample(u, n*))
# ---------------------------------------------------------------------------


def sample_surface_rows(rows: PrimRows, u2, u_face, u_axis):
    """Sample a point + normal on pre-gathered primitive rows.

    - sphere (inc/surfaces/sphere.h:18-22): uniform sphere point.
    - box (inc/surfaces/box.h:23-47): U = (u2.x, u_face, u2.y); snap a
      random axis (u_axis picks 0..2) to its 0/1 face by >0.5; normal is
      that axis's sign.
    - triangle (src/surfaces/triangle.cpp:35-39): barycentric with
      w = 1-(u.x+u.y) (can leave the triangle when u.x+u.y > 1 —
      reference-faithful).
    """
    ptype = rows.ptype
    a, b, c = rows.a, rows.b, rows.c

    # sphere
    ns_s = uniform_sphere_sample(u2)
    ps_s = a + ns_s * b[..., 0:1]

    # box (width-3 dynamic index as selects; see intersect._box_detail note)
    U = jnp.stack([u2[..., 0], u_face, u2[..., 1]], -1)
    mi = jnp.minimum((u_axis * 3.0).astype(jnp.int32), 2)
    picked = jnp.where(
        mi == 0, U[..., 0], jnp.where(mi == 1, U[..., 1], U[..., 2])
    )
    snapped = jnp.where(picked > 0.5, 1.0, 0.0)
    onehot = jax.nn.one_hot(mi, 3, dtype=U.dtype)
    U = U * (1.0 - onehot) + snapped[..., None] * onehot
    ps_b = a + U * (b - a)
    ns_b = onehot * jnp.where(picked > 0.5, 1.0, -1.0)[..., None]

    # triangle
    ux = u2[..., 0:1]
    uy = u2[..., 1:2]
    wz = 1.0 - (ux + uy)
    ps_t = a * ux + b * uy + c * wz
    ns_t = rows.n0 * ux + rows.n1 * uy + rows.n2 * wz

    is_s = (ptype == PRIM_SPHERE)[..., None]
    is_b = (ptype == PRIM_BOX)[..., None]
    ps = jnp.where(is_s, ps_s, jnp.where(is_b, ps_b, ps_t))
    ns = jnp.where(is_s, ns_s, jnp.where(is_b, ns_b, ns_t))
    return ps, ns


def surface_pdf_rows(rows: PrimRows, p, wi, options: RenderOptions):
    """surface::pdf(p, wi) against pre-gathered carrier rows: trace this
    primitive only; 0 on miss, else dist^2 / (|cos| * area) — dist^2 is the
    hit point's squared distance from the WORLD ORIGIN under
    options.origin_distance_pdf (the reference bug), else textbook t^2."""
    t = intersect.prim_t_rows(p, wi, rows)
    found = t < intersect.T_MAX
    ts = jnp.where(found, t, 0.0)
    hitp = p + wi * ts[..., None]
    det = intersect.hit_detail_rows(p, wi, ts, rows.ptype * 0, found, rows)
    if options.origin_distance_pdf:
        dist2 = _dot(hitp, hitp)
    else:
        dist2 = ts * ts
    denom = jnp.abs(_dot(det.norm, -wi)) * rows.area
    # safe_div: the plain transpose divides by denom**2 = 1e-40, which
    # FTZ flushes to 0 -> 0/0 NaN on zero-cotangent lanes (the largest
    # source of NaN gradients before the guard — see ops/safemath.py)
    pdf = safemath.safe_div(dist2, jnp.maximum(denom, 1e-20))
    return jnp.where(found, pdf, 0.0)


# ---------------------------------------------------------------------------
# light interface (row-based)
# ---------------------------------------------------------------------------


class LightSample(NamedTuple):
    Li: jnp.ndarray  # (B,3) incident radiance
    wi: jnp.ndarray  # (B,3) direction to light
    pdf: jnp.ndarray  # (B,)
    is_delta: jnp.ndarray  # (B,) bool


def sample_light_rows(
    lrows: LightRows,
    carrier: PrimRows,
    p,
    u2,
    u_face,
    u_axis,
    options: RenderOptions,
) -> LightSample:
    """light::sampleL(p, smp, &wi, &pdf, &vis) from pre-gathered rows."""
    is_delta = lrows.ltype == LIGHT_POINT

    # point light (inc/light.h:20-27)
    l2p = lrows.pos - p
    len2 = jnp.maximum(_dot(l2p, l2p), 1e-20)
    wi_p = l2p / jnp.sqrt(len2)[..., None]
    # safe_div: len2**2 = 1e-40 flushes to 0 in the plain transpose
    li_p = safemath.safe_div(lrows.intensity, len2[..., None])
    pdf_p = jnp.ones_like(len2)

    # diffuse area light (inc/lights/area_light.h:25-31)
    ps, ns = sample_surface_rows(carrier, u2, u_face, u_axis)
    wi_a = _normalize(ps - p)
    pdf_a = surface_pdf_rows(carrier, p, wi_a, options)
    # L(ps, ns, -wi): one-sided emission using the light's own normal here
    front = _dot(ns, -wi_a) > 0.0
    li_a = jnp.where(front[..., None], lrows.intensity, 0.0)

    d = is_delta[..., None]
    return LightSample(
        Li=jnp.where(d, li_p, li_a),
        wi=jnp.where(d, wi_p, wi_a),
        pdf=jnp.where(is_delta, pdf_p, pdf_a),
        is_delta=is_delta,
    )


def light_pdf_rows(lrows: LightRows, carrier: PrimRows, p, wi, options):
    """light::pdf(p, wi): 0 for delta lights, surface pdf for area lights."""
    pdf_a = surface_pdf_rows(carrier, p, wi, options)
    return jnp.where(lrows.ltype == LIGHT_AREA, pdf_a, 0.0)


def emitted_rows(prim_rows: PrimRows, lrows_of_prim: LightRows, norm, w):
    """material::Le at a hit: the linked area light's one-sided Lemit
    (area_light.h:21-23 via material.cpp:67-70); 0 for non-emissive.
    lrows_of_prim: light rows gathered at max(prim_rows.light, 0)."""
    has = prim_rows.light >= 0
    gate = _dot(norm, w) > 0.0
    return jnp.where((has & gate)[..., None], lrows_of_prim.intensity, 0.0)


# ---------------------------------------------------------------------------
# scene-based wrappers (tests/tools API)
# ---------------------------------------------------------------------------


def sample_surface(scene, prim_idx, u2, u_face, u_axis):
    rows = gather_prim(pack_tables(scene), prim_idx)
    return sample_surface_rows(rows, u2, u_face, u_axis)


def surface_pdf(scene, prim_idx, p, wi, options: RenderOptions):
    rows = gather_prim(pack_tables(scene), prim_idx)
    return surface_pdf_rows(rows, p, wi, options)


def sample_light(
    scene, light_idx, p, u2, u_face, u_axis, options: RenderOptions
) -> LightSample:
    tables = pack_tables(scene)
    lrows = gather_light(tables, light_idx)
    carrier = gather_prim(tables, jnp.maximum(lrows.prim, 0))
    return sample_light_rows(lrows, carrier, p, u2, u_face, u_axis, options)


def light_pdf(scene, light_idx, p, wi, options: RenderOptions):
    tables = pack_tables(scene)
    lrows = gather_light(tables, light_idx)
    carrier = gather_prim(tables, jnp.maximum(lrows.prim, 0))
    return light_pdf_rows(lrows, carrier, p, wi, options)


def emitted(scene, prim_idx, norm, w):
    tables = pack_tables(scene)
    prows = gather_prim(tables, prim_idx)
    lrows = gather_light(tables, jnp.maximum(prows.light, 0))
    return emitted_rows(prows, lrows, norm, w)
