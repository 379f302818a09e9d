"""Ray-primitive intersection.

Faithful ports of the reference hit predicates — these are load-bearing for
shadow rays, which the reference traces with *zero* origin offset and which
only avoid self-intersection because of the exact accept rules:

- sphere (src/surfaces/sphere.cpp:16-27): hit iff BOTH quadratic roots are
  strictly positive; t = near root. Consequence: rays starting inside a
  sphere (e.g. refracted rays in glass) do NOT hit it from inside.
- box (src/surfaces/box.cpp:6-35): slab test; miss if tmax < tmin or
  tmin < 0; t = tmin. Consequence: rays starting inside a box miss it.
- triangle (src/surfaces/triangle.cpp:5-33): Moller-Trumbore, accept
  0 < t < t_best.

The scene-level query is a brute-force closest-hit over the whole primitive
table: compute t for every (ray, primitive) pair branchlessly and min-reduce
over primitives. This is the correctness oracle; the BVH path (ops/bvh.py)
must agree with it exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from plutracer_tpu.ops import safemath
from plutracer_tpu.scene.types import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE

T_MAX = 100000.0  # hit_record initial t (inc/cmmn.h:228)
_BIG = 3.0e37  # sentinel for "no hit" inside reductions


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def safe_sqrt(x):
    """sqrt with a finite gradient at 0 (guards the masked-off branch of
    jnp.where selects from poisoning gradients with 0 * inf = NaN)."""
    return jnp.sqrt(jnp.where(x > 0.0, x, 1.0)) * jnp.where(x > 0.0, 1.0, 0.0)


# ---------------------------------------------------------------------------
# per-primitive t computation (vectorized over rays x prims)
# ---------------------------------------------------------------------------


def sphere_t(o, d, center, radius):
    """Both-roots-positive accept rule. o,d: (...,3); center: (3,) or broadcast."""
    v = o - center
    b = -_dot(v, d)
    det = b * b - _dot(v, v) + radius * radius
    ok = det >= 0
    sq = safe_sqrt(det)
    i1 = b - sq
    i2 = b + sq
    hit = ok & (i1 > 0.0) & (i2 > 0.0)
    return jnp.where(hit, i1, _BIG)


def box_t(o, d, bmin, bmax):
    """Slab test; miss when tmin < 0 (so origins inside the box miss).

    The parallel-ray guard substitutes 1e-12 for |d| < 1e-12 (not the
    historical 1e-20-for-exact-zero): at scene scale both make the slab
    interval effectively (-inf, inf) on that axis — same accept/reject —
    but 1/1e-20 overflows an approximate reciprocal to +inf, and that
    inf residual NaN-poisons reverse-mode gradients through the
    differentiable-t recompute (0 * inf on masked lanes). Degenerate
    shading frames (semantics.py) emit directions with EXACT zero
    components, so this path is hot, not theoretical."""
    rrd = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    t1 = (bmin - o) * rrd
    t2 = (bmax - o) * rrd
    m12 = jnp.minimum(t1, t2)
    x12 = jnp.maximum(t1, t2)
    tmin = jnp.max(m12, axis=-1)
    tmax = jnp.min(x12, axis=-1)
    # reference rejects tmax < tmin or tmin < 0 (box.cpp:29); tmin == 0 hits
    hit = (tmax >= tmin) & (tmin >= 0.0)
    return jnp.where(hit, tmin, _BIG)


def triangle_t(o, d, v0, v1, v2):
    """Moller-Trumbore; accept t > 0 (det == 0 rejected)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = jnp.cross(d, e2)
    det = _dot(e1, pv)
    safe_det = jnp.where(det == 0.0, 1.0, det)
    # guarded recip: det can be tiny-but-nonzero (near-degenerate ray/
    # triangle configs); the plain transpose divides by det**2 which
    # flushes to 0 below |det| ~ 1e-19 — see ops/safemath.py
    idet = safemath.safe_recip(safe_det)
    tv = o - v0
    u = _dot(tv, pv) * idet
    qv = jnp.cross(tv, e1)
    v = _dot(d, qv) * idet
    t = _dot(e2, qv) * idet
    hit = (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return jnp.where(hit, t, _BIG)


# ---------------------------------------------------------------------------
# scene-level closest hit
# ---------------------------------------------------------------------------


class Hit(NamedTuple):
    """Batched hit records (the SoA analog of plu::hit_record)."""

    found: jnp.ndarray  # (B,) bool
    t: jnp.ndarray  # (B,)
    prim: jnp.ndarray  # (B,) int32 winning primitive row (0 if none)
    p: jnp.ndarray  # (B,3) hit point o + d*t
    norm: jnp.ndarray  # (B,3) (triangle: unnormalized cross(U,V), see below)
    uv: jnp.ndarray  # (B,2) texture coords
    dpdu: jnp.ndarray  # (B,3) raw dpdu (shading frame S = normalize(dpdu))


def _prim_t_batched(o, d, ptype, a, b, c):
    ts = sphere_t(o, d, a, b[..., 0])
    tb = box_t(o, d, a, b)
    tt = triangle_t(o, d, a, b, c)
    return jnp.where(
        ptype == PRIM_SPHERE, ts, jnp.where(ptype == PRIM_BOX, tb, tt)
    )


def line_hit_aabb(o, d, mn, mx):
    """Reference aabb::hit (inc/cmmn.h:150-172): slab LINE test, hit iff
    tmax >= tmin — no positivity, boxes fully behind the ray still 'hit'.
    Broadcasts over leading dims of (o, d) x (mn, mx). Delegates to the
    math-core Aabb (ops/geometry.py), which owns the cmmn.h box kit."""
    from plutracer_tpu.ops.geometry import Aabb

    return Aabb(mn, mx).hit(o, d)


def intersect_ts(scene, o, d):
    """(B, P) t values with _BIG where missed.

    Sphere rows additionally require the reference bvh_tree's
    internal-node culling, collapsed to one slab LINE test against the
    leaf's parent AABB (see ops.bvh.parent_bounds_tables) — this discards
    exactly the phantom hits of non-unit rays that the reference's
    traversal never reaches."""
    tmat = _prim_t_batched(
        o[:, None, :],
        d[:, None, :],
        scene.prim_type[None, :],
        scene.prim_a[None, :],
        scene.prim_b[None, :],
        scene.prim_c[None, :],
    )
    rows = getattr(scene, "cull_rows", None)
    if rows and scene.parent_min is not None:
        ridx = jnp.asarray(rows, jnp.int32)
        elig = line_hit_aabb(
            o[:, None, :],
            d[:, None, :],
            scene.parent_min[ridx][None, :, :],
            scene.parent_max[ridx][None, :, :],
        )  # (B, S)
        tmat = tmat.at[:, ridx].set(jnp.where(elig, tmat[:, ridx], _BIG))
    return tmat


def intersect_lite(scene, o, d, t_max: float = T_MAX):
    """Closest-hit query without shading detail: (found, prim, t).

    Shadow/visibility rays (renderer.cpp:16,41) only consult the hit
    surface's identity, so skipping hit_detail halves the NEE cost.
    """
    tmat = intersect_ts(scene, o, d)  # (B, P)
    prim = jnp.argmin(tmat, axis=1).astype(jnp.int32)
    t = jnp.take_along_axis(tmat, prim[:, None], axis=1)[:, 0]
    found = t < t_max
    return found, prim, t


def intersect_closest(scene, o, d, t_max: float = T_MAX) -> Hit:
    """Closest-hit query + full shading detail for the winner."""
    found, prim, t = intersect_lite(scene, o, d, t_max)
    return hit_detail(scene, o, d, t, prim, found)


# ---------------------------------------------------------------------------
# backend dispatch
# ---------------------------------------------------------------------------


def _resolve_backend(options) -> str:
    """auto = the Pallas (Triton) kernel on a GPU, XLA brute force elsewhere.

    On an H100 the kernel beats XLA's brute force at every primitive count
    measured, from 9 to 102,403, by about 2x end to end (PERF.md, "Closest
    hit: kernel vs XLA"), so the choice does not depend on the scene. The
    BVH path is a semantic oracle and serves CPU AD experiments; it is
    never auto-selected (its lockstep skip-link walk gathers one node per
    ray per step)."""
    backend = getattr(options, "intersect_backend", "auto")
    if backend == "auto":
        backend = "pallas" if jax.default_backend() == "gpu" else "xla"
    return backend


def query_lite(scene, o, d, options):
    """Closest-hit (found, prim, t) via the configured backend.

    All backends return the same winner; t is recomputed differentiably at
    the winning primitive afterwards (`query_closest`), so Pallas (no AD
    rule) and the BVH while_loop (no reverse AD) stay usable under grad.
    """
    backend = _resolve_backend(options)
    if backend == "pallas" and scene.prims_packed is not None:
        from plutracer_tpu.ops.pallas.intersect_kernel import intersect_lite_pallas

        # stop_gradient EVERY kernel input (rays AND the packed tables):
        # pallas_call has no JVP rule, and under value_and_grad a
        # symbolically-nonzero tangent on any input invokes it. The table
        # tangent arises when the whole scene is a vjp argument. The winner
        # (found, prim) is discrete and t is recomputed differentiably
        # downstream (query_closest, render/integrator.py).
        found, prim, t = intersect_lite_pallas(
            jax.lax.stop_gradient(o),
            jax.lax.stop_gradient(d),
            jax.tree.map(jax.lax.stop_gradient, scene.prims_packed),
            interpret=getattr(options, "pallas_interpret", False),
        )
        return found, prim, jax.lax.stop_gradient(t)
    if backend == "bvh" and scene.bvh is not None:
        from plutracer_tpu.ops.bvh import bvh_closest

        found, prim, t = bvh_closest(
            scene, scene.bvh,
            jax.lax.stop_gradient(o), jax.lax.stop_gradient(d),
        )
        return found, prim, jax.lax.stop_gradient(t)
    return intersect_lite(scene, o, d)


def query_closest(scene, o, d, options) -> Hit:
    """Backend-dispatched closest hit with shading detail and a
    differentiable t (recomputed at the winning primitive)."""
    found, prim, t = query_lite(scene, o, d, options)
    backend = _resolve_backend(options)
    if backend != "xla":
        # one differentiable ray-vs-one-primitive evaluation per ray.
        # Accept it only when it agrees the ray hits: on knife-edge lanes
        # the kernel winner and the XLA accept rules can disagree, and a
        # _BIG sentinel on a found=True lane makes p ~ 1e37 downstream
        # (overflows dots -> NaN backward; see render/integrator.py)
        t_diff = intersect_prim_t(scene, prim, o, d)
        t = jnp.where(found & (t_diff < T_MAX), t_diff, t)
    return hit_detail(scene, o, d, t, prim, found)


def intersect_prim_t(scene, prim_idx, o, d):
    """t for a *single* primitive row per ray (used by area-light pdfs)."""
    a = scene.prim_a[prim_idx]
    b = scene.prim_b[prim_idx]
    c = scene.prim_c[prim_idx]
    ptype = scene.prim_type[prim_idx]
    return _prim_t_batched(o, d, ptype, a, b, c)


# ---------------------------------------------------------------------------
# shading detail for the winning primitive
# ---------------------------------------------------------------------------


def _sphere_detail(p, norm_in, center, radius):
    """UV/normal/dpdu per the reference's polar-coordinate code
    (src/surfaces/sphere.cpp:28-44). Note dpdu uses the *world* hit point."""
    norm = norm_in  # normalize(p - center), computed by caller
    cos_phi = -norm[..., 1]
    phi = jnp.arccos(jnp.clip(cos_phi, -1.0, 1.0))
    sin_phi = jnp.sin(phi)
    v = phi * (1.0 / jnp.pi)
    safe_sin = jnp.where(sin_phi == 0.0, 1.0, sin_phi)
    ct = jnp.clip(-norm[..., 2] / safe_sin, -1.0, 1.0)
    theta = jnp.arccos(ct) * (2.0 / jnp.pi)
    theta = jnp.where(sin_phi == 0.0, 0.0, theta)
    theta = jnp.where(norm[..., 0] >= 0.0, 1.0 - theta, theta)
    uv = jnp.stack([theta, v], -1)
    two_pi = 2.0 * jnp.pi
    dpdu = jnp.stack(
        [-two_pi * p[..., 1], two_pi * p[..., 0], jnp.zeros_like(p[..., 0])], -1
    )
    # degenerate dpdu (hit point on the world z-axis): fall back to any tangent
    deg = _dot(dpdu, dpdu) < 1e-20
    fallback = jnp.cross(jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), norm.shape), norm)
    dpdu = jnp.where(deg[..., None], fallback, dpdu)
    return norm, uv, dpdu


def _box_detail(p, bmin, bmax):
    """Nearest-face normal (src/surfaces/box.cpp:37-62) and the reference's
    uv/dpdu index maps (box.cpp:29-33 with unsigned (mci-1)%3 arithmetic:
    mci=0 -> uv=(p.x,p.y), dpdu=x; mci=1 -> uv=(p.x,p.z), dpdu=x;
    mci=2 -> uv=(p.y,p.x), dpdu=y). mci is the LAST axis with nonzero normal
    component, and for x-faces dpdu is parallel to the normal (degenerate
    shading frame) — reference-faithful."""
    center = (bmin + bmax) * 0.5
    extents = bmax - center
    np_ = p - center
    dist = jnp.abs(extents - jnp.abs(np_))  # (B,3)
    # reference loop keeps the FIRST minimum (strict <)
    mci = jnp.argmin(dist, axis=-1)
    sign = jnp.sign(np_)
    sign = jnp.where(sign == 0.0, 1.0, sign)

    # tiny-axis dynamic indexing as arithmetic selects (a width-3
    # take_along_axis lowers to a gather; these selects fuse into neighbors)
    def pick3(v, idx):
        return jnp.where(
            idx == 0, v[..., 0], jnp.where(idx == 1, v[..., 1], v[..., 2])
        )

    norm = jax.nn.one_hot(mci, 3, dtype=p.dtype) * pick3(sign, mci)[..., None]
    # uv/dpdu index maps: mci=0 -> (0,1); 1 -> (0,2); 2 -> (1,0)
    idx_u = jnp.where(mci == 2, 1, 0)
    idx_v = jnp.where(mci == 0, 1, jnp.where(mci == 1, 2, 0))
    uv = jnp.stack([pick3(p, idx_u), pick3(p, idx_v)], -1)
    dpdu = jax.nn.one_hot(idx_u, 3, dtype=p.dtype)
    return norm, uv, dpdu


def _triangle_detail(o, d, v0, v1, v2, uv0, uv1, uv2):
    """Geometric normal cross(U,V) of *normalized* edges, left unnormalized
    (|n| = sin(angle) < 1 darkens cosine terms — reference-faithful,
    src/surfaces/triangle.cpp:27), and the reference's swapped barycentric
    texture interp (weight u on corner 0)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = jnp.cross(d, e2)
    det = _dot(e1, pv)
    idet = safemath.safe_recip(jnp.where(det == 0.0, 1.0, det))
    tv = o - v0
    u = _dot(tv, pv) * idet
    qv = jnp.cross(tv, e1)
    v = _dot(d, qv) * idet
    w = 1.0 - (u + v)
    # safe_sqrt (finite gradient at 0; primal == linalg.norm) + safe_div
    # (guard floor squared would flush to 0 in the plain transpose)
    n1 = safe_sqrt(_dot(e1, e1))[..., None]
    n2 = safe_sqrt(_dot(e2, e2))[..., None]
    U = safemath.safe_div(e1, jnp.maximum(n1, 1e-20))
    V = safemath.safe_div(e2, jnp.maximum(n2, 1e-20))
    norm = jnp.cross(U, V)
    uv = uv0 * u[..., None] + uv1 * v[..., None] + uv2 * w[..., None]
    return norm, uv, U


def hit_detail_rows(o, d, t, prim, found, rows) -> Hit:
    """Shading detail from pre-gathered primitive rows (ops.tables.PrimRows).

    One packed-row gather upstream replaces the ~9 per-field gathers this
    function used to issue."""
    a = rows.a
    b = rows.b
    c = rows.c
    ptype = rows.ptype
    # clamp t on missed lanes: t = _BIG would overflow p's dot products to
    # inf, and any NaN in masked-off primals still poisons reverse-mode
    # gradients (0 * NaN = NaN in the vjp). Found lanes are additionally
    # capped at T_MAX in case a sentinel ever leaks through a backend
    # disagreement (belt to query_closest's braces).
    t_safe = jnp.where(found, jnp.minimum(t, T_MAX), 1.0)
    p = o + d * t_safe[..., None]

    sp_norm = p - a
    # guarded rsqrt: p ~ a happens constantly on NON-sphere lanes (a is
    # then a triangle vertex / box corner and p lies on that primitive);
    # the unselected sphere branch still runs and plain rsqrt's
    # derivative overflows f32 there — see ops/safemath.py
    sp_norm = sp_norm * safemath.safe_rsqrt(
        jnp.sum(sp_norm * sp_norm, -1, keepdims=True) + 1e-30
    )
    sn, suv, sdpdu = _sphere_detail(p, sp_norm, a, b[..., 0])
    bn, buv, bdpdu = _box_detail(p, a, b)
    tn, tuv, tdpdu = _triangle_detail(o, d, a, b, c, rows.uv0, rows.uv1, rows.uv2)

    is_s = (ptype == PRIM_SPHERE)[..., None]
    is_b = (ptype == PRIM_BOX)[..., None]
    norm = jnp.where(is_s, sn, jnp.where(is_b, bn, tn))
    uv = jnp.where(is_s, suv, jnp.where(is_b, buv, tuv))
    dpdu = jnp.where(is_s, sdpdu, jnp.where(is_b, bdpdu, tdpdu))

    # uv/dpdu feed piecewise-constant texture lookups and the (detached)
    # sampling frame; their analytic gradients are zero for the supported
    # parameter set but their chains pass through arccos(+-1) etc. whose
    # inf derivatives would poison the backward pass
    uv = jax.lax.stop_gradient(uv)
    dpdu = jax.lax.stop_gradient(dpdu)

    return Hit(found=found, t=t, prim=prim, p=p, norm=norm, uv=uv, dpdu=dpdu)


def hit_detail(scene, o, d, t, prim, found) -> Hit:
    """Gather the winning primitive's params and compute shading detail."""
    from plutracer_tpu.ops.tables import gather_prim, pack_tables

    rows = gather_prim(pack_tables(scene), prim)
    return hit_detail_rows(o, d, t, prim, found, rows)


def prim_t_rows(o, d, rows):
    """t for one pre-gathered primitive row per ray."""
    return _prim_t_batched(o, d, rows.ptype, rows.a, rows.b, rows.c)
