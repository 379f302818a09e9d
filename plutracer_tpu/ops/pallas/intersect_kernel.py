"""Closest-hit kernel: brute-force ray-scene intersection in Pallas (Triton).

`ops.intersect.intersect_lite` builds a (B, P) matrix of hit distances and
reduces it with argmin + take_along_axis; with two consumers, XLA writes
that matrix to device memory (16,384 x 102,403 x 4 B = 6.7 GB per query at
mesh2 and 128^2). This kernel never forms it. Each program of a 1-D grid
owns BLOCK_R rays, walks the primitive tables in CHUNK-wide tiles and folds
a running (best_t, best_prim) in registers.

Layouts:
- rays: six flat (B_pad,) f32 arrays ox..dz, one BLOCK_R block per program;
- primitives: one column-major table per type (`PrimTables`; rows are
  fields, columns are primitives), each padded to a CHUNK multiple with
  never-hit entries. The type of every table is static and so is its
  length, so the kernel runs one loop per type over static bounds, with no
  per-chunk type branch:

    sph (11, N): center xyz | radius | parent-AABB min xyz | max xyz | row
    box  (7, N): min xyz | max xyz | row
    tri (10, N): v0 xyz | e1 = v1 - v0 | e2 = v2 - v0 | row

  `row` is the primitive's scene row (exact in f32 below 2^24), which the
  kernel reports as the winner.

Accept rules are those of ops/intersect.py (sphere: both roots > 0 plus the
parent-AABB line cull; box: tmax >= tmin >= 0; triangle: Moller-Trumbore,
t > 0). Equal distances go to the lowest scene row, as argmin does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from plutracer_tpu.ops.intersect import T_MAX, _BIG
from plutracer_tpu.scene.types import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE

BLOCK_R = 64  # rays per program
CHUNK = 16  # primitives per tile of the inner loop
NUM_WARPS = 4
_NO_ROW = np.iinfo(np.int32).max


class PrimTables(NamedTuple):
    """Per-type primitive tables for the kernel; None where a type is absent."""

    sph: Optional[np.ndarray]
    box: Optional[np.ndarray]
    tri: Optional[np.ndarray]


def _kernel(*refs, present):
    import jax.experimental.pallas as pl

    n_tab = sum(present)
    tabs = dict(zip([k for k, p in zip("sbt", present) if p], refs[:n_tab]))
    ox, oy, oz, dx, dy, dz = (r[...][:, None] for r in refs[n_tab : n_tab + 6])
    t_ref, p_ref = refs[n_tab + 6 :]
    R = t_ref.shape[0]

    def fold(carry, t, rows):
        best_t, best_p = carry
        tmin = jnp.min(t, axis=1)
        cand = jnp.min(jnp.where(t == tmin[:, None], rows, _NO_ROW), axis=1)
        better = (tmin < best_t) | ((tmin == best_t) & (cand < best_p))
        return jnp.where(better, tmin, best_t), jnp.where(better, cand, best_p)

    def walk(tab, carry, tile_t):
        n_fields = tab.shape[0]

        def body(k, carry):
            cols = pl.ds(k * CHUNK, CHUNK)
            f = [tab[i, cols][None, :] for i in range(n_fields)]
            return fold(carry, tile_t(f), f[-1].astype(jnp.int32))

        return jax.lax.fori_loop(0, tab.shape[1] // CHUNK, body, carry)

    def slab(lo, hi, r):
        t1 = [(lo[i] - o) * r[i] for i, o in enumerate((ox, oy, oz))]
        t2 = [(hi[i] - o) * r[i] for i, o in enumerate((ox, oy, oz))]
        near = jnp.maximum(
            jnp.maximum(jnp.minimum(t1[0], t2[0]), jnp.minimum(t1[1], t2[1])),
            jnp.minimum(t1[2], t2[2]),
        )
        far = jnp.minimum(
            jnp.minimum(jnp.maximum(t1[0], t2[0]), jnp.maximum(t1[1], t2[1])),
            jnp.maximum(t1[2], t2[2]),
        )
        return near, far

    def sphere_t(f):
        # ops.intersect.sphere_t + line_hit_aabb against the parent box
        vx, vy, vz = ox - f[0], oy - f[1], oz - f[2]
        b = -(vx * dx + vy * dy + vz * dz)
        det = b * b - (vx * vx + vy * vy + vz * vz) + f[3] * f[3]
        sq = jnp.sqrt(jnp.where(det > 0.0, det, 0.0))
        i1, i2 = b - sq, b + sq
        near, far = slab(f[4:7], f[7:10], r_line)
        ok = (det >= 0.0) & (i1 > 0.0) & (i2 > 0.0) & (far >= near)
        return jnp.where(ok, i1, _BIG)

    def box_t(f):
        near, far = slab(f[0:3], f[3:6], r_box)
        return jnp.where((far >= near) & (near >= 0.0), near, _BIG)

    def triangle_t(f):
        e1x, e1y, e1z, e2x, e2y, e2z = f[3:9]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        idet = 1.0 / jnp.where(det == 0.0, 1.0, det)
        tvx, tvy, tvz = ox - f[0], oy - f[1], oz - f[2]
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * idet
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * idet
        ok = (
            (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
            & (u + v <= 1.0) & (t > 0.0)
        )
        return jnp.where(ok, t, _BIG)

    # per-ray reciprocals, as ops.geometry.Aabb.hit and ops.intersect.box_t
    r_line = [1.0 / jnp.where(c == 0.0, 1e-20, c) for c in (dx, dy, dz)]
    r_box = [1.0 / jnp.where(jnp.abs(c) < 1e-12, 1e-12, c) for c in (dx, dy, dz)]

    carry = (jnp.full((R,), _BIG, jnp.float32), jnp.zeros((R,), jnp.int32))
    for key, tile_t in (("s", sphere_t), ("b", box_t), ("t", triangle_t)):
        if key in tabs:
            carry = walk(tabs[key], carry, tile_t)
    t_ref[...], p_ref[...] = carry


@functools.partial(jax.jit, static_argnames=("interpret",))
def _closest(tables: PrimTables, rays, interpret: bool = False):
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    present = tuple(t is not None for t in tables)
    tabs = [t for t in tables if t is not None]
    B = rays[0].shape[0]
    ray_spec = pl.BlockSpec((BLOCK_R,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(_kernel, present=present),
        grid=(B // BLOCK_R,),
        in_specs=[pl.BlockSpec(t.shape, lambda i: (0, 0)) for t in tabs]
        + [ray_spec] * 6,
        out_specs=[ray_spec, ray_spec],
        out_shape=[
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="closest_hit",
    )(*tabs, *rays)


def _pad_columns(cols: np.ndarray, pad_value: np.ndarray) -> np.ndarray:
    n = cols.shape[1]
    out = np.repeat(pad_value[:, None], -(-n // CHUNK) * CHUNK, axis=1)
    out[:, :n] = cols
    return out.astype(np.float32)


def pack_prims_np(scene) -> PrimTables:
    """Per-type column-major tables for the kernel (pure numpy: runs at
    scene-compile time). Padding never wins: spheres and boxes sit at 1e30
    (any hit has t >> T_MAX, or the arithmetic overflows to a miss) and
    padding triangles are degenerate (det == 0 rejects them). Sphere rows
    in `cull_rows` carry their BVH leaf's parent AABB; the others carry an
    always-hit +-3e38 box."""
    ptype = np.asarray(scene.prim_type, np.int32)
    pa = np.asarray(scene.prim_a, np.float32)
    pb = np.asarray(scene.prim_b, np.float32)
    pc = np.asarray(scene.prim_c, np.float32)
    rows = np.arange(ptype.shape[0], dtype=np.float32)
    tables = []
    for t in (PRIM_SPHERE, PRIM_BOX, PRIM_TRIANGLE):
        (idx,) = np.nonzero(ptype == t)
        if idx.size == 0:
            tables.append(None)
            continue
        if t == PRIM_SPHERE:
            lo = np.full((idx.size, 3), -3.0e38, np.float32)
            hi = np.full((idx.size, 3), 3.0e38, np.float32)
            culled = np.isin(idx, scene.cull_rows or ())
            if culled.any():
                lo[culled] = np.asarray(scene.parent_min)[idx[culled]]
                hi[culled] = np.asarray(scene.parent_max)[idx[culled]]
            cols = np.concatenate(
                [pa[idx], pb[idx, :1], lo, hi, rows[idx, None]], 1
            ).T
            pad = np.array([1e30, 0, 0, 0] + [-3e38] * 3 + [3e38] * 3 + [0])
        elif t == PRIM_BOX:
            cols = np.concatenate([pa[idx], pb[idx], rows[idx, None]], 1).T
            pad = np.array([1e30] * 3 + [2e30] * 3 + [0])
        else:
            e1 = pb[idx] - pa[idx]
            e2 = pc[idx] - pa[idx]
            cols = np.concatenate([pa[idx], e1, e2, rows[idx, None]], 1).T
            pad = np.zeros(10)
        tables.append(_pad_columns(cols, pad))
    return PrimTables(*tables)


def intersect_lite_pallas(o, d, tables: PrimTables, interpret: bool = False):
    """Drop-in for ops.intersect.intersect_lite. o, d: (B, 3)."""
    B = o.shape[0]
    pad = -B % BLOCK_R
    o = jnp.pad(o, ((0, pad), (0, 0)))
    # padded rays get d = (1, 1, 1); their results are sliced off
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    rays = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    t, p = _closest(tables, rays, interpret=interpret)
    return t[:B] < T_MAX, p[:B], t[:B]
