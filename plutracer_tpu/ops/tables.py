"""Packed gather tables.

The integrator reads dozens of per-field columns per hit
(scene.prim_a[prim], scene.mat_color[mat], ...). Packing each entity's
fields into one row matrix turns ~40 gathers per bounce into ~5: gather one
(B, W) row block, then slice columns (free — same layout).

Packing happens at *trace time* from the SceneArrays fields, so gradients
flow through the pack into the original differentiable leaves
(mat_color, light_intensity, tex_c0/c1).

Column layouts (all f32; integer ids are exact in f32 below 2^24):

prim (W=32): 0 type | 1:4 a | 4:7 b | 7:10 c | 10:13 n0 | 13:16 n1 |
             16:19 n2 | 19:21 uv0 | 21:23 uv1 | 23:25 uv2 | 25 material |
             26 light | 27 area | 28:32 pad
mat  (W=12): 0 type | 1:4 color | 4 tex | 5:8 eta | 8:11 k | 11 pad
tex  (W=12): 0 type | 1:4 c0 | 4:7 c1 | 7 scale | 8 line | 9 ofs | 10 w | 11 h
light (W=8): 0 type | 1:4 pos | 4:7 intensity | 7 prim
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Row-gather strategy thresholds: a select chain (tiny tables) or a one-hot
# matmul (small tables) computes the same rows as a gather and fuses into
# its neighbours. Whether each tier still beats a plain gather on the GPU
# is not measured (ROADMAP Queue 1 item 6).
_SELECT_MAX = 16  # unrolled where-chain (fuses into consumers)
# one-hot matmul (HIGHEST = exact for f32, no TF32); the (B, P) one-hot
# grows with P, so above this size the native gather is used
_ONEHOT_MAX = 320


def _rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] with gather-free lowerings for small tables.

    All variants are bit-exact and differentiable w.r.t. `table` (the
    where/matmul vjps are the scatter-add the gather would have produced).

    Index semantics: out-of-range indices clamp to [0, P-1] in EVERY tier —
    including negatives, which clamp to row 0 (NOT Python/jnp wrap-around:
    table[-1] here is row 0, not row P-1). All call sites pre-clamp
    sentinel -1 indices with jnp.maximum(idx, 0) anyway; the clamp makes
    that explicit and uniform across tiers.

    The one-hot tier assumes an all-finite table: 0 * inf = NaN would
    poison every output lane, not just the lane selecting the bad row
    (scene tables are validated finite at load time; see
    scene.compile._assert_finite).
    """
    P = table.shape[0]
    idx = jnp.clip(idx, 0, P - 1)
    if P <= _SELECT_MAX:
        out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
        for p in range(1, P):
            out = jnp.where((idx == p)[..., None], table[p], out)
        return out
    if P <= _ONEHOT_MAX:
        oh = (idx[..., None] == jnp.arange(P, dtype=idx.dtype)).astype(table.dtype)
        return jax.lax.dot_general(
            oh,
            table,
            (((oh.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    return table[idx]


def _col(table: jnp.ndarray, idx: jnp.ndarray, col: int) -> jnp.ndarray:
    """table[idx, col] as a select chain (single-column variant of _rows;
    same index semantics: negatives/overflow clamp to [0, P-1])."""
    P = table.shape[0]
    idx = jnp.clip(idx, 0, P - 1)
    c = table[:, col]
    if P <= _SELECT_MAX:
        out = jnp.full(idx.shape, c[0], table.dtype)
        for p in range(1, P):
            out = jnp.where(idx == p, c[p], out)
        return out
    if P <= _ONEHOT_MAX:
        oh = (idx[..., None] == jnp.arange(P, dtype=idx.dtype)).astype(table.dtype)
        return jax.lax.dot_general(
            oh,
            c,
            (((oh.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    return c[idx]


class PackedTables(NamedTuple):
    prim: jnp.ndarray  # (P, 32)
    mat: jnp.ndarray  # (M, 12)
    tex: jnp.ndarray  # (T, 12)
    light: jnp.ndarray  # (L, 8)


def pack_tables(scene) -> PackedTables:
    f = lambda x: x.astype(jnp.float32)
    c1 = lambda x: f(x)[:, None]
    P = scene.prim_type.shape[0]
    prim = jnp.concatenate(
        [
            c1(scene.prim_type),
            f(scene.prim_a),
            f(scene.prim_b),
            f(scene.prim_c),
            f(scene.prim_n0),
            f(scene.prim_n1),
            f(scene.prim_n2),
            f(scene.prim_uv0),
            f(scene.prim_uv1),
            f(scene.prim_uv2),
            c1(scene.prim_material),
            c1(scene.prim_light),
            c1(scene.prim_area),
            jnp.zeros((P, 4), jnp.float32),
        ],
        axis=1,
    )
    M = scene.mat_type.shape[0]
    mat = jnp.concatenate(
        [
            c1(scene.mat_type),
            f(scene.mat_color),
            c1(scene.mat_tex),
            f(scene.mat_eta),
            f(scene.mat_k),
            jnp.zeros((M, 1), jnp.float32),
        ],
        axis=1,
    )
    T = scene.tex_type.shape[0]
    tex = jnp.concatenate(
        [
            c1(scene.tex_type),
            f(scene.tex_c0),
            f(scene.tex_c1),
            c1(scene.tex_scale),
            c1(scene.tex_line),
            c1(scene.tex_img_ofs),
            c1(scene.tex_img_w),
            c1(scene.tex_img_h),
        ],
        axis=1,
    )
    light = jnp.concatenate(
        [
            c1(scene.light_type),
            f(scene.light_pos),
            f(scene.light_intensity),
            c1(scene.light_prim),
        ],
        axis=1,
    )
    return PackedTables(prim=prim, mat=mat, tex=tex, light=light)


class PrimRows(NamedTuple):
    """Column views over gathered primitive rows (B, 32)."""

    rows: jnp.ndarray

    @property
    def ptype(self):
        return self.rows[..., 0].astype(jnp.int32)

    @property
    def a(self):
        return self.rows[..., 1:4]

    @property
    def b(self):
        return self.rows[..., 4:7]

    @property
    def c(self):
        return self.rows[..., 7:10]

    @property
    def n0(self):
        return self.rows[..., 10:13]

    @property
    def n1(self):
        return self.rows[..., 13:16]

    @property
    def n2(self):
        return self.rows[..., 16:19]

    @property
    def uv0(self):
        return self.rows[..., 19:21]

    @property
    def uv1(self):
        return self.rows[..., 21:23]

    @property
    def uv2(self):
        return self.rows[..., 23:25]

    @property
    def material(self):
        return self.rows[..., 25].astype(jnp.int32)

    @property
    def light(self):
        return self.rows[..., 26].astype(jnp.int32)

    @property
    def area(self):
        return self.rows[..., 27]


class MatRows(NamedTuple):
    rows: jnp.ndarray  # (B, 12)

    @property
    def mtype(self):
        return self.rows[..., 0].astype(jnp.int32)

    @property
    def color(self):
        return self.rows[..., 1:4]

    @property
    def tex(self):
        return self.rows[..., 4].astype(jnp.int32)

    @property
    def eta(self):
        return self.rows[..., 5:8]

    @property
    def k(self):
        return self.rows[..., 8:11]


class TexRows(NamedTuple):
    rows: jnp.ndarray  # (B, 12)

    @property
    def ttype(self):
        return self.rows[..., 0].astype(jnp.int32)

    @property
    def c0(self):
        return self.rows[..., 1:4]

    @property
    def c1(self):
        return self.rows[..., 4:7]

    @property
    def scale(self):
        return self.rows[..., 7]

    @property
    def line(self):
        return self.rows[..., 8]

    @property
    def img_ofs(self):
        return self.rows[..., 9].astype(jnp.int32)

    @property
    def img_w(self):
        return self.rows[..., 10].astype(jnp.int32)

    @property
    def img_h(self):
        return self.rows[..., 11].astype(jnp.int32)


class LightRows(NamedTuple):
    rows: jnp.ndarray  # (B, 8)

    @property
    def ltype(self):
        return self.rows[..., 0].astype(jnp.int32)

    @property
    def pos(self):
        return self.rows[..., 1:4]

    @property
    def intensity(self):
        return self.rows[..., 4:7]

    @property
    def prim(self):
        return self.rows[..., 7].astype(jnp.int32)


def gather_prim(tables: PackedTables, idx) -> PrimRows:
    return PrimRows(_rows(tables.prim, idx))


def gather_mat(tables: PackedTables, idx) -> MatRows:
    return MatRows(_rows(tables.mat, idx))


def gather_tex(tables: PackedTables, idx) -> TexRows:
    return TexRows(_rows(tables.tex, idx))


def gather_light(tables: PackedTables, idx) -> LightRows:
    return LightRows(_rows(tables.light, idx))


def gather_prim_light(tables: PackedTables, idx) -> jnp.ndarray:
    """prim[idx].light without materializing full rows (hot in NEE
    visibility resolution, where only the light link is consulted)."""
    return _col(tables.prim, idx, 26).astype(jnp.int32)
