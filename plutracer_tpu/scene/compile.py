"""Scene compiler: SceneDesc -> SceneArrays (device-ready SoA pytree).

Also builds the camera basis exactly as the reference does
(inc/camera.h:17-23): look = norm(target-pos), right = 1.5*norm(cross(look,
(0,-1,0))), up = 1.5*norm(cross(look, right)), film distance w = 2.5.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from plutracer_tpu.scene.loader import box_area, sphere_area, triangle_area
from plutracer_tpu.scene.types import (
    PRIM_BOX,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_IMAGE,
    CameraParams,
    SceneArrays,
    SceneDesc,
)
from plutracer_tpu.semantics import DEFAULT_OPTIONS, RenderOptions


def build_camera(
    pos: np.ndarray,
    target: np.ndarray,
    resolution: Tuple[int, int],
    lens_radius: float = 0.0,
    focal_distance: float = 0.0,
    w: float = 2.5,
) -> CameraParams:
    look = target - pos
    nl = np.linalg.norm(look)
    look = look / nl if nl > 0 else np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(look, np.array([0.0, -1.0, 0.0], np.float32))
    nr = np.linalg.norm(right)
    right = 1.5 * right / nr if nr > 0 else np.array([1.5, 0.0, 0.0], np.float32)
    up = np.cross(look, right)
    up = 1.5 * up / np.linalg.norm(up)
    return CameraParams(
        pos=np.asarray(pos, np.float32),
        look=np.asarray(look, np.float32),
        right=np.asarray(right, np.float32),
        up=np.asarray(up, np.float32),
        inv_image_size=np.asarray(
            [1.0 / resolution[0], 1.0 / resolution[1]], np.float32
        ),
        w=np.float32(w),
        lens_radius=np.float32(lens_radius),
        focal_distance=np.float32(focal_distance),
    )


def _prim_area(p, options: RenderOptions) -> float:
    if p.ptype == PRIM_SPHERE:
        return sphere_area(float(p.b[0]), options.sphere_area_is_volume)
    if p.ptype == PRIM_BOX:
        return box_area(p.b - p.a)
    return triangle_area(p.a, p.b, p.c)


def compile_scene(
    desc: SceneDesc,
    options: RenderOptions = DEFAULT_OPTIONS,
    build_accel: bool = True,
) -> SceneArrays:
    P = max(len(desc.prims), 1)
    M = max(len(desc.materials), 1)
    T = max(len(desc.textures), 1)
    L = max(len(desc.lights), 1)

    f3 = lambda n: np.zeros((n, 3), np.float32)
    f2 = lambda n: np.zeros((n, 2), np.float32)
    i1 = lambda n, fill=0: np.full((n,), fill, np.int32)
    f1 = lambda n: np.zeros((n,), np.float32)

    prim_type = i1(P)
    prim_a, prim_b, prim_c = f3(P), f3(P), f3(P)
    prim_n0, prim_n1, prim_n2 = f3(P), f3(P), f3(P)
    prim_uv0, prim_uv1, prim_uv2 = f2(P), f2(P), f2(P)
    prim_material = i1(P, -1)
    prim_area = f1(P)
    prim_light = i1(P, -1)
    for j, p in enumerate(desc.prims):
        prim_type[j] = p.ptype
        prim_a[j], prim_b[j], prim_c[j] = p.a, p.b, p.c
        prim_n0[j], prim_n1[j], prim_n2[j] = p.n0, p.n1, p.n2
        prim_uv0[j], prim_uv1[j], prim_uv2[j] = p.uv0, p.uv1, p.uv2
        prim_material[j] = p.material
        prim_area[j] = _prim_area(p, options)
        prim_light[j] = p.light

    mat_type = i1(M)
    mat_color, mat_eta, mat_k = f3(M), f3(M), f3(M)
    mat_tex = i1(M, -1)
    for j, m in enumerate(desc.materials):
        mat_type[j] = m.mtype
        mat_color[j] = m.color
        mat_tex[j] = m.tex
        mat_eta[j] = m.eta
        mat_k[j] = m.k

    tex_type = i1(T)
    tex_c0, tex_c1 = f3(T), f3(T)
    tex_scale, tex_line = f1(T), f1(T)
    tex_img_ofs, tex_img_w, tex_img_h = i1(T), i1(T), i1(T)
    atlas_parts = []
    ofs = 0
    for j, t in enumerate(desc.textures):
        tex_type[j] = t.ttype
        tex_c0[j], tex_c1[j] = t.c0, t.c1
        tex_scale[j], tex_line[j] = t.scale, t.line
        if t.ttype == TEX_IMAGE and t.image is not None:
            h, w = t.image.shape[:2]
            tex_img_ofs[j] = ofs
            tex_img_w[j] = w
            tex_img_h[j] = h
            atlas_parts.append(t.image.reshape(-1, 3).astype(np.float32))
            ofs += h * w
    atlas = (
        np.concatenate(atlas_parts, 0) if atlas_parts else np.zeros((1, 3), np.float32)
    )

    light_type = i1(L)
    light_pos, light_intensity = f3(L), f3(L)
    light_prim = i1(L, -1)
    for j, l in enumerate(desc.lights):
        light_type[j] = l.ltype
        light_pos[j] = l.pos
        light_intensity[j] = l.intensity
        light_prim[j] = l.prim

    cam = build_camera(
        desc.cam_pos,
        desc.cam_target,
        desc.resolution,
        desc.lens_radius,
        desc.focal_distance,
    )

    # assemble the whole scene in host numpy; ONE device_put at the end
    # (per-leaf jnp.asarray / eager .at[].set ops each cost a dispatch)
    dev = lambda x: x
    scene = SceneArrays(
        prim_type=dev(prim_type),
        prim_a=dev(prim_a),
        prim_b=dev(prim_b),
        prim_c=dev(prim_c),
        prim_n0=dev(prim_n0),
        prim_n1=dev(prim_n1),
        prim_n2=dev(prim_n2),
        prim_uv0=dev(prim_uv0),
        prim_uv1=dev(prim_uv1),
        prim_uv2=dev(prim_uv2),
        prim_material=dev(prim_material),
        prim_area=dev(prim_area),
        prim_light=dev(prim_light),
        mat_type=dev(mat_type),
        mat_color=dev(mat_color),
        mat_tex=dev(mat_tex),
        mat_eta=dev(mat_eta),
        mat_k=dev(mat_k),
        tex_type=dev(tex_type),
        tex_c0=dev(tex_c0),
        tex_c1=dev(tex_c1),
        tex_scale=dev(tex_scale),
        tex_line=dev(tex_line),
        tex_img_ofs=dev(tex_img_ofs),
        tex_img_w=dev(tex_img_w),
        tex_img_h=dev(tex_img_h),
        atlas=dev(atlas),
        light_type=dev(light_type),
        light_pos=dev(light_pos),
        light_intensity=dev(light_intensity),
        light_prim=dev(light_prim),
        camera=cam,
    )
    if build_accel:
        import dataclasses as _dc

        from plutracer_tpu.ops.bvh import build_bvh, parent_bounds_tables
        from plutracer_tpu.ops.pallas.intersect_kernel import pack_prims_np

        bvh = build_bvh(scene)
        # reference bvh_tree internal-node culling (phantom-hit parity for
        # non-unit rays — see ops.bvh.parent_bounds_tables). Only sphere
        # rows can change under the cull, so the static row list is
        # filtered to them here, where prim types are host numpy.
        parent_min, parent_max = parent_bounds_tables(bvh, P)
        cull_rows = tuple(
            int(j)
            for j in np.nonzero(prim_type == PRIM_SPHERE)[0]
            if parent_max[j, 0] < 3.0e38
        )
        scene = _dc.replace(
            scene,
            bvh=bvh,
            parent_min=parent_min,
            parent_max=parent_max,
            cull_rows=cull_rows or None,
        )
        scene = _dc.replace(scene, prims_packed=pack_prims_np(scene))
    _assert_finite(scene)
    import jax

    return jax.device_put(scene)


def _assert_finite(scene) -> None:
    """Reject non-finite scene data at load time. The packed-table one-hot
    gather tier (ops/tables._rows) relies on all-finite tables (0 * inf
    would poison whole batches, not single lanes)."""
    import dataclasses as _dc
    import jax

    for leaf in jax.tree_util.tree_leaves(scene):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise ValueError(
                "scene contains non-finite values (NaN/Inf); refusing to "
                "compile — check material/texture/light parameters"
            )
