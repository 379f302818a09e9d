"""Scene data types.

Two layers:

- ``SceneDesc``: host-side Python lists built by the loader (mirrors the
  object graph the reference builds in inc/scene.h).
- ``SceneArrays``: the compiled, device-ready structure-of-arrays pytree.
  Every cross-reference (surface->material, material->texture,
  surface<->area-light) is an int32 index column. All float leaves are
  differentiable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import jax
import numpy as np

# primitive type enum (prim_type column)
PRIM_SPHERE = 0
PRIM_BOX = 1
PRIM_TRIANGLE = 2

# material type enum (mat_type column); mirrors the reference material set
# (inc/material.h:213-254, inc/lights/area_light.h:46-55)
MAT_DIFFUSE = 0
MAT_MIRROR = 1  # perfect-reflection (conductor fresnel)
MAT_REFRACT = 2  # perfect-refraction (specular transmission only)
MAT_GLASS = 3  # dielectric reflection + transmission pair
MAT_EMISSION = 4  # empty bsdf; emission via the linked area light

# texture type enum (tex_type column / mat_tex = TEX_NONE means constant)
TEX_NONE = -1
TEX_CHECKERBOARD = 0
TEX_GRID = 1
TEX_IMAGE = 2

# light type enum
LIGHT_POINT = 0
LIGHT_AREA = 1


def _register(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda obj: (tuple(getattr(obj, f) for f in fields), None),
        lambda _, children: cls(**dict(zip(fields, children))),
    )
    return cls


@_register
@dataclasses.dataclass
class CameraParams:
    """Reference camera model (inc/camera.h:6-38): hand-built basis with
    right/up scaled by 1.5, film plane at distance w=2.5, optional thin lens.
    """

    pos: Any  # (3,)
    look: Any  # (3,)
    right: Any  # (3,) already scaled by 1.5
    up: Any  # (3,) already scaled by 1.5
    inv_image_size: Any  # (2,)
    w: Any  # scalar
    lens_radius: Any  # scalar
    focal_distance: Any  # scalar


@dataclasses.dataclass
class SceneArrays:
    """Device-ready scene. Shapes: P primitives, M materials, T textures,
    L lights, A atlas pixels."""

    # primitives
    prim_type: Any  # (P,) i32
    prim_a: Any  # (P,3) sphere center | box min | tri v0
    prim_b: Any  # (P,3) sphere (radius,0,0) | box max | tri v1
    prim_c: Any  # (P,3) tri v2
    prim_n0: Any  # (P,3) tri vertex normals (used by surface::sample parity)
    prim_n1: Any
    prim_n2: Any
    prim_uv0: Any  # (P,2) tri texcoords
    prim_uv1: Any
    prim_uv2: Any
    prim_material: Any  # (P,) i32 -> material row
    prim_area: Any  # (P,) f32, with reference quirks baked (sphere=volume)
    prim_light: Any  # (P,) i32 -> light row, or -1

    # materials
    mat_type: Any  # (M,) i32
    mat_color: Any  # (M,3) constant color
    mat_tex: Any  # (M,) i32 -> texture row, or TEX_NONE
    mat_eta: Any  # (M,3) conductor eta | (eta_t, eta_i, 0) | (ior, 0, 0)
    mat_k: Any  # (M,3) conductor k

    # textures
    tex_type: Any  # (T,) i32
    tex_c0: Any  # (T,3) checkerboard colors[0] | grid fg
    tex_c1: Any  # (T,3) checkerboard colors[1] | grid bg
    tex_scale: Any  # (T,)
    tex_line: Any  # (T,) grid line_size
    tex_img_ofs: Any  # (T,) i32 offset into atlas (or 0)
    tex_img_w: Any  # (T,) i32
    tex_img_h: Any  # (T,) i32
    atlas: Any  # (A,3) f32 flattened image pixels (A>=1)

    # lights
    light_type: Any  # (L,) i32
    light_pos: Any  # (L,3) point-light position
    light_intensity: Any  # (L,3) point intensity | area Lemit
    light_prim: Any  # (L,) i32 -> primitive row for area lights, or -1

    camera: CameraParams

    # acceleration structures (derived; None until built by compile_scene)
    bvh: Any = None  # ops.bvh.BvhArrays
    # per-type tables for the closest-hit kernel
    # (ops.pallas.intersect_kernel.PrimTables)
    prims_packed: Any = None

    # phantom-hit culling (ops.bvh.parent_bounds_tables; reference bvh_tree
    # internal-node semantics, collapsed to the leaf's parent AABB by
    # nesting). parent_min/parent_max are dynamic (P,3) bounds; cull_rows
    # is STATIC aux data (tuple of sphere row indices needing the test) —
    # hashable, keys jit/pallas program caches.
    parent_min: Any = None
    parent_max: Any = None
    cull_rows: Any = None  # static: tuple[int, ...] | None

    @property
    def num_prims(self) -> int:
        return self.prim_type.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_type.shape[0]


_SCENE_CHILD_FIELDS = tuple(
    f.name for f in dataclasses.fields(SceneArrays) if f.name != "cull_rows"
)
jax.tree_util.register_pytree_node(
    SceneArrays,
    lambda s: (
        tuple(getattr(s, f) for f in _SCENE_CHILD_FIELDS),
        s.cull_rows,
    ),
    lambda aux, ch: SceneArrays(
        **dict(zip(_SCENE_CHILD_FIELDS, ch)), cull_rows=aux
    ),
)


# ---------------- host-side description ----------------


@dataclasses.dataclass
class PrimDesc:
    ptype: int
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    n0: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    n1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    n2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    uv0: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))
    uv1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))
    uv2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))
    material: int = -1
    light: int = -1


@dataclasses.dataclass
class MaterialDesc:
    mtype: int
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    tex: int = TEX_NONE
    eta: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    k: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))


@dataclasses.dataclass
class TextureDesc:
    ttype: int
    c0: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    c1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 1.0
    line: float = 0.0
    image: Optional[np.ndarray] = None  # (H,W,3) f32


@dataclasses.dataclass
class LightDesc:
    ltype: int
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    intensity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    prim: int = -1


@dataclasses.dataclass
class SceneDesc:
    """Host-side scene: what the urn loader produces."""

    resolution: Tuple[int, int] = (1280, 960)
    samples: int = 8  # antialiasing-samples N; spp = N*N (src/main.cpp:170)
    cam_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    cam_target: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    lens_radius: float = 0.0
    focal_distance: float = 0.0
    prims: List[PrimDesc] = dataclasses.field(default_factory=list)
    materials: List[MaterialDesc] = dataclasses.field(default_factory=list)
    textures: List[TextureDesc] = dataclasses.field(default_factory=list)
    lights: List[LightDesc] = dataclasses.field(default_factory=list)

    def add_material(self, m: MaterialDesc) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_texture(self, t: TextureDesc) -> int:
        self.textures.append(t)
        return len(self.textures) - 1

    def add_prim(self, p: PrimDesc) -> int:
        self.prims.append(p)
        return len(self.prims) - 1

    def add_light(self, l: LightDesc) -> int:
        self.lights.append(l)
        return len(self.lights) - 1
