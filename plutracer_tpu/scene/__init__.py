"""Scene front-end: urn scene files -> structure-of-arrays scene pytrees.

The reference builds a pointer graph of shared_ptr<surface>/material/light
objects (inc/scene.h:64-299). Here we compile the same scene format
into flat arrays: a unified primitive table (sphere/box/triangle rows), a
material table, a texture table (+ image atlas), and a light table, with all
cross-references as integer index columns.
"""

from plutracer_tpu.scene.types import (
    CameraParams,
    SceneArrays,
    SceneDesc,
    PRIM_SPHERE,
    PRIM_BOX,
    PRIM_TRIANGLE,
    MAT_DIFFUSE,
    MAT_MIRROR,
    MAT_REFRACT,
    MAT_GLASS,
    MAT_EMISSION,
    TEX_NONE,
    TEX_CHECKERBOARD,
    TEX_GRID,
    TEX_IMAGE,
    LIGHT_POINT,
    LIGHT_AREA,
)
from plutracer_tpu.scene.loader import load_scene, load_scene_file
from plutracer_tpu.scene.compile import compile_scene

__all__ = [
    "CameraParams",
    "SceneArrays",
    "SceneDesc",
    "load_scene",
    "load_scene_file",
    "compile_scene",
    "PRIM_SPHERE",
    "PRIM_BOX",
    "PRIM_TRIANGLE",
    "MAT_DIFFUSE",
    "MAT_MIRROR",
    "MAT_REFRACT",
    "MAT_GLASS",
    "MAT_EMISSION",
    "TEX_NONE",
    "TEX_CHECKERBOARD",
    "TEX_GRID",
    "TEX_IMAGE",
    "LIGHT_POINT",
    "LIGHT_AREA",
]
