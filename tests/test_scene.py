"""Scene loader + compiler tests against the reference scene corpus."""

import math
import pathlib

import numpy as np
import pytest

from plutracer_tpu.scene import (
    LIGHT_AREA,
    LIGHT_POINT,
    MAT_DIFFUSE,
    MAT_EMISSION,
    MAT_GLASS,
    MAT_MIRROR,
    MAT_REFRACT,
    PRIM_BOX,
    PRIM_SPHERE,
    TEX_CHECKERBOARD,
    TEX_GRID,
    compile_scene,
    load_scene_file,
)

SCENES = pathlib.Path("/root/reference/scenes")


def test_cornell_box_structure():
    d = load_scene_file(str(SCENES / "cornell-box.urn"))
    assert d.resolution == (512, 512)
    assert d.samples == 8
    np.testing.assert_allclose(d.cam_pos, [0, 1, -8])
    np.testing.assert_allclose(d.cam_target, [0, 1, 0])
    # 1 light carrier box + 5 wall boxes + 2 spheres
    assert len(d.prims) == 8
    assert len(d.lights) == 1
    assert d.lights[0].ltype == LIGHT_AREA
    np.testing.assert_allclose(d.lights[0].intensity, [500, 500, 490])
    # the area light's carrier box gets the emission material and back-link
    pid = d.lights[0].prim
    assert d.prims[pid].ptype == PRIM_BOX
    assert d.materials[d.prims[pid].material].mtype == MAT_EMISSION
    assert d.prims[pid].light == 0
    # named material reused across walls
    wall_mats = {d.prims[i].material for i in (1, 2, 3)}
    assert len(wall_mats) == 1
    types = [d.materials[p.material].mtype for p in d.prims]
    assert MAT_MIRROR in types and MAT_GLASS in types


def test_cli_overrides():
    d = load_scene_file(str(SCENES / "cornell-box.urn"), ["/res", "128x96", "/smp", "4"])
    assert d.resolution == (128, 96)
    assert d.samples == 4


def test_lens_parsing():
    d = load_scene_file(str(SCENES / "test.urn"))
    assert d.lens_radius == pytest.approx(0.05)
    assert d.focal_distance == pytest.approx(5.0)


def test_textures_glass0():
    d = load_scene_file(str(SCENES / "glass0.urn"))
    assert len(d.textures) == 1
    t = d.textures[0]
    assert t.ttype == TEX_CHECKERBOARD
    assert t.scale == 4
    np.testing.assert_allclose(t.c0, [0, 0, 0])
    np.testing.assert_allclose(t.c1, [1, 1, 1])
    assert d.lights[0].ltype == LIGHT_POINT


def test_refrac0_materials():
    d = load_scene_file(str(SCENES / "refrac0.urn"))
    types = [m.mtype for m in d.materials]
    assert MAT_MIRROR in types and MAT_REFRACT in types and MAT_DIFFUSE in types
    grid = [t for t in d.textures if t.ttype == TEX_GRID]
    assert len(grid) == 1
    assert grid[0].scale == 8 and grid[0].line == pytest.approx(0.1)
    refr = [m for m in d.materials if m.mtype == MAT_REFRACT][0]
    assert refr.eta[0] == pytest.approx(1.0)  # eta_t
    assert refr.eta[1] == pytest.approx(1.5)  # eta_i


def test_test1_programmatic_grid():
    d = load_scene_file(str(SCENES / "test1.urn"))
    spheres = [p for p in d.prims if p.ptype == PRIM_SPHERE]
    assert len(spheres) == 256
    # all spheres share the named 'red material (single instance)
    mats = {p.material for p in spheres}
    assert len(mats) == 1
    assert d.materials[spheres[0].material].mtype == MAT_DIFFUSE
    xs = sorted({float(p.a[0]) for p in spheres})
    assert xs == [float(x) for x in range(-8, 8)]


@pytest.mark.parametrize("name", [p.stem for p in sorted(SCENES.glob("*.urn"))])
def test_all_scenes_compile(name):
    d = load_scene_file(str(SCENES / f"{name}.urn"))
    s = compile_scene(d)
    assert s.prim_type.shape[0] == max(len(d.prims), 1)
    assert s.light_type.shape[0] == max(len(d.lights), 1)
    assert np.all(np.asarray(s.prim_material) >= 0)
    # every area light points at a prim that points back
    lt = np.asarray(s.light_type)
    lp = np.asarray(s.light_prim)
    for li in range(len(d.lights)):
        if lt[li] == LIGHT_AREA:
            assert np.asarray(s.prim_light)[lp[li]] == li


def test_areas_reference_quirks():
    d = load_scene_file(str(SCENES / "cornell-box.urn"))
    s = compile_scene(d)
    areas = np.asarray(s.prim_area)
    types = np.asarray(s.prim_type)
    # sphere "area" is the reference's volume formula (4/3) pi r^3
    r = 1.5
    sphere_rows = np.nonzero(types == PRIM_SPHERE)[0]
    np.testing.assert_allclose(
        areas[sphere_rows], (4 / 3) * math.pi * r**3, rtol=1e-6
    )
    # light carrier box [0 3 0] extent [1 0.1 1]: full dims (2, 0.2, 2)
    np.testing.assert_allclose(areas[0], 2 * (2 * 0.2 + 2 * 2 + 0.2 * 2), rtol=1e-6)


def test_camera_basis():
    d = load_scene_file(str(SCENES / "cornell-box.urn"))
    s = compile_scene(d)
    cam = s.camera
    np.testing.assert_allclose(np.asarray(cam.look), [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(cam.right)), 1.5, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(cam.up)), 1.5, rtol=1e-6)
    # right = 1.5*norm(cross(look, (0,-1,0))): cross((0,0,1),(0,-1,0)) = (1,0,0)
    np.testing.assert_allclose(np.asarray(cam.right), [1.5, 0, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(cam.up), [0, 1.5, 0], atol=1e-6)
    assert float(cam.w) == 2.5


def test_bmp_roundtrip(tmp_path):
    from plutracer_tpu.io.bmp import read_bmp, write_bmp

    rng = np.random.default_rng(0)
    img = rng.random((13, 17, 3)).astype(np.float32)
    p = tmp_path / "t.bmp"
    write_bmp(str(p), img)
    back = read_bmp(str(p))
    assert back.shape == img.shape
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-6)


def test_draw_text():
    from plutracer_tpu.io.font import draw_text

    img = np.zeros((30, 100, 3), np.float32)
    draw_text(img, "HELLO: 123", (2, 2), (1.0, 0.6, 0.0))
    assert img.sum() > 0
    # drawing off the edge must not wrap or crash
    draw_text(img, "XXXXXXXXXXXXXXXXXXXXXXXX", (80, 25), (1, 1, 1))


def test_mesh1_beyond_old_stream_ceiling():
    """scenes/mesh1.urn (20,483 primitives: 20,480-tri asteroid + floor +
    mirror sphere + area light) must load, pack one closest-hit kernel
    table per primitive type, and render finitely."""
    import jax
    import numpy as np

    from plutracer_tpu.render.renderer import render
    from plutracer_tpu.scene import compile_scene, load_scene_file

    s = compile_scene(load_scene_file("scenes/mesh1.urn", ["/res", "16x16"]))
    P = s.prim_type.shape[0]
    assert P > 16384, P
    assert s.prims_packed.tri.shape[1] >= 20480
    img = np.asarray(render(s, 16, 16, 1, jax.random.PRNGKey(0)))
    assert np.isfinite(img).all()
    assert img.max() > 0.0
