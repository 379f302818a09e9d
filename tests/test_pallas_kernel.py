"""Closest-hit kernel vs the XLA brute-force oracle (interpret mode on CPU;
the `gpu`-marked test compiles it for the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plutracer_tpu.ops import intersect
from plutracer_tpu.ops.pallas import intersect_kernel as K
from plutracer_tpu.ops.pallas.intersect_kernel import (
    intersect_lite_pallas,
    pack_prims_np,
)
from plutracer_tpu.scene import compile_scene, load_scene_file
from plutracer_tpu.semantics import DEFAULT_OPTIONS


def random_rays(key, n, spread=6.0):
    k1, k2 = jax.random.split(key)
    o = jax.random.uniform(k1, (n, 3), minval=-spread, maxval=spread)
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def scene_of(scenes_dir, name):
    return compile_scene(load_scene_file(str(scenes_dir / f"{name}.urn"), ["/res", "8x8"]))


def assert_same_hits(scene, o, d):
    f_x, p_x, t_x = (np.asarray(x) for x in intersect.intersect_lite(scene, o, d))
    f_p, p_p, t_p = (np.asarray(x) for x in intersect_lite_pallas(
        o, d, scene.prims_packed, interpret=True))
    np.testing.assert_array_equal(f_x, f_p)
    np.testing.assert_array_equal(p_x[f_x], p_p[f_x])
    np.testing.assert_allclose(t_x[f_x], t_p[f_x], rtol=1e-5)
    return f_x


@pytest.mark.parametrize(
    "name", ["demo-box", "sphere-grid", "mesh0", "textured0", "dof"]
)
def test_pallas_matches_xla(name, scenes_dir):
    s = scene_of(scenes_dir, name)
    o, dd = random_rays(jax.random.PRNGKey(1), 512)
    assert assert_same_hits(s, o, dd).any()


@pytest.mark.parametrize("n_rays", [1, 63, 100, 129])
def test_pallas_ray_padding(n_rays, scenes_dir):
    """Batches that are not a multiple of the ray block are padded and
    sliced back."""
    s = scene_of(scenes_dir, "demo-box")
    o, dd = random_rays(jax.random.PRNGKey(2), n_rays)
    f, p, t = intersect_lite_pallas(o, dd, s.prims_packed, interpret=True)
    assert f.shape == p.shape == t.shape == (n_rays,)
    assert_same_hits(s, o, dd)


def test_pack_prims_per_type_tables(scenes_dir):
    """One column-major table per type, padded to a CHUNK multiple, whose
    last row carries every original scene row exactly once; absent types
    are None."""
    s = scene_of(scenes_dir, "demo-box")  # spheres and boxes, no triangles
    tabs = pack_prims_np(s)
    assert tabs.tri is None
    assert tabs.sph.shape[0] == 11 and tabs.box.shape[0] == 7
    ptype = np.asarray(s.prim_type)
    ids = []
    for t, tab in ((0, tabs.sph), (1, tabs.box)):
        assert tab.shape[1] % K.CHUNK == 0
        n = int((ptype == t).sum())
        ids += list(tab[-1, :n].astype(int))
        assert (ptype[tab[-1, :n].astype(int)] == t).all()
    assert sorted(ids) == list(range(ptype.shape[0]))
    # triangle tables store v0 and the two edges
    m = scene_of(scenes_dir, "mesh0")
    tri = pack_prims_np(m).tri
    rows = tri[-1].astype(int)[: int((np.asarray(m.prim_type) == 2).sum())]
    np.testing.assert_array_equal(tri[0:3, : rows.size].T, np.asarray(m.prim_a)[rows])
    np.testing.assert_array_equal(
        tri[3:6, : rows.size].T, np.asarray(m.prim_b)[rows] - np.asarray(m.prim_a)[rows]
    )


def test_pallas_prim_padding(scenes_dir):
    """Primitive counts that are not a multiple of CHUNK: the padding
    entries never win, also for rays that hit nothing."""
    s = scene_of(scenes_dir, "textured0")  # 1 sphere, 3 boxes
    tabs = s.prims_packed
    assert tabs.sph.shape[1] == K.CHUNK and tabs.box.shape[1] == K.CHUNK
    o, dd = random_rays(jax.random.PRNGKey(3), 256, spread=40.0)
    f = assert_same_hits(s, o, dd)
    assert (~f).any()  # some rays miss everything
    _, p, _ = intersect_lite_pallas(o, dd, tabs, interpret=True)
    assert (np.asarray(p) < s.prim_type.shape[0]).all()


def test_pallas_ties_go_to_lowest_row(scenes_dir):
    """Two identical spheres: argmin reports the lower row, and so must
    the kernel, whatever the table order."""
    import dataclasses

    s = scene_of(scenes_dir, "dof")
    ptype = np.asarray(s.prim_type)
    [j] = np.nonzero(ptype == 0)[0][:1]
    dup = dataclasses.replace(
        s,
        prim_type=np.concatenate([ptype, ptype[j:j + 1]]),
        prim_a=np.concatenate([np.asarray(s.prim_a), np.asarray(s.prim_a)[j:j + 1]]),
        prim_b=np.concatenate([np.asarray(s.prim_b), np.asarray(s.prim_b)[j:j + 1]]),
        prim_c=np.concatenate([np.asarray(s.prim_c), np.asarray(s.prim_c)[j:j + 1]]),
        cull_rows=None,
        parent_min=None,
    )
    dup = dataclasses.replace(dup, prims_packed=pack_prims_np(dup))
    c = np.asarray(s.prim_a)[j]
    o = jnp.asarray(c + np.array([0.0, 0.0, -30.0]))[None].repeat(4, 0)
    d = jnp.asarray(np.array([[0.0, 0.0, 1.0]] * 4, np.float32))
    f, p, _ = intersect_lite_pallas(o, d, dup.prims_packed, interpret=True)
    assert np.asarray(f).all()
    assert (np.asarray(p) == j).all()
    assert_same_hits(dup, o, d)


@pytest.mark.parametrize(
    "platform,expect", [("cpu", "xla"), ("gpu", "pallas")]
)
def test_auto_backend_by_platform(platform, expect, monkeypatch, scenes_dir):
    """auto picks the kernel on a GPU whatever the scene size (it wins from
    9 to 102,403 primitives) and XLA brute force elsewhere; a forced
    backend is kept; shard_map's vma check is off exactly when the kernel
    is in the program."""
    from plutracer_tpu.parallel.sharded import check_vma

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert intersect._resolve_backend(DEFAULT_OPTIONS) == expect
    assert check_vma(DEFAULT_OPTIONS) == (expect == "xla")
    forced = DEFAULT_OPTIONS.replace(intersect_backend="bvh")
    assert intersect._resolve_backend(forced) == "bvh"


def test_render_through_kernel_matches_xla(scenes_dir):
    """A whole render through the kernel (interpret mode) agrees with the
    XLA path: same winners, so the same image up to knife-edge lanes."""
    from plutracer_tpu.render.renderer import render

    s = compile_scene(load_scene_file(str(scenes_dir / "mesh0.urn"), ["/res", "8x8"]))
    key = jax.random.PRNGKey(4)
    kern = DEFAULT_OPTIONS.replace(intersect_backend="pallas", pallas_interpret=True,
                                   max_bounces=3)
    a = np.asarray(render(s, 8, 8, 1, key, options=kern))
    b = np.asarray(render(s, 8, 8, 1, key, options=kern.replace(intersect_backend="xla")))
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu_device, scenes_dir):
    """The kernel as compiled for the card, against intersect_lite."""
    with jax.default_device(gpu_device):
        s = scene_of(scenes_dir, "mesh0")
        o, dd = random_rays(jax.random.PRNGKey(5), 4096)
        f_x, p_x, t_x = (np.asarray(x) for x in intersect.intersect_lite(s, o, dd))
        f_p, p_p, t_p = (np.asarray(x) for x in intersect_lite_pallas(
            o, dd, s.prims_packed))
    np.testing.assert_array_equal(f_x, f_p)
    same = f_x & (p_x == p_p)
    np.testing.assert_allclose(t_x[same], t_p[same], rtol=1e-5)
    knife = f_x & (p_x != p_p)
    np.testing.assert_allclose(t_x[knife], t_p[knife], rtol=1e-5)
