"""chip_smoke.py on CPU: it refuses to run, and its phases work at tiny
sizes when called directly (interpret mode for the kernel)."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_phase_kernels_tiny():
    res = chip_smoke.phase_kernels(
        cases=(("demo-box.urn", 130), ("mesh0.urn", 70)), reps=1, interpret=True
    )
    for row in res.values():
        assert row["ok"] and row["found_mismatch"] == 0
        assert row["xla_ms"] > 0 and row["kernel_ms"] > 0


def test_compare_hits_bounds():
    f = np.array([True, True, True, False])
    ref = (f, np.array([1, 2, 3, 0]), np.array([1.0, 2.0, 3.0, 1e5]))
    ok = chip_smoke.compare_hits(ref, (f, np.array([1, 5, 3, 0]),
                                       np.array([1.0, 2.0, 3.0, 1e5])))
    assert ok["ok"] and ok["knife_edge_lanes"] == 1
    bad = chip_smoke.compare_hits(ref, (f, np.array([1, 5, 3, 0]),
                                        np.array([1.0, 2.1, 3.0, 1e5])))
    assert not bad["ok"] and bad["knife_edge_beyond_tol"] == 1
    flip = chip_smoke.compare_hits(ref, (~f, *ref[1:]))
    assert not flip["ok"] and flip["found_mismatch"] == 4


def test_phase_main_render_tiny(tmp_path):
    res = chip_smoke.phase_main_render(tmp_path, res=16, small=8)
    assert res["spp"] == 4 and res["mean"] > 0
    assert res["auto_vs_xla"]["ok"] and res["auto_vs_pallas"]["ok"]
    assert res["render_passes_dots"]["dot_general"] == res["render_passes_dots"]["highest"]


def test_phase_big_p_tiny():
    res = chip_smoke.phase_big_p(w=8, n=1, small=8)
    assert res["P"] == 20483 and res["auto_vs_xla_small"]["ok"]


def test_phase_train_tiny():
    res = chip_smoke.phase_train(w=16, n=1, steps=2)
    assert len(res["losses"]) == 2 and res["nf_max"] == 0.0


def test_phase_four_tiny(eight_devices):
    res = chip_smoke.phase_four(w=16, n=1, seeds=5)
    assert res["elastic4_vs_elastic1_bit_equal"]
    assert res["train_grad"]["ok"] and res["sharded_mean"]["ok"]


def test_phase_supervised_tiny(tmp_path):
    """In a fresh process: the supervising side must not open a device."""
    code = (
        "import pathlib, sys; sys.path.insert(0, %r); import chip_smoke; "
        "r = chip_smoke.phase_supervised(pathlib.Path(%r), w=16, h=12, smp=2); "
        "print('RESTARTS', r['restarts'])" % (str(REPO), str(tmp_path))
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PLUTRACER_NO_CACHE="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RESTARTS 1" in r.stdout


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lands
    in the fixed directory inside the checkout."""
    import jax

    import plutracer_tpu

    monkeypatch.delenv("PLUTRACER_NO_CACHE")
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(plutracer_tpu, "CACHE_DIR", str(tmp_path / "in-checkout"))
    before = jax.config.jax_compilation_cache_dir
    try:
        plutracer_tpu.enable_compilation_cache()
        want = tmp_path / ("c" if env_dir else "in-checkout")
        assert jax.config.jax_compilation_cache_dir == str(want)
        assert want.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_cache_dir_is_in_checkout_and_ignored():
    import plutracer_tpu

    d = pathlib.Path(plutracer_tpu.CACHE_DIR)
    assert d.parent == REPO
    assert f"{d.name}/" in (REPO / ".gitignore").read_text().split()
