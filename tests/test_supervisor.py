"""Failure detection / elastic recovery (SURVEY §5).

The reference loses partial renders on any failure (src/main.cpp — bare
exceptions, no retry, no checkpoints). These tests drive the
replacement end-to-end through REAL subprocess failures: injected crashes
(exit 13 with un-checkpointed work lost), injected hangs (heartbeat-stall
kill), and elastic resume on a SMALLER device mesh — asserting the final
image is bit-identical to the same supervised job run with no failures
(the pass is the migration unit; see render/elastic.py). The baseline is
itself a supervised worker run: a differently-configured interpreter
(e.g. a site hook that pre-tunes jax) may round differently than this
process, so worker-to-worker is the apples-to-apples comparison — the
in-process elastic-vs-render equivalence is asserted separately below.
"""

import pathlib

import jax
import numpy as np
import pytest

from plutracer_tpu.render.elastic import render_elastic
from plutracer_tpu.render.progressive import save_state
from plutracer_tpu.render.renderer import render
from plutracer_tpu.render.supervisor import supervise_render
from plutracer_tpu.scene import compile_scene, load_scene_file

SCENE = str(pathlib.Path(__file__).resolve().parent.parent
            / "scenes" / "demo-box.urn")
W, H, N, SEED = 16, 12, 3, 7  # 9 passes; chunks land at 4/8/9


@pytest.fixture(scope="module")
def baseline_image(tmp_path_factory):
    """The no-failure supervised render every recovery test must match."""
    wd = tmp_path_factory.mktemp("baseline")
    r = supervise_render(
        SCENE, W, H, N, SEED, str(wd),
        checkpoint_every=4, device_counts=[8],
        heartbeat_timeout=600.0, poll=0.2,
    )
    assert r.restarts == 0
    return r.image


def test_elastic_render_is_mesh_invariant():
    """In-process: the same image, bit for bit, as the plain renderer on
    1/4/8-device spp meshes and at any checkpoint chunking."""
    d = load_scene_file(SCENE, ["/res", f"{W}x{H}"])
    s = compile_scene(d)
    ref = np.asarray(render(s, W, H, N, jax.random.PRNGKey(SEED)))
    for nd in (1, 4, 8):
        img = render_elastic(s, W, H, N, SEED, devices=jax.devices()[:nd])
        assert np.array_equal(np.asarray(img), ref), nd
    img = render_elastic(s, W, H, N, SEED, checkpoint_every=4)
    assert np.array_equal(np.asarray(img), ref)


def test_elastic_rejects_foreign_checkpoint(tmp_path):
    d = load_scene_file(SCENE, ["/res", f"{W}x{H}"])
    s = compile_scene(d)
    ck = str(tmp_path / "c.npz")
    save_state(ck, np.zeros((H * W, 3), np.float32), 4, seed=99)
    with pytest.raises(ValueError, match="seed"):
        render_elastic(s, W, H, N, SEED, checkpoint_path=ck)


def test_crash_recovery_bit_exact(tmp_path, baseline_image):
    """Worker crashes with pass 4..7 rendered but NOT checkpointed; the
    restart resumes from pass 4 and the result is bit-identical."""
    r = supervise_render(
        SCENE, W, H, N, SEED, str(tmp_path),
        checkpoint_every=4, inject_fault="crash:4",
        device_counts=[8], heartbeat_timeout=600.0, poll=0.2,
    )
    assert r.restarts == 1
    assert any("exit code 13" in d for e, d in r.events if e == "failure")
    assert np.array_equal(r.image, baseline_image)


def test_elastic_resume_on_smaller_mesh(tmp_path, baseline_image):
    """8-device launch crashes; the resume runs on a 4-device mesh (a
    'pod lost half its hosts' drill) — still bit-identical."""
    r = supervise_render(
        SCENE, W, H, N, SEED, str(tmp_path),
        checkpoint_every=4, inject_fault="crash:4",
        device_counts=[8, 4], heartbeat_timeout=600.0, poll=0.2,
    )
    assert r.restarts == 1
    assert np.array_equal(r.image, baseline_image)


def test_worker_rejects_foreign_job_checkpoint(tmp_path):
    """A checkpoint written by a different (scene, res, n, seed) job in
    the same workdir must abort the worker, not silently blend renders."""
    from plutracer_tpu.render.supervisor import _worker

    ck = tmp_path / "c.npz"
    save_state(str(ck), np.zeros((H * W, 3), np.float32), 4, SEED)
    (tmp_path / "c.npz.job").write_text("elsewhere.urn|8x6|n=1|seed=0")
    with pytest.raises(SystemExit, match="different job"):
        _worker([
            "--worker", "--scene", SCENE, "--res", f"{W}x{H}",
            "--n", str(N), "--seed", str(SEED), "--ckpt", str(ck),
            "--heartbeat", str(tmp_path / "hb"),
            "--out", str(tmp_path / "o.npz"),
        ])


def test_persistent_failure_exhausts_restarts(tmp_path):
    """A failure that survives restarts (here: an unloadable scene) must
    end in WorkerFailure after max_restarts, with every attempt logged."""
    from plutracer_tpu.render.supervisor import WorkerFailure

    with pytest.raises(WorkerFailure, match="failed 2 times"):
        supervise_render(
            str(tmp_path / "does-not-exist.urn"), W, H, N, SEED,
            str(tmp_path), max_restarts=1, device_counts=[2],
            heartbeat_timeout=300.0, poll=0.2,
        )


def test_cli_supervised_render(tmp_path, monkeypatch):
    """`/supervise` end-to-end: the driver renders via the supervised
    worker subprocess and still writes the watermarked BMP."""
    from plutracer_tpu.cli import main
    from plutracer_tpu.io.bmp import read_bmp

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.bmp"
    rc = main([
        SCENE, "/res", "16x12", "/smp", "2", "/supervise", "/o", str(out),
    ])
    assert rc == 0
    img = read_bmp(str(out))
    assert img.shape == (12, 16, 3)
    assert img.max() > 0


def test_hang_detection_and_restart(tmp_path, baseline_image):
    """Worker wedges (never heartbeats again); the supervisor must kill
    the process group on staleness and restart clean. The timeout bounds
    a single healthy chunk+compile, not worker startup (the worker beats
    at process start)."""
    r = supervise_render(
        SCENE, W, H, N, SEED, str(tmp_path),
        checkpoint_every=4, inject_fault="hang:0",
        # generous staleness bound: a healthy launch's chunk+compile can
        # exceed 90s under CI-grade CPU contention (observed)
        device_counts=[8], heartbeat_timeout=150.0, poll=0.2,
    )
    assert r.restarts == 1
    assert any("heartbeat stale" in d for e, d in r.events if e == "failure")
    assert np.array_equal(r.image, baseline_image)
