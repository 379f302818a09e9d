"""Smoke tests for the flagship tools so they can't rot.

This drives tools/inverse_flagship.py's code path end-to-end on CPU at
toy scale, so the tool is exercised outside its full-size runs.
"""

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def test_inverse_flagship_smoke(tmp_path):
    import inverse_flagship

    out = tmp_path / "inv.json"
    result = inverse_flagship.main([
        "--res", "32", "--steps", "5", "--n", "2", "--target-n", "4",
        "--loss", "log", "--out", str(out),
    ])
    assert out.exists()
    data = json.loads(out.read_text())
    assert data["config"]["steps"] == 5
    assert len(data["curve"]) >= 2
    # finite losses and errors — the NaN-divergence failure mode
    import math

    assert all(math.isfinite(r["loss"]) for r in data["curve"])
    assert math.isfinite(data["final"]["albedo_mae"])
    assert math.isfinite(data["final"]["emission_rel_err"])
    assert result["final"]["albedo_mae"] == data["final"]["albedo_mae"]
