"""bench.py: a CPU smoke run prints one line that names its device and
is marked as a smoke run; without a GPU (and without --cpu) it fails."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*extra):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "bench.py", *extra], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_bench_cpu_smoke_line():
    r = _run("--cpu", "--width", "64", "--height", "48", "--iters", "2",
             "--frames", "2", "--no-parity", "--rig", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [l for l in r.stdout.splitlines() if l.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "fused_ms_per_frame_dual_64x48_cpu_smoke"
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] >= 1
    assert set(out["ms"]) == {"tiled_image_only", "tiled_zbuf", "indexed",
                              "packed", "rig_2cam"}
    assert out["value"] == out["ms"]["tiled_image_only"] > 0
    assert out["registration_ms_warm"] > 0
    assert out["parity"] == "skipped"


def test_bench_fails_without_gpu():
    r = _run("--iters", "2", "--no-parity", "--no-registration")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""
