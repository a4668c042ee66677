"""tools/kernel_timing.py: the CPU rehearsal runs every case and checks
the alignment candidates bit for bit; a full-size run refuses the CPU."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*extra):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "tools/kernel_timing.py", *extra], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300,
    )


def test_kernel_timing_small_rehearsal():
    r = _run("--small", "--iters", "2", "--frames", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
    cases = {(row["case"], row["impl"]) for row in rows}
    assert {("dual", "plain"), ("dual_image_only", "plain"),
            ("rig3", "plain"), ("dual_aligned", "scatter"),
            ("dual_aligned", "binned")} <= cases
    assert all(row["pipelined_ms"] > 0 for row in rows)
    assert "dual_aligned: scatter, binned bit-identical" in r.stdout


def test_kernel_timing_refuses_cpu_at_full_size():
    r = _run("--iters", "2")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not any(l.startswith("{") for l in r.stdout.splitlines())
