"""tools/stream_bench.py smoke: the streaming measurement must keep
producing parseable rows for every mode (it backs the BASELINE 30 FPS
row; a silent CLI regression would strand the next measurement)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "stream_bench.py")


def _run(*extra):
    r = subprocess.run(
        [sys.executable, TOOL, "--cpu", "--width", "128", "--height", "96",
         "--frames", "10", "--warmup", "2", *extra],
        capture_output=True, text=True, timeout=420,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [ln for ln in r.stdout.strip().splitlines() if ln.startswith("{")]
    assert rows, r.stdout
    return json.loads(rows[-1])


def test_dual_machinery_fence_row():
    out = _run("--device-resident", "3", "--readback", "fence")
    assert out["metric"] == "streaming_fps_dual_128x96_machinery"
    assert out["readback"] == "fence"
    assert out["frames_measured"] == 10
    assert out["payload_mb_per_frame"] > 0


def test_rig_machinery_row():
    out = _run("--rig", "3", "--device-resident", "2", "--readback", "fence")
    assert out["metric"] == "streaming_fps_rig3_128x96_machinery"
    assert out["frames_measured"] == 10
    assert out["payload_mb_per_frame"] > 0


def test_feeder_only_row():
    out = _run("--no-compute")
    assert out["metric"] == "streaming_fps_dual_128x96_feeder_only"
    assert out["compute"] is False
