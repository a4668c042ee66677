"""Native C++ runtime tests (skipped if the toolchain/library is absent)."""

import numpy as np
import pytest

from pointcloud_depthfusion_tpu.runtime import (
    NativePairer,
    NativeRing,
    is_available,
    render_scene_native,
)
from pointcloud_depthfusion_tpu.core.camera import Intrinsics
from pointcloud_depthfusion_tpu.io.feeder import (
    ApproximateTimePairer,
    NativeSyntheticSource,
    SyntheticSource,
)
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene, two_camera_rig
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset

pytestmark = pytest.mark.skipif(
    not is_available(), reason="native runtime not built"
)


def test_native_render_matches_numpy():
    scene = SyntheticScene()
    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    wl, _ = two_camera_rig()
    fs = scene.render(intr, wl)
    sph = np.asarray(
        [[s.center[0], s.center[1], s.center[2], s.radius, *s.base_color]
         for s in scene.spheres]
    )
    d, c = render_scene_native(
        64, 48, 50.0, 50.0, 32.0, 24.0, wl,
        scene.plane_z, sph, scene.checker_period, scene.max_depth, 0.001,
    )
    np.testing.assert_array_equal(d, fs.depth)
    np.testing.assert_array_equal(c, fs.color)


def test_native_source_stream():
    scene = SyntheticScene()
    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    wl, _ = two_camera_rig()
    src = NativeSyntheticSource(scene, intr, wl, depth_noise_std=0.002,
                                hole_fraction=0.02, seed=5)
    f0 = src.next_frame()
    f1 = src.next_frame()
    assert f0.depth.shape == (48, 64)
    assert (f0.depth == 0).mean() > 0.005  # holes present
    assert f1.timestamp > f0.timestamp
    # noise-free native == numpy source output
    src_n = NativeSyntheticSource(scene, intr, wl, depth_noise_std=0.0,
                                  hole_fraction=0.0, seed=5)
    src_p = SyntheticSource(scene, intr, wl, depth_noise_std=0.0,
                            hole_fraction=0.0, seed=5)
    np.testing.assert_array_equal(src_n.next_frame().depth, src_p.next_frame().depth)


def test_native_pairer_matches_python():
    rng = np.random.default_rng(7)
    native = NativePairer(0.017, 10)
    python = ApproximateTimePairer(0.017, 10)

    def hf(ts):
        return HostFrameset(
            depth=np.zeros((2, 2), np.uint16),
            color=np.zeros((2, 2, 3), np.uint8), timestamp=ts,
        )

    fid = 0
    stamps = {0: 0.0, 1: 0.004}
    for _ in range(60):
        stream = int(rng.integers(0, 2))
        stamps[stream] += 1 / 30.0 + float(rng.normal(0, 0.002))
        ts = stamps[stream]
        got_n = native.push(stream, ts, fid)
        got_p = python.push(stream, hf(ts))
        assert len(got_n) == len(got_p), (fid, got_n, got_p)
        fid += 1
    assert native.emitted == python.emitted
    assert native.emitted > 10


def test_native_ring_order_and_capacity():
    ring = NativeRing(8, 3)
    for i in range(3):
        assert ring.try_write(np.full(8, i, np.uint8))
    assert not ring.try_write(np.zeros(8, np.uint8))  # full
    for i in range(3):
        got = ring.try_read()
        assert got is not None and got[0] == i
    assert ring.try_read() is None


def test_native_filters_match_numpy_exactly():
    """C++ spatial/decimation filters are value-identical to the numpy
    mirrors (built with -ffp-contract=off so the f32 blends round the same),
    incl. the f32 disparity domain."""
    import pytest

    from pointcloud_depthfusion_tpu import runtime as rt
    from pointcloud_depthfusion_tpu.ops import host_filters as HF

    if not rt.has_native_filters():
        pytest.skip("native runtime not built")
    rng = np.random.default_rng(11)
    d = rng.integers(300, 3000, (48, 64)).astype(np.uint16)
    d[rng.random((48, 64)) < 0.15] = 0
    want = HF._spatial_filter_numpy(d, 0.55, 20.0, 2)
    got = rt.spatial_filter_native(d, 0.55, 20.0, 2)
    np.testing.assert_array_equal(got, want)
    # f32 disparity domain
    disp = (rng.random((32, 40)).astype(np.float32) * 50 + 10)
    disp[rng.random((32, 40)) < 0.2] = 0.0
    np.testing.assert_array_equal(
        rt.spatial_filter_native(disp, 0.5, 8.0, 1),
        HF._spatial_filter_numpy(disp, 0.5, 8.0, 1),
    )
    # decimation
    np.testing.assert_array_equal(
        rt.decimation_filter_native(d, 4), HF._decimation_filter_numpy(d, 4)
    )
    # rs2 hole-persistence modes (left-value fill within 2/4/8/16/∞ px)
    for mode in (1, 3, 5):
        np.testing.assert_array_equal(
            rt.spatial_filter_native(d, 0.55, 20.0, 2, holes_fill=mode),
            HF._spatial_filter_numpy(d, 0.55, 20.0, 2, holes_fill=mode),
            err_msg=f"holes_fill {mode}",
        )


def test_spatial_filter_dispatch_dtype_and_value_identical():
    """spatial_filter_np must return the SAME values and dtype whether or
    not the native toolchain is present: wide int dtypes (which the u16
    native buffer cannot represent exactly) stay on the numpy path."""
    from pointcloud_depthfusion_tpu.ops import host_filters as HF

    rng = np.random.default_rng(3)
    wide = rng.integers(0, 90_000, (32, 40)).astype(np.int32)  # >65535 values
    got = HF.spatial_filter_np(wide, 0.55, 20.0, 1)
    want = HF._spatial_filter_numpy(wide, 0.55, 20.0, 1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # u16 keeps its dtype through whichever path serves it
    d16 = rng.integers(300, 3000, (32, 40)).astype(np.uint16)
    assert HF.spatial_filter_np(d16, 0.55, 20.0, 1).dtype == np.uint16


def test_load_library_probe_does_not_latch_failure(monkeypatch):
    """A build_if_missing=False probe while the .so is absent must not
    permanently disable later default calls that would have built it."""
    from pointcloud_depthfusion_tpu.runtime import bindings

    monkeypatch.setattr(bindings, "_lib", None)
    monkeypatch.setattr(bindings, "_lib_failed", False)
    monkeypatch.setattr(bindings, "_LIB_PATH", "/nonexistent/libpdf.so")
    assert bindings.load_library(build_if_missing=False) is None
    assert bindings._lib_failed is False  # retry latch untouched


_BUDGET_PROBE = """
import time
import numpy as np
from pointcloud_depthfusion_tpu import runtime as rt
from pointcloud_depthfusion_tpu.ops.host_filters import _spatial_filter_numpy
d = np.random.default_rng(0).integers(300, 3000, (480, 848)).astype(np.uint16)
rt.spatial_filter_native(d)  # warm
def cpu_ms(fn):
    best = float("inf")
    for _ in range(3):
        t0 = time.process_time()
        fn(d)
        best = min(best, (time.process_time() - t0) * 1e3)
    return best
print(cpu_ms(rt.spatial_filter_native), cpu_ms(_spatial_filter_numpy))
"""


def test_native_spatial_filter_meets_capture_budget():
    """The capture-path reason the native version exists: 848x480 spatial
    filtering must be several times cheaper than numpy (~130 ms) to fit
    the 33 ms frame budget. Compared in CPU time with one OpenMP thread,
    in a child process, so that other test workers holding the cores
    change neither number."""
    import os
    import subprocess
    import sys

    import pytest

    from pointcloud_depthfusion_tpu import runtime as rt

    if not rt.has_native_filters():
        pytest.skip("native runtime not built")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _BUDGET_PROBE], env=env,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    ms, numpy_ms = (float(v) for v in r.stdout.split()[-2:])
    assert ms < 0.5 * numpy_ms, (ms, numpy_ms)


def test_native_render_matches_numpy_grazing_pose():
    """Grazing view: plane hits beyond max_depth have depth 0 but keep
    their checker COLOR in the numpy reference (synthetic.py:101,122) —
    the native path must match on those pixels too."""
    scene = SyntheticScene()
    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    # Pitch the camera nearly parallel to the plane so ray z-components
    # are tiny and s_best exceeds max_depth for part of the image.
    a = np.deg2rad(85.0)
    pose = np.eye(4)
    pose[:3, :3] = np.array(
        [[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]]
    )
    fs = scene.render(intr, pose)
    assert (
        (np.asarray(fs.depth) == 0) & (np.asarray(fs.color).sum(-1) > 0)
    ).any(), "pose must produce beyond-max-depth colored pixels"
    sph = np.asarray(
        [[s.center[0], s.center[1], s.center[2], s.radius, *s.base_color]
         for s in scene.spheres]
    )
    d, c = render_scene_native(
        64, 48, 50.0, 50.0, 32.0, 24.0, pose,
        scene.plane_z, sph, scene.checker_period, scene.max_depth, 0.001,
    )
    np.testing.assert_array_equal(d, fs.depth)
    np.testing.assert_array_equal(c, fs.color)
