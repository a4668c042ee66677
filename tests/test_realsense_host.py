"""Live-capture bridge (io/realsense_host.py) executed against a faithful
pyrealsense2 mock (tests/mock_pyrealsense2.py).

pyrealsense2 is absent on the fusion host, so without these tests the ONLY
coverage of the reference's capture behavior (realsense.cpp:57-444) would
be code review. The mock reproduces the SDK semantics the bridge depends
on — discovery by serial, config resolution at pipeline.start, hardware
millisecond clocks, align-to-color, the temporal filter, frame timeouts —
so every branch of RealsenseSource actually runs.
"""

import sys

import numpy as np
import pytest

import mock_pyrealsense2 as mockrs


@pytest.fixture(autouse=True)
def _install_mock(monkeypatch):
    mockrs._reset()
    monkeypatch.setitem(sys.modules, "pyrealsense2", mockrs)
    yield
    mockrs._reset()


def make_source(**kwargs):
    from pointcloud_depthfusion_tpu.io.realsense_host import RealsenseSource

    defaults = dict(model="D455", width=160, height=120, warmup_frames=4)
    defaults.update(kwargs)
    return RealsenseSource(**defaults)


def test_no_device_raises():
    with pytest.raises(RuntimeError, match="no RealSense device"):
        make_source()


def test_unknown_serial_raises():
    mockrs.add_device(serial="AAA111")
    with pytest.raises(RuntimeError, match="BBB222 not found"):
        make_source(serial="BBB222")


def test_discovery_by_serial_selects_right_device():
    mockrs.add_device(serial="AAA111", depth_scale=0.001)
    dev_b = mockrs.add_device(serial="BBB222", depth_scale=0.00025)
    src = make_source(serial="BBB222")
    assert src.depth_scale == pytest.approx(0.00025)
    # all grabs (clock rebase + warm-up) came from the selected device
    assert dev_b.frames_served == 4


def test_first_device_default_and_model_preset_streams():
    """Without a serial the first device wins (realsense.cpp:57-110), and
    the D455 preset requests 1280×720 Z16+RGB8 @30 on both streams."""
    dev = mockrs.add_device(serial="AAA111")
    mockrs.add_device(serial="BBB222")
    src = make_source(width=0, height=0)  # no override → preset sizes
    assert dev.frames_served == 4
    assert src._cfg.streams[mockrs.stream.depth] == (
        1280, 720, mockrs.format.z16, 30)
    assert src._cfg.streams[mockrs.stream.color] == (
        1280, 720, mockrs.format.rgb8, 30)


def test_l515_preset_has_distinct_depth_size():
    mockrs.add_device()
    src = make_source(model="L515", width=0, height=0)
    assert src._cfg.streams[mockrs.stream.depth][:2] == (1024, 768)
    assert src._cfg.streams[mockrs.stream.color][:2] == (1280, 720)
    # align-to-color: the emitted depth follows the COLOR geometry
    fs = src.next_frame()
    assert fs.depth.shape == (720, 1280)
    assert fs.color.shape == (720, 1280, 3)


def test_unsupported_profile_raises_at_start():
    """The SDK resolves the config at pipeline.start; a device that cannot
    serve the requested profile raises there, not at first frame."""
    mockrs.add_device(supported={
        (mockrs.stream.depth, 1280, 720, mockrs.format.z16, 30),
        (mockrs.stream.color, 1280, 720, mockrs.format.rgb8, 30),
    })
    with pytest.raises(RuntimeError, match="resolve"):
        make_source(width=640, height=480)


def test_intrinsics_and_distortion_mapping():
    mockrs.add_device(
        distortion_model=mockrs.distortion.inverse_brown_conrady,
        coeffs=(-0.05, 0.06, 0.0, 0.0, -0.01),
    )
    src = make_source()
    from pointcloud_depthfusion_tpu.core.camera import Distortion

    intr = src.intrinsics
    assert intr.width == 160 and intr.height == 120
    assert int(intr.model) == int(Distortion.INVERSE_BROWN_CONRADY)
    np.testing.assert_allclose(
        np.asarray(intr.coeffs), [-0.05, 0.06, 0.0, 0.0, -0.01], atol=1e-7
    )
    # fx/ppx taken from the COLOR video stream profile (aligned output
    # shares the color calibration, realsense.cpp:670-680)
    assert float(intr.fx) == pytest.approx(0.74 * 160)
    assert float(intr.ppx) == pytest.approx(160 / 2 + 3.7)


def test_clock_rebase_to_system_time():
    """Hardware stamps sit on their own epoch (~55 s here); the bridge's
    rebase (realsense.cpp:318-334, :424-431) must emit SYSTEM-clock
    timestamps advancing at the hardware cadence."""
    import time

    mockrs.add_device(hw_epoch_ms=55_000.0, fps=30.0)
    src = make_source()
    t_before = time.time()
    f1 = src.next_frame()
    f2 = src.next_frame()
    assert abs(f1.timestamp - t_before) < 1.0  # system epoch, not 55 s
    assert f2.timestamp - f1.timestamp == pytest.approx(1 / 30.0, abs=2e-3)


def test_warmup_frames_consumed_before_first_emit():
    dev = mockrs.add_device()
    src = make_source(warmup_frames=4)
    assert dev.frames_served == 4  # 1 rebase grab + 3 extra warm-ups
    src.next_frame()
    assert dev.frames_served == 5


def test_temporal_filter_runs_in_hot_loop():
    """ONLY the temporal filter runs per frame (realsense.cpp:398-404):
    emitted depth is the SDK filter's EMA of consecutive frames, not the
    raw capture."""
    dev = mockrs.add_device(seed=7)
    src = make_source()
    f1 = src.next_frame()
    f2 = src.next_frame()
    assert src._temporal.processed == 2
    # reproduce the EMA against the device's raw frames (grabs 4 and 5)
    raw1, _, _ = dev.render(4, (160, 120), (160, 120))
    raw2, _, _ = dev.render(5, (160, 120), (160, 120))
    np.testing.assert_array_equal(f1.depth, raw1)  # first frame: passthrough
    expect2 = (0.4 * raw2.astype(np.float32)
               + 0.6 * raw1.astype(np.float32)).astype(np.uint16)
    np.testing.assert_array_equal(f2.depth, expect2)
    assert not np.array_equal(f2.depth, raw2)


def test_timeout_raises_instead_of_silent_eos():
    """A wait_for_frames failure must RAISE, not read as a clean end of
    stream: a live sensor has no natural EOS, and a None here would make
    the bridge server send its clean end-sentinel — shutting the remote
    fusion host down mid-capture with zero diagnostic."""
    mockrs.add_device(n_frames=6)
    src = make_source()  # 4 grabs consumed by rebase+warmup
    assert src.next_frame() is not None
    assert src.next_frame() is not None
    with pytest.raises(TimeoutError, match="stalled or disconnected"):
        src.next_frame()


def test_bridge_serves_over_tcp_to_network_source():
    """Full camera-host bridge: RealsenseSource → FramesetStreamServer →
    NetworkSource round trip, bit-exact depth/color (the deployment split
    the module exists for: sensor host streams, fusion host consumes)."""
    from pointcloud_depthfusion_tpu.io.network import (
        FramesetStreamServer,
        NetworkSource,
    )

    mockrs.add_device(n_frames=16, seed=3)
    src = make_source()
    server = FramesetStreamServer(
        src, host="127.0.0.1", port=0, name="camera_left",
        fps=src.fps, depth_to_color=src.depth_to_color, max_frames=3,
    )
    server.start()
    try:
        net = NetworkSource("127.0.0.1", server.port)
        got = []
        while True:
            fs = net.next_frame()
            if fs is None:
                break
            got.append(fs)
        assert len(got) == 3
        assert got[0].depth.dtype == np.uint16
        assert got[0].color.shape == (120, 160, 3)
        assert got[0].depth_scale == pytest.approx(src.depth_scale)
        # frames advance (temporal EMA keeps them distinct but correlated)
        assert not np.array_equal(got[0].depth, got[-1].depth)
        net.close()
    finally:
        server.stop()
        src.stop()
