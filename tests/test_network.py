"""TCP frameset streaming tests (loopback): the cross-machine capture
transport (the reference's DDS/UDP hop between the two Jetson hosts,
README.md:14-34, exercised over a real socket)."""

import threading
import time

import numpy as np

from pointcloud_depthfusion_tpu.core.camera import Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
from pointcloud_depthfusion_tpu.io.network import (
    FramesetStreamServer,
    NetworkSource,
)
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene, two_camera_rig

W, H = 48, 36


def make_source(seed=1, pose=None, w=W, h=H):
    intr = Intrinsics.create(w, h, fx=40.0 * w / W, fy=40.0 * w / W,
                             ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    wl, _ = two_camera_rig()
    return SyntheticSource(scene, intr, pose if pose is not None else wl,
                           seed=seed, depth_noise_std=0.001), intr


def test_stream_round_trip_bit_exact():
    """Frames received over the socket decode bit-identically to the
    source frames (PNG compression is lossless for u16 depth + rgb8)."""
    src, intr = make_source(seed=7)
    ref, _ = make_source(seed=7)  # identical twin for expected frames
    rot = np.eye(3)
    rot[0, 1] = 1e-3  # non-trivial extrinsics survive the handshake
    ext = Extrinsics.create(rot, [0.015, 0.0, -0.001])
    with FramesetStreamServer(src, fps=0.0, name="camera_left",
                              depth_to_color=ext, max_frames=5) as server:
        client = NetworkSource("127.0.0.1", server.port)
        assert client.name == "camera_left"
        np.testing.assert_allclose(
            np.asarray(client.intrinsics.fx), np.asarray(intr.fx)
        )
        np.testing.assert_allclose(
            np.asarray(client.depth_to_color.translation),
            [0.015, 0.0, -0.001], atol=1e-7,
        )
        got = []
        while True:
            fs = client.next_frame()
            if fs is None:
                break
            got.append(fs)
    assert len(got) == 5
    for fs in got:
        want = ref.next_frame()
        np.testing.assert_array_equal(fs.depth, want.depth)
        np.testing.assert_array_equal(fs.color, want.color)
        assert abs(fs.timestamp - want.timestamp) < 1e-9
    assert client.next_frame() is None  # stays ended


def test_network_source_feeds_camera_node_and_feeder():
    """A NetworkSource is a first-class FramesetSource: CameraNode +
    DeviceFeeder pair two remote streams end to end."""
    from pointcloud_depthfusion_tpu.io.feeder import DeviceFeeder
    from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode

    wl, wr = two_camera_rig(baseline=0.3)
    src_l, _ = make_source(seed=1, pose=wl)
    src_r, _ = make_source(seed=2, pose=wr)
    with FramesetStreamServer(src_l, fps=0.0, max_frames=6) as sl, \
            FramesetStreamServer(src_r, fps=0.0, max_frames=6) as sr:
        cam_l = CameraNode("camera_left",
                           NetworkSource("127.0.0.1", sl.port),
                           temporal_filter=False)
        cam_r = CameraNode("camera_right",
                           NetworkSource("127.0.0.1", sr.port),
                           temporal_filter=False)
        params = cam_l.get_camera_parameters()
        assert params.color_info.width == W
        feeder = DeviceFeeder(cam_l, cam_r)
        pairs = 0
        with feeder:
            while True:
                pair = feeder.get(timeout=20.0)
                if pair is None:
                    break
                assert pair.left.depth.shape == (H, W)
                pairs += 1
    assert pairs >= 4  # both streams stamped identically → all pairable


def test_server_drops_oldest_when_client_stalls():
    """Best-effort QoS: a stalled consumer loses old frames, not liveness.

    Frames must be large enough that the kernel's TCP buffers cannot absorb
    the whole stream (otherwise sendall never blocks and nothing drops)."""
    src, _ = make_source(seed=3, w=320, h=240)
    server = FramesetStreamServer(src, fps=0.0, queue_size=2, max_frames=40,
                                  sndbuf=16384)
    server.start()
    try:
        client = NetworkSource("127.0.0.1", server.port)
        time.sleep(2.0)  # don't read: the producer must keep going
        got = 0
        while client.next_frame() is not None:
            got += 1
        # some frames arrived, and the backlog was bounded
        assert got >= 1
        assert server.frames_dropped > 0
        assert got + server.frames_dropped <= 40 + 2
    finally:
        server.stop()


def test_server_stop_unblocks_stalled_sender():
    """stop() must close the ACTIVE client connection: a sender blocked in
    conn.sendall (stalled client, kernel SNDBUF full) never checks the stop
    event — without the close it survives stop() and resumes streaming if
    the client ever reads again."""
    src, _ = make_source(seed=5, w=320, h=240)
    server = FramesetStreamServer(src, fps=0.0, queue_size=2, sndbuf=16384)
    server.start()
    client = NetworkSource("127.0.0.1", server.port)
    time.sleep(1.5)  # never read → sender blocks in sendall
    t0 = time.perf_counter()
    server.stop()
    assert time.perf_counter() - t0 < 4.0  # no join-timeout expiry
    assert not server._thread.is_alive()
    client.close()


def test_server_reaccepts_after_disconnect():
    src, _ = make_source(seed=4)
    server = FramesetStreamServer(src, fps=0.0, max_frames=3)
    server.start()
    try:
        c1 = NetworkSource("127.0.0.1", server.port)
        assert c1.next_frame() is not None
        c1.close()  # drop mid-stream
        deadline = time.time() + 10.0
        c2 = None
        while time.time() < deadline:
            try:
                c2 = NetworkSource("127.0.0.1", server.port, timeout_s=2.0)
                break
            except (ConnectionError, OSError):
                time.sleep(0.1)
        assert c2 is not None and c2.next_frame() is not None
    finally:
        server.stop()


def test_realsense_bridge_guarded_absent():
    """The live-sensor bridge degrades with a clear error on hosts without
    pyrealsense2 (fusion hosts) instead of failing at import time."""
    import pytest

    from pointcloud_depthfusion_tpu.io import realsense_host

    try:
        import pyrealsense2  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="pyrealsense2"):
            realsense_host.RealsenseSource()
    # mapping table covers every rs2 distortion id 0-5
    assert set(realsense_host._RS_DISTORTION) == set(range(6))


def test_raw_codec_round_trip_bit_exact():
    """The raw (uncompressed) wire codec — the reference's DDS-parity
    format — round-trips bit-identically, including stamps and scale."""
    src, intr = make_source(seed=9)
    ref, _ = make_source(seed=9)
    with FramesetStreamServer(src, fps=0.0, max_frames=4,
                              codec="raw") as server:
        client = NetworkSource("127.0.0.1", server.port)
        assert client.codec == "raw"
        got = []
        while True:
            fs = client.next_frame()
            if fs is None:
                break
            got.append(fs)
    assert len(got) == 4
    for fs in got:
        want = ref.next_frame()
        np.testing.assert_array_equal(fs.depth, want.depth)
        np.testing.assert_array_equal(fs.color, want.color)
        assert abs(fs.timestamp - want.timestamp) < 1e-9
        assert fs.depth_scale == np.float32(want.depth_scale)


def test_abrupt_close_raises_not_silent_end():
    """A peer dying WITHOUT the 0-length end sentinel is an ERROR (the
    server always sends the sentinel on clean end), never a silent
    end-of-stream — silent Nones shut the fusion pipeline down with zero
    diagnostic."""
    import socket
    import struct

    import pytest

    src, intr = make_source(seed=3)
    ext = Extrinsics.create(np.eye(3), [0.0, 0.0, 0.0])
    with FramesetStreamServer(src, fps=0.0, name="cam",
                              depth_to_color=ext, max_frames=50) as server:
        client = NetworkSource("127.0.0.1", server.port)
        assert client.next_frame() is not None
        # Sever the transport mid-stream from the client side; the next
        # read must raise, not return None.
        client._sock.shutdown(socket.SHUT_RD)
        with pytest.raises((ConnectionError, OSError)):
            while client.next_frame() is not None:
                pass


def test_server_max_frames_does_not_consume_extra():
    """The producer checks the frame cap BEFORE fetching: serving
    max_frames=N must pull exactly N frames from the source."""

    class CountingSource:
        def __init__(self, inner):
            self.inner = inner
            self.pulled = 0
            self.intrinsics = inner.intrinsics

        def next_frame(self):
            self.pulled += 1
            return self.inner.next_frame()

    src, intr = make_source(seed=4)
    counting = CountingSource(src)
    ext = Extrinsics.create(np.eye(3), [0.0, 0.0, 0.0])
    with FramesetStreamServer(counting, fps=0.0, name="cam",
                              depth_to_color=ext, max_frames=3) as server:
        client = NetworkSource("127.0.0.1", server.port)
        got = 0
        while client.next_frame() is not None:
            got += 1
    assert got == 3
    assert counting.pulled == 3, counting.pulled


def test_source_crash_aborts_client_loudly():
    """A source failure on the camera host must surface on the FUSION host
    as a ConnectionError, not as the clean end-of-stream sentinel — and a
    retry after the error keeps raising instead of reading as clean EOS."""
    import pytest

    class CrashSource(SyntheticSource):
        def next_frame(self):
            if self.frame_idx >= 2:
                raise RuntimeError("sensor stalled")
            return super().next_frame()

    intr = Intrinsics.create(W, H, fx=40.0, fy=40.0, ppx=W / 2, ppy=H / 2)
    wl, _ = two_camera_rig()
    crash = CrashSource(SyntheticScene(), intr, wl, seed=1)
    with FramesetStreamServer(crash, fps=0.0, name="camera_left") as server:
        client = NetworkSource("127.0.0.1", server.port, timeout_s=10.0)
        assert client.next_frame() is not None
        assert client.next_frame() is not None
        with pytest.raises(ConnectionError, match="aborted mid-stream"):
            client.next_frame()
        # post-error calls keep raising (no silent clean-EOS after error)
        with pytest.raises(ConnectionError):
            client.next_frame()
        client.close()


def test_clean_end_does_not_drop_tail_frames():
    """A bounded stream's final frames must all arrive even when the client
    is slow at stream end: the clean end-sentinel WAITS for the sender to
    drain instead of dropping queued frames to make room (only the ABORT
    path sacrifices the backlog for immediacy)."""
    src, _ = make_source(seed=9)
    server = FramesetStreamServer(src, fps=0.0, queue_size=2, max_frames=7)
    server.start()
    try:
        client = NetworkSource("127.0.0.1", server.port)
        time.sleep(1.0)  # small frames: queue fills, kernel holds the rest
        got = 0
        while True:
            f = client.next_frame()
            if f is None:
                break
            got += 1
            time.sleep(0.05)  # slow consumer through stream end
        assert got == 7, f"lost tail frames: got {got}/7"
        assert server.frames_dropped == 0
    finally:
        server.stop()


def test_undecodable_frame_latches_connection_error():
    """A desynced/corrupt payload raises ConnectionError (not a codec
    ValueError) and LATCHES: a retrying caller keeps getting the error
    instead of reading mid-frame bytes as fresh length fields."""
    import socket
    import struct

    import pytest

    from pointcloud_depthfusion_tpu.io import network as N

    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]

    def serve():
        conn, _ = lst.accept()
        # valid handshake, then one garbage frame blob
        src, intr = make_source(seed=11)
        srv = FramesetStreamServer.__new__(FramesetStreamServer)
        srv.name, srv.fps, srv.codec, srv.source = "x", 30.0, "raw", src
        srv._ext_rot = np.eye(3)
        srv._ext_t = np.zeros(3)
        conn.sendall(srv._handshake_blob())
        junk = b"\x01\x02\x03\x04" * 8
        conn.sendall(struct.pack("<I", len(junk)) + junk)
        time.sleep(1.0)
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    client = NetworkSource("127.0.0.1", port)
    with pytest.raises(ConnectionError, match="undecodable"):
        client.next_frame()
    with pytest.raises(ConnectionError):  # latched, keeps raising
        client.next_frame()
    th.join(timeout=5)
