"""Node-app integration tests: the full 5-node deployment in-process."""

import numpy as np

from pointcloud_depthfusion_tpu.core.camera import Intrinsics
from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig
from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
from pointcloud_depthfusion_tpu.io.synthetic import (
    SyntheticScene,
    right_to_left_transform,
    two_camera_rig,
)
from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode
from pointcloud_depthfusion_tpu.nodes.fusion_node import FusionNodeApp
from pointcloud_depthfusion_tpu.nodes.image_node import ImageNode
from pointcloud_depthfusion_tpu.nodes.registration_node import RegistrationNodeApp
from pointcloud_depthfusion_tpu.registration.pipeline import RegistrationSettings


W, H = 64, 48


def make_rig():
    intr = Intrinsics.create(W, H, fx=50.0, fy=50.0, ppx=W / 2, ppy=H / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    cam_l = CameraNode("camera_left", SyntheticSource(scene, intr, wl, seed=1),
                       temporal_filter=False)
    cam_r = CameraNode("camera_right", SyntheticSource(scene, intr, wr, seed=2),
                       temporal_filter=False)
    return cam_l, cam_r, right_to_left_transform(wl, wr)


def test_camera_node_capture_and_service():
    cam_l, _, _ = make_rig()
    frames = []
    depths = []
    cam_l.subscribe_frameset(frames.append)
    cam_l.subscribe_depth(lambda d, t: depths.append((d, t)))
    fs = cam_l.capture()
    assert fs is not None and len(frames) == 1 and len(depths) == 1
    params = cam_l.get_camera_parameters()
    assert params.color_info.width == W
    assert params.extrinsic_rotation.shape == (9,)


def test_fusion_node_pack_color_gated_by_render_mode():
    """Every render mode consumes Frameset.color_packed, so pack_color is
    honored whatever the mode."""
    from pointcloud_depthfusion_tpu.fusion.pipeline import RENDER_MODES

    cam_l, cam_r, _ = make_rig()
    for mode in RENDER_MODES:
        cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                                  filter_fused_color=False, render_mode=mode)
        app = FusionNodeApp(cam_l, cam_r, config=cfg, pack_color=True)
        assert app.feeder.pack_color is True, mode


def test_camera_node_temporal_filter_applies():
    intr = Intrinsics.create(W, H, fx=50.0, fy=50.0, ppx=W / 2, ppy=H / 2)
    scene = SyntheticScene()
    wl, _ = two_camera_rig()
    cam = CameraNode("c", SyntheticSource(scene, intr, wl, depth_noise_std=0.005,
                                          seed=3), temporal_filter=True)
    f1 = cam.capture()
    f2 = cam.capture()
    # second frame is blended with history → different from a raw capture
    raw = SyntheticSource(scene, intr, wl, depth_noise_std=0.005, seed=3)
    raw.next_frame()
    r2 = raw.next_frame()
    assert not np.array_equal(f2.depth, r2.depth)


def test_full_deployment_end_to_end(tmp_path):
    cam_l, cam_r, t_true = make_rig()
    fusion = FusionNodeApp(
        cam_l, cam_r,
        config=FusionConfig.create(vertical_image=False, mirror_image=False,
                                   filter_fused_color=False),
        save_data_dir=str(tmp_path / "dumps"),
    )
    registration = RegistrationNodeApp(
        cam_l, cam_r,
        settings=RegistrationSettings(
            resolution=0.03, voxelsize=0.015, initial_resolution=0.12,
            resolution_step=0.05, max_iterations=32,
            discard_transform=False, reset_initial_guess=False,
        ),
    )
    registration.subscribe_transform(fusion.on_transform)
    sink = ImageNode(out_dir=str(tmp_path / "imgs"))
    fusion.subscribe_fused(sink)
    sync_msgs = []
    fusion.subscribe_sync_debug(sync_msgs.append)

    # Drive: capture frames (pushes depth to registration), tick
    # registration a few times, then run fused frames through the feeder.
    for _ in range(3):
        cam_l.capture()
        cam_r.capture()
        registration.tick()

    n = fusion.run(max_frames=4)
    assert n == 4
    assert sink.received == 4 and sink.saved == 4
    assert len(sync_msgs) == 4 and "sync callback" in sync_msgs[0]
    # save_data dumps exist (5 PNGs per frame)
    dumps = list((tmp_path / "dumps").glob("*.png"))
    assert len(dumps) == 20
    # registration moved toward truth
    t = registration.pipeline.last_transform
    assert np.linalg.norm(t[:3, 3] - t_true[:3, 3]) < 0.1
    registration.stop()


def test_host_temporal_filter_matches_device_op():
    """CameraNode's numpy temporal filter == ops.filters.temporal_filter."""
    import jax.numpy as jnp
    from pointcloud_depthfusion_tpu.ops import filters as F
    from pointcloud_depthfusion_tpu.core.frameset import HostFrameset

    rng = np.random.default_rng(5)
    cam_l, _, _ = make_rig()
    cam_l.temporal_filter = True
    prev = rng.integers(0, 1200, (H, W)).astype(np.uint16)
    cur = (prev.astype(np.int32) + rng.integers(-30, 30, prev.shape)).clip(0, 65535).astype(np.uint16)
    cur[0, :5] = 0
    cam_l._prev_depth = prev
    got = cam_l._apply_temporal(cur)
    want, _ = F.temporal_filter(jnp.asarray(cur), jnp.asarray(prev),
                                alpha=cam_l.temporal_alpha, delta=cam_l.temporal_delta)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_camera_node_full_filter_bank_composition():
    """Enabling the whole rs2 bank equals composing the host filters
    manually in the librealsense-recommended order."""
    from pointcloud_depthfusion_tpu.ops import host_filters as HF

    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    scene = SyntheticScene()
    wl, _ = two_camera_rig()
    src = SyntheticSource(scene, intr, wl, depth_noise_std=0.003,
                          hole_fraction=0.05, seed=7)
    node = CameraNode(
        "cam", src,
        decimation_filter=True, decimation_magnitude=2,
        threshold_filter=True, threshold_max_m=2.5,
        disparity_domain=True, spatial_filter=True,
        temporal_filter=True, hole_filling=True,
    )
    raw_src = SyntheticSource(scene, intr, wl, depth_noise_std=0.003,
                              hole_fraction=0.05, seed=7)
    prev = None
    fx = float(intr.fx)
    for _ in range(3):
        got = node.capture()
        raw = raw_src.next_frame()
        d = HF.decimation_filter_np(raw.depth, 2)
        d = HF.threshold_filter_np(d, raw.depth_scale, 0.0, 2.5)
        disp = HF.depth_to_disparity_np(d, raw.depth_scale, fx / 2, 0.095)
        disp = HF.spatial_filter_np(disp, 0.55, 20.0, 2)
        if prev is not None:
            cur = disp
            have = (cur > 0) & (prev > 0)
            close = np.abs(cur - prev) <= 20.0
            disp = np.where(have & close, 0.4 * cur + 0.6 * prev, cur)
            disp = np.where((cur == 0) & (prev > 0), prev, disp).astype(np.float32)
        prev = disp
        d = HF.disparity_to_depth_np(disp, raw.depth_scale, fx / 2, 0.095)
        want = HF.hole_fill_np(d, "farthest")
        np.testing.assert_array_equal(got.depth, want)
    # decimated depth profile reported by the parameter service
    params = node.get_camera_parameters()
    assert params.depth_info.width == 32 and params.depth_info.height == 24
    assert params.color_info.width == 64


def test_camera_node_option_reflection_round_trip():
    """attach_config declares the full sensor option tree (reference
    declareRosParameters sweep) and dispatches runtime updates back into
    the node AND the source."""
    from pointcloud_depthfusion_tpu.utils.config import ConfigTree

    intr = Intrinsics.create(32, 24, fx=25.0, fy=25.0, ppx=16.0, ppy=12.0)
    src = SyntheticSource(SyntheticScene(), intr, two_camera_rig()[0],
                          depth_noise_std=0.002, hole_fraction=0.01)
    node = CameraNode("cam", src)
    cfg = ConfigTree({"sensor": {"depth": {"spatial_filter": True,
                                           "spatial_alpha": 0.7}}})
    node.attach_config(cfg)
    # pre-set values applied at attach time
    assert node.spatial_filter is True and node.spatial_alpha == 0.7
    # the FULL option set was declared into the tree with type inference
    tree = cfg.as_dict()["sensor"]
    assert tree["depth"]["decimation_magnitude"] == 2
    assert tree["depth"]["temporal_alpha"] == 0.4
    assert tree["depth"]["depth_noise_std"] == 0.002  # source option
    assert tree["color"]["jitter"] == 0.0
    # runtime dispatch: node option
    cfg.set("sensor.depth.temporal_alpha", 0.55)
    assert node.temporal_alpha == 0.55
    # runtime dispatch: int type inference from the declared default
    cfg.set("sensor.depth.decimation_magnitude", 4.0)
    assert node.decimation_magnitude == 4 and isinstance(node.decimation_magnitude, int)
    # runtime dispatch into the SOURCE (sensor-option write-back)
    cfg.set("sensor.depth.depth_noise_std", 0.01)
    assert src.depth_noise_std == 0.01
    cfg.set("sensor.color.jitter", 0.002)
    assert src.jitter == 0.002


def test_image_node_viewer_variants(tmp_path):
    """All four reference viewer callbacks write artifacts: fused, depth
    (convertScaleAbs 0.1), frameset (color|scaled-depth side by side),
    small preview (image_node.cpp:38-109)."""
    from pointcloud_depthfusion_tpu.core.frameset import HostFrameset
    from pointcloud_depthfusion_tpu.nodes.image_node import ImageNode, depth_to_u8

    sink = ImageNode(out_dir=str(tmp_path))
    rgb = np.full((8, 10, 3), 77, np.uint8)
    depth = np.arange(80, dtype=np.uint16).reshape(8, 10) * 40
    sink(rgb, 0.0)
    sink.on_depth(depth, 0.0)
    sink.on_frameset(HostFrameset(depth=depth, color=rgb, timestamp=0.0))
    sink.on_image_small(rgb[::2, ::2], 0.0)
    import os
    names = sorted(os.listdir(tmp_path))
    assert names == [
        "depth_000000.png", "frameset_000000.png",
        "fused_000000.png", "small_000000.png",
    ]
    # convertScaleAbs semantics: |d*0.1| saturated
    vis = depth_to_u8(depth)
    assert vis.dtype == np.uint8 and vis.max() == 255
    assert vis[0, 5] == round(depth[0, 5] * 0.1)
    # frameset artifact is color|depth side by side
    from PIL import Image
    combo = np.asarray(Image.open(tmp_path / "frameset_000000.png"))
    assert combo.shape == (8, 20, 3)
    np.testing.assert_array_equal(combo[:, :10], rgb)
    np.testing.assert_array_equal(combo[:, 10:, 0], vis)


def test_camera_node_small_image_topic():
    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    src = SyntheticSource(SyntheticScene(), intr, two_camera_rig()[0])
    node = CameraNode("cam", src, small_image_width=32, small_image_height=16)
    got = []
    node.subscribe_color_small(lambda img, ts: got.append(img))
    node.capture()
    assert got[0].shape == (16, 32, 3)


def test_async_readback_same_outputs():
    """async_readback publishes the same images in the same order (one
    frame late internally, drained by run())."""
    cam_l, cam_r, _ = make_rig()
    cam_l2, cam_r2, _ = make_rig()
    cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                              filter_fused_color=False)
    sync_app = FusionNodeApp(cam_l, cam_r, config=cfg)
    async_app = FusionNodeApp(cam_l2, cam_r2, config=cfg, async_readback=True)
    sync_imgs, async_imgs = [], []
    sync_app.subscribe_fused(lambda img, ts: sync_imgs.append((img.copy(), ts)))
    async_app.subscribe_fused(lambda img, ts: async_imgs.append((img.copy(), ts)))
    assert sync_app.run(max_frames=4) == 4
    assert async_app.run(max_frames=4) == 4
    assert len(sync_imgs) == len(async_imgs) == 4
    for (a, ta), (b, tb) in zip(sync_imgs, async_imgs):
        np.testing.assert_array_equal(a, b)
        assert ta == tb


def test_option_coercion_from_strings():
    intr = Intrinsics.create(32, 24, fx=25.0, fy=25.0, ppx=16.0, ppy=12.0)
    node = CameraNode("c", SyntheticSource(SyntheticScene(), intr,
                                           two_camera_rig()[0]))
    node._set_option("depth", "temporal_filter", "false")
    assert node.temporal_filter is False
    node._set_option("depth", "temporal_filter", "True")
    assert node.temporal_filter is True
    node._set_option("depth", "decimation_magnitude", "4")
    assert node.decimation_magnitude == 4
    node._set_option("depth", "temporal_alpha", "0.25")
    assert node.temporal_alpha == 0.25


def test_decimated_stream_rejected_by_fusion_feeder():
    import pytest
    from pointcloud_depthfusion_tpu.io.feeder import DeviceFeeder

    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    scene = SyntheticScene()
    wl, wr = two_camera_rig()
    cam_l = CameraNode("l", SyntheticSource(scene, intr, wl),
                       decimation_filter=True)
    cam_r = CameraNode("r", SyntheticSource(scene, intr, wr))
    with DeviceFeeder(cam_l, cam_r) as feeder:
        with pytest.raises(RuntimeError, match="producer failed"):
            feeder.get(timeout=10.0)
        assert "size mismatch" in str(feeder.error)


def test_fusion_node_pins_align_footprint():
    """With align_frames on, the node derives a concrete splat-box bound
    from BOTH cameras' handshake intrinsics (inside the jitted pipeline the
    traced intrinsics would silently fall back to the cap of 4)."""
    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu.nodes.fusion_node import FusionNodeApp

    cam_l, cam_r, t_rl = make_rig()
    cfg = FusionConfig.create(align_frames=True, vertical_image=False,
                              mirror_image=False)
    assert cfg.align_footprint == "auto"
    app = FusionNodeApp(cam_l, cam_r, config=cfg)
    bound = app.config.align_footprint
    assert isinstance(bound, int) and 2 <= bound <= 6


def test_runtime_debug_namespace_camera(tmp_path):
    """debug.* / profiling.* dispatch at RUNTIME on a streaming camera node
    (reference parametersCallback, config.cpp:118-137)."""
    from pointcloud_depthfusion_tpu.utils.config import ConfigTree

    cam_l, _, _ = make_rig()
    cfg = ConfigTree()
    cam_l.attach_config(cfg)
    assert cam_l.debug_save_data is False
    cam_l.capture()  # no dumps yet
    dump_dir = str(tmp_path / "camdump")
    cfg.set("debug.save_data_dir", dump_dir)
    cfg.set("debug.enable_debug", True)
    cam_l.capture()
    import os

    pngs = os.listdir(dump_dir)
    assert any(p.endswith("_depth.png") for p in pngs)
    assert any(p.endswith("_color.png") for p in pngs)
    cfg.set("debug.enable_debug", False)
    n = len(pngs)
    cam_l.capture()
    assert len(os.listdir(dump_dir)) == n  # toggled back off

    # profiling.publish_fps gates the sink, not the counting
    msgs = []
    cam_l.fps_counter.sink = msgs.append
    cam_l.fps_counter.report_every_s = 0.0
    cfg.set("profiling.publish_fps", False)
    cam_l.capture()
    assert msgs == []
    cfg.set("profiling.publish_fps", True)
    cam_l.capture()
    assert len(msgs) == 1


def test_runtime_debug_namespace_fusion(tmp_path):
    """FusionNodeApp: debug.save_data + profiling.enable_profiling toggle
    mid-run through the attached ConfigTree."""
    from pointcloud_depthfusion_tpu.utils.config import ConfigTree

    cam_l, cam_r, t_rl = make_rig()
    cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                              filter_fused_color=False)
    app = FusionNodeApp(cam_l, cam_r, config=cfg, async_readback=False)
    tree = ConfigTree()
    app.attach_config(tree)
    assert app.save_data_dir is None and app.stage_log is None

    dump_dir = str(tmp_path / "fusedump")
    import os

    os.makedirs(dump_dir, exist_ok=True)
    tree.set("debug.save_data_dir", dump_dir)
    tree.set("debug.save_data", True)
    assert app.save_data_dir == dump_dir
    prof_path = str(tmp_path / "prof.csv")
    tree.set("profiling.log_path", prof_path)
    tree.set("profiling.enable_profiling", True)
    assert app.stage_log is not None

    with app.feeder as feeder:
        app.process_pair(feeder.get())
    assert any(p.endswith("_fused.png") for p in os.listdir(dump_dir))
    assert app.stage_log.rows  # profiled laps recorded

    tree.set("profiling.enable_profiling", False)
    assert app.stage_log is None
    tree.set("debug.save_data", False)
    assert app.save_data_dir is None


def test_image_node_window_close_shutdown():
    """A display backend raising WindowClosed fires on_close exactly once
    (the reference viewer's close → rclcpp::shutdown, image_node.cpp:54-68)."""
    from pointcloud_depthfusion_tpu.nodes.image_node import ImageNode, WindowClosed

    closed = []

    def display(img, ts):
        raise WindowClosed()

    sink = ImageNode(display=display, on_close=lambda: closed.append(1))
    img = np.zeros((4, 4, 3), np.uint8)
    sink(img, 0.0)
    sink(img, 0.1)  # display not called again after close
    assert closed == [1]
    assert sink.closed.is_set()


def test_feeder_lifespan_drops_stale_pairs():
    """QoS 1 s lifespan analogue: pairs older than lifespan_s at dequeue are
    dropped (fusion_node.cpp:183-187)."""
    import time

    from pointcloud_depthfusion_tpu.io.feeder import DeviceFeeder

    cam_l, cam_r, _ = make_rig()
    feeder = DeviceFeeder(cam_l, cam_r, lifespan_s=0.2)
    with feeder:
        first = feeder.get(timeout=10.0)
        assert first is not None
        time.sleep(0.6)  # everything queued before this is now stale
        fresh = feeder.get(timeout=10.0)
        assert fresh is not None
    assert feeder.dropped_stale >= 1
    age = time.perf_counter() - fresh.enqueue_time
    assert age <= 0.6


def test_opencv_display_backend_close_protocol():
    """OpenCVDisplay mirrors image_node.cpp:54-68: imshow pump + visibility
    poll; a closed window raises WindowClosed which fires ImageNode's
    on_close hook (driven with a fake cv2 module — CI is headless)."""
    from pointcloud_depthfusion_tpu.nodes.image_node import (
        ImageNode,
        OpenCVDisplay,
    )

    class FakeCV2:
        WINDOW_AUTOSIZE = 1
        WND_PROP_VISIBLE = 4

        def __init__(self):
            self.shown = []
            self.visible = 1.0
            self.destroyed = []

        def namedWindow(self, name, flags):
            self.window = name

        def imshow(self, name, img):
            self.shown.append(np.asarray(img).copy())

        def waitKey(self, ms):
            return -1

        def getWindowProperty(self, name, prop):
            return self.visible

        def destroyWindow(self, name):
            self.destroyed.append(name)

    fake = FakeCV2()
    disp = OpenCVDisplay(cv2_module=fake)
    closed = []
    node = ImageNode(display=disp, on_close=lambda: closed.append(True))
    img = np.zeros((4, 6, 3), np.uint8)
    img[..., 0] = 200  # red in RGB
    node(img, 0.0)
    assert len(fake.shown) == 1
    # RGB→BGR conversion: red plane must land in the last channel
    assert fake.shown[0][..., 2].max() == 200 and fake.shown[0][..., 0].max() == 0
    # user closes the window → next frame raises → on_close fires once
    fake.visible = 0.0
    node(img, 0.1)
    assert closed == [True]
    assert node.closed.is_set()
    disp.close()
    assert fake.destroyed == ["fused_image"]


def test_opencv_display_headless_error():
    from pointcloud_depthfusion_tpu.nodes.image_node import OpenCVDisplay

    class BrokenCV2:
        WINDOW_AUTOSIZE = 1
        WND_PROP_VISIBLE = 4

        def namedWindow(self, name, flags):
            raise RuntimeError("no display")

    import pytest as _pytest

    disp = OpenCVDisplay(cv2_module=BrokenCV2())
    with _pytest.raises(RuntimeError, match="headless"):
        disp(np.zeros((2, 2, 3), np.uint8), 0.0)


def test_image_node_routes_sink_kind_to_display():
    """Display backends that accept `kind` get one call per sink kind (the
    reference opens one window per callback); plain (image, ts) callables
    keep working unchanged."""
    import numpy as np

    from pointcloud_depthfusion_tpu.nodes.image_node import ImageNode

    seen_kinds = []

    def display_with_kind(image, timestamp, kind=None):
        seen_kinds.append(kind)

    node = ImageNode(display=display_with_kind)
    img = np.zeros((4, 6, 3), np.uint8)
    node(img, 0.1)
    node.on_depth(np.zeros((4, 6), np.uint16), 0.2)
    node.on_image_small(img, 0.3)
    assert seen_kinds == ["fused", "depth", "small"]

    plain_calls = []
    node2 = ImageNode(display=lambda image, ts: plain_calls.append(ts))
    node2(img, 0.5)
    assert plain_calls == [0.5]


def test_async_then_profiling_flip_keeps_publish_order():
    """Toggling profiling on mid-stream (async_readback active) must not
    strand the in-flight frame: timestamps arrive strictly monotonic, and
    the total count matches frames processed."""
    import tempfile

    from pointcloud_depthfusion_tpu.utils.config import ConfigTree

    cam_l, cam_r, _ = make_rig()
    cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                              filter_fused_color=False)
    app = FusionNodeApp(cam_l, cam_r, config=cfg, async_readback=True)
    stamps = []
    app.subscribe_fused(lambda img, ts: stamps.append(ts))
    tree = ConfigTree()
    app.attach_config(tree)
    with tempfile.NamedTemporaryFile(suffix=".csv") as tmp:
        tree.set("profiling.log_path", tmp.name)
        with app.feeder as feeder:
            it = iter(feeder)
            for _ in range(2):  # async mode: frame 0 pending after these
                app.process_pair(next(it))
            tree.set("profiling.enable_profiling", True)  # mode flip
            for _ in range(2):  # profiling (sync) mode
                app.process_pair(next(it))
        app.flush_pending()
    assert len(stamps) == 4
    assert stamps == sorted(stamps), stamps
    assert all(b > a for a, b in zip(stamps, stamps[1:])), stamps


def test_rig_fusion_node_streams_and_recalibrates():
    """RigFusionNodeApp: 3 streaming cameras fuse end-to-end; the per-pair
    RegistrationPipeline sweep calibrates the rig from identity guesses
    (the N-camera analogue of the reference's registration service).

    Runs with the SHIPPED default reg_settings (reg_settings=None):
    discard_transform fitness gating ON, angle_gate OFF. Regression: with
    the stereo angle gate on (|euler_y| < 2°), every converging-rig pair
    solve (~10-15° toe-in yaw) was discarded and the identity start
    transforms collapsed cam_to_virtual onto camera 0 on the first sweep —
    the asserts below would see ang ≈ toe-in, not < 1.5°."""
    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene
    from pointcloud_depthfusion_tpu.nodes.rig_node import RigFusionNodeApp

    n = 3
    w, h = 106, 60
    intr = Intrinsics.create(w, h, fx=80.0, fy=80.0, ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()

    # CONVERGING rig (adjacent frusta overlap like two_camera_rig): camera
    # left of center toes right and vice versa.
    poses = []
    for i in range(n):
        x = 0.4 * (i / (n - 1) - 0.5) * 2
        yaw = np.deg2rad(-15.0 * x / 0.4)
        r = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
             [-np.sin(yaw), 0, np.cos(yaw)]]
        )
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = [x, 0, 0]
        poses.append(m)
    sources = [
        SyntheticSource(scene, intr, poses[i], seed=i + 1) for i in range(n)
    ]

    # Fusion starts from PERTURBED calibration; the registration sweep
    # (which anneals from identity, like the reference service) replaces it.
    def perturb(m, d_yaw, dx):
        r = np.eye(4)
        a = np.deg2rad(d_yaw)
        r[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        r[0, 3] = dx
        return m @ r

    init = np.stack(
        [poses[0]] + [perturb(poses[i], 2.0 * i, 0.03 * i) for i in range(1, n)]
    ).astype(np.float32)

    # reg_settings=None → the shipped default family (cold anneal
    # 0.12 → 0.02, fitness gating on, angle gate off);
    # registration_async=False pins deterministic tick counts.
    app = RigFusionNodeApp(
        sources, intr, init, registration_every=1,
        registration_async=False,
    )
    imgs = []
    app.subscribe_fused(lambda img, ts: imgs.append(img))
    done = app.run(max_frames=5)
    assert done == 5 and len(imgs) == 5
    assert imgs[0].shape == (h, w, 3)
    assert (imgs[-1].sum(-1) > 0).mean() > 0.5
    assert app.registration_ticks == 5

    # Calibrated relative transforms match the ground-truth rig geometry
    # (same tolerance family as the 2-camera convergence test).
    c = app.cam_to_virtual
    for i in range(n - 1):
        t_est = np.linalg.inv(c[i]) @ c[i + 1]
        t_true = np.linalg.inv(poses[i]) @ poses[i + 1]
        d = np.linalg.inv(t_true) @ t_est
        ang = np.degrees(
            np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
        )
        assert ang < 1.5, (i, ang)
        assert np.linalg.norm(d[:3, 3]) < 0.03, (i, d[:3, 3])
    # camera 0 is the anchor: untouched
    np.testing.assert_array_equal(c[0], init[0])


def test_rig_fusion_node_on_mesh():
    """RigFusionNodeApp(mesh=...) streams through the camera-sharded
    path: sharded upload + rig_fuse_sharded, no registration."""
    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        rig_arc_poses,
    )
    from pointcloud_depthfusion_tpu.nodes.rig_node import RigFusionNodeApp
    from pointcloud_depthfusion_tpu.parallel.mesh import make_camera_mesh

    n = 4
    w, h = 64, 48
    intr = Intrinsics.create(w, h, fx=50.0, fy=50.0, ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    poses = rig_arc_poses(n, span=0.8, toe_in_deg_per_m=37.5)
    sources = [
        SyntheticSource(scene, intr, poses[i], seed=i + 1) for i in range(n)
    ]
    app = RigFusionNodeApp(
        sources, intr, np.stack(poses), mesh=make_camera_mesh(n),
    )
    imgs = []
    app.subscribe_fused(lambda img, ts: imgs.append(img))
    done = app.run(max_frames=2)
    assert done == 2
    assert imgs[-1].shape == (h, w, 3)
    assert (imgs[-1].sum(-1) > 0).mean() > 0.5


def test_rig_node_calibration_roundtrip(tmp_path):
    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        rig_arc_poses,
    )
    from pointcloud_depthfusion_tpu.nodes.rig_node import RigFusionNodeApp

    n = 3
    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    scene = SyntheticScene()
    poses = rig_arc_poses(n, toe_in_deg_per_m=37.5)
    sources = [
        SyntheticSource(scene, intr, poses[i], seed=i + 1) for i in range(n)
    ]
    app = RigFusionNodeApp(sources, intr, np.stack(poses))
    path = str(tmp_path / "rig_calibration.txt")
    app.save_calibration(path)
    app2 = RigFusionNodeApp(sources, intr, np.eye(4)[None].repeat(n, 0))
    assert app2.load_calibration(path)
    np.testing.assert_allclose(app2.cam_to_virtual, app.cam_to_virtual,
                               atol=1e-6)
    # corrupt file → state untouched (identity-fallback discipline)
    (tmp_path / "bad.txt").write_text("not a matrix")
    before = app2.cam_to_virtual.copy()
    assert not app2.load_calibration(str(tmp_path / "bad.txt"))
    np.testing.assert_array_equal(app2.cam_to_virtual, before)


def test_rig_node_loaded_calibration_seeds_registration(tmp_path):
    """A LOADED calibration must survive the registration sweep: the pair
    pipelines warm-start from the loaded relative transforms with the cold
    anneal skipped (the reference refines a loaded transform, never
    re-derives it). Covers the lazy pipe build too (registration_every=0
    then a caller-driven registration_tick)."""
    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        rig_arc_poses,
    )
    from pointcloud_depthfusion_tpu.nodes.rig_node import RigFusionNodeApp

    n = 3
    intr = Intrinsics.create(64, 48, fx=50.0, fy=50.0, ppx=32.0, ppy=24.0)
    scene = SyntheticScene()
    poses = rig_arc_poses(n, toe_in_deg_per_m=37.5)
    sources = [
        SyntheticSource(scene, intr, poses[i], seed=i + 1) for i in range(n)
    ]
    app = RigFusionNodeApp(sources, intr, np.stack(poses))
    path = str(tmp_path / "cal.txt")
    app.save_calibration(path)

    # registration enabled at construction → pipes exist BEFORE the load;
    # loading must still re-seed them.
    app2 = RigFusionNodeApp(
        sources, intr, np.eye(4)[None].repeat(n, 0), registration_every=4
    )
    pipes = app2._pair_pipes
    assert pipes is not None
    assert pipes[0].initial_phase  # cold anneal before any load
    assert app2.load_calibration(path)
    c2v = app2.cam_to_virtual.astype(np.float64)
    for i, pipe in enumerate(pipes):
        rel = np.linalg.inv(c2v[i]) @ c2v[i + 1]
        np.testing.assert_allclose(
            pipe.initial_transform, rel.astype(np.float32), atol=1e-6
        )
        assert not pipe.initial_phase  # anneal skipped
        assert pipe._warm_start

    # registration disabled at construction → pipes build lazily on first
    # use and inherit the loaded seed.
    app3 = RigFusionNodeApp(sources, intr, np.eye(4)[None].repeat(n, 0))
    assert app3._pair_pipes is None
    assert app3.load_calibration(path)
    pipes3 = app3._ensure_pair_pipes()
    for i, pipe in enumerate(pipes3):
        rel = np.linalg.inv(c2v[i]) @ c2v[i + 1]
        np.testing.assert_allclose(
            pipe.initial_transform, rel.astype(np.float32), atol=1e-6
        )
        assert not pipe.initial_phase


def test_registration_node_passes_per_frame_depth_scales():
    """The dual registration tier must hand each frame's OWN depth_scale to
    pipeline.tick (its documented contract — a 1e-4 m/LSB sensor deprojects
    10x wrong under the 0.001 default, silently): the depth-image topic
    drops the scale, so the node subscribes framesets."""
    import dataclasses

    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        two_camera_rig,
    )
    from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu.nodes.registration_node import (
        RegistrationNodeApp,
    )

    class ScaledSource(SyntheticSource):
        def next_frame(self):
            fs = super().next_frame()
            return dataclasses.replace(fs, depth_scale=0.0005)

    w, h = 32, 24
    intr = Intrinsics.create(w, h, fx=25.0, fy=25.0, ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig()
    cam_l = CameraNode("camera_left", ScaledSource(scene, intr, wl, seed=1))
    cam_r = CameraNode("camera_right", ScaledSource(scene, intr, wr, seed=2))
    app = RegistrationNodeApp(cam_l, cam_r)
    seen = {}

    def fake_tick(dl, dr, depth_scale_left=None, depth_scale_right=None):
        seen["l"], seen["r"] = depth_scale_left, depth_scale_right
        return np.eye(4, dtype=np.float32)

    app.pipeline.tick = fake_tick
    cam_l.capture()
    cam_r.capture()
    assert app.tick() is not None
    assert seen["l"] == 0.0005 and seen["r"] == 0.0005
