"""End-to-end streaming demo: synthetic rig → registration → fusion → PNGs.

Run: ``python -m pointcloud_depthfusion_tpu.nodes.demo [--frames N]
[--width W --height H] [--out DIR] [--cpu]``

This is the whole reference deployment (two camera nodes, registration
node, fusion node, image node — README.md:14-34) collapsed into one process:
the DDS fabric is the in-process feeder, the 0.5 Hz registration service
runs interleaved, and the fused stream lands as PNG frames + FPS telemetry.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    from pointcloud_depthfusion_tpu.fusion.pipeline import RENDER_MODES

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--width", type=int, default=424)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--out", type=str, default="/tmp/pdf_tpu_demo")
    parser.add_argument("--cpu", action="store_true", help="force CPU backend")
    parser.add_argument("--registration-every", type=int, default=15,
                        help="run a registration tick every N frames")
    parser.add_argument("--vertical", action="store_true", default=True)
    parser.add_argument("--no-vertical", dest="vertical", action="store_false")
    parser.add_argument("--sway", type=float, default=0.0,
                        help="camera sway amplitude in meters (animates the rig)")
    parser.add_argument("--gif", type=str, default="",
                        help="write an animated GIF of the fused stream")
    parser.add_argument("--render-mode", default="",
                        choices=["", *RENDER_MODES],
                        help="override the configured render mode")
    parser.add_argument("--async-readback", action="store_true", default=None,
                        help="overlap frame N's device->host copy with "
                        "frame N+1's compute (publishes one frame late; "
                        "the streaming default — flags override the YAML)")
    parser.add_argument("--no-async-readback", dest="async_readback",
                        action="store_false")
    parser.add_argument("--source-left", default="",
                        help="recorded .npz dataset for the left camera "
                        "(camera_node --out); replaces the synthetic source")
    parser.add_argument("--source-right", default="",
                        help="recorded .npz dataset for the right camera")
    args = parser.parse_args()
    if bool(args.source_left) != bool(args.source_right):
        parser.error("--source-left and --source-right must be given together")

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    from pointcloud_depthfusion_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import (
        NativeSyntheticSource,
        SyntheticSource,
    )
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        two_camera_rig,
    )
    from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu.nodes.image_node import ImageNode
    from pointcloud_depthfusion_tpu.nodes.registration_node import (
        RegistrationNodeApp,
    )
    from pointcloud_depthfusion_tpu.runtime import is_available as native_ok
    from pointcloud_depthfusion_tpu.utils import factory

    w, h = args.width, args.height
    # The BENCHMARK camera model (fx=631 at 848 px, square pixels — same as
    # __graft_entry__._build_fusion), deliberately narrower than
    # core.camera.d455_default_intrinsics (631 at 1280): the demo renders
    # the same workload the bench times.
    fx = 631.0 * w / 848.0
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)

    source_cls = NativeSyntheticSource if native_ok() else SyntheticSource

    def sway(base, phase):
        if args.sway <= 0:
            return None
        import numpy as _np

        def motion(frame_idx):
            m = base.copy()
            t = frame_idx / 30.0
            m[0, 3] += args.sway * _np.sin(0.8 * t + phase)
            m[1, 3] += 0.3 * args.sway * _np.sin(1.3 * t + phase)
            return m

        return motion

    if args.source_left:
        # Recorded playback (rosbag-replay analogue): looped so --frames
        # beyond the recording length keeps streaming; the recording's own
        # calibration replaces the synthetic intrinsics.
        from pointcloud_depthfusion_tpu.io.recorded import RecordedSource

        src_l = RecordedSource(args.source_left, loop=True)
        src_r = RecordedSource(args.source_right, loop=True)
        if src_l.intrinsics.width != src_r.intrinsics.width or (
            src_l.intrinsics.height != src_r.intrinsics.height
        ):
            raise SystemExit("left/right recordings disagree on resolution")
        # (FusionNodeApp/registration read calibration from the camera
        # nodes' handshake, so the recordings' intrinsics flow from the
        # sources themselves.)
        # temporal_filter=False: the recording already carries whatever
        # temporal EMA its capture path applied (CameraNode records the
        # FILTERED stream) — re-filtering on replay would double it.
        cam_left = CameraNode("camera_left", src_l, temporal_filter=False)
        cam_right = CameraNode("camera_right", src_r, temporal_filter=False)
    else:
        cam_left = CameraNode(
            "camera_left",
            source_cls(scene, intr, wl, depth_noise_std=0.002, seed=10,
                       motion=sway(wl, 0.0)),
        )
        cam_right = CameraNode(
            "camera_right",
            source_cls(scene, intr, wr, depth_noise_std=0.002, seed=20,
                       motion=sway(wr, 1.1)),
        )
    cam_left.attach_config(factory.camera_config("camera_left"))
    cam_right.attach_config(factory.camera_config("camera_right"))

    fusion_cfg, fusion_tree = factory.fusion_config()
    fusion_cfg = dataclasses.replace(fusion_cfg, vertical_image=args.vertical)
    if args.render_mode:
        fusion_cfg = dataclasses.replace(fusion_cfg, render_mode=args.render_mode)
    # Streaming defaults (donate/async_readback/qos.lifespan_s) come from
    # the YAML tier; explicit CLI flags override.
    node_kwargs = factory.fusion_node_kwargs_from_tree(fusion_tree)
    if args.async_readback is not None:
        node_kwargs["async_readback"] = args.async_readback
    fusion = FusionNodeApp(cam_left, cam_right, config=fusion_cfg,
                           **node_kwargs)

    reg_settings, reg_tree = factory.registration_settings()
    reg_settings = dataclasses.replace(
        reg_settings,
        resolution=0.02, voxelsize=0.01, initial_resolution=0.12,
        resolution_step=0.05, max_iterations=48,
    )
    registration = RegistrationNodeApp(
        cam_left, cam_right, settings=reg_settings,
        **factory.registration_node_kwargs_from_tree(reg_tree),
    )
    registration.subscribe_transform(fusion.on_transform)

    # Viewer-close → app shutdown (image_node.cpp:54-68): a plugged-in
    # display raising WindowClosed stops the camera loops and the feeder.
    def on_viewer_close():
        cam_left.stop()
        cam_right.stop()
        fusion.feeder.stop()

    sink = ImageNode(out_dir=args.out, every_n=max(1, args.frames // 8),
                     on_close=on_viewer_close)
    fusion.subscribe_fused(sink)
    # The reference viewer's other subscriptions (image_node.cpp:38-109):
    # raw-depth viewer, frameset (color + scaled depth) viewer, small
    # preview — all fed from the left camera node.
    cam_left.subscribe_depth(sink.on_depth)
    cam_left.subscribe_frameset(sink.on_frameset)
    cam_left.subscribe_color_small(sink.on_image_small)
    gif_frames = []
    if args.gif:
        fusion.subscribe_fused(lambda img, ts: gif_frames.append(img.copy()))
    fusion.fps_counter.sink = print

    print(f"devices: {jax.devices()}  output: {args.out}")
    t0 = time.perf_counter()
    frame_times = []
    with fusion.feeder as feeder:
        for i, pair in enumerate(feeder):
            # The fusion feeder pulls through the CameraNodes, whose
            # capture() already publishes filtered depth to the registration
            # service's subscriptions — no manual forwarding here (it would
            # double-push the pairer from two threads).
            if args.registration_every and i % args.registration_every == 0:
                registration.tick()
            t1 = time.perf_counter()
            fusion.process_pair(pair)
            frame_times.append(time.perf_counter() - t1)
            if i + 1 >= args.frames:
                break
    fusion.flush_pending()  # drain the async-readback in-flight frame
    # stop() flushes the registration side effects the YAML may have
    # configured (profiling CSV, save_transform persistence) — without it
    # they are silently dropped at exit.
    registration.stop()
    wall = time.perf_counter() - t0

    if args.gif and gif_frames:
        from PIL import Image  # noqa: PLC0415

        imgs = [Image.fromarray(f) for f in gif_frames]
        imgs[0].save(
            args.gif, save_all=True, append_images=imgs[1:],
            duration=33, loop=0,
        )
        print(f"wrote {args.gif} ({len(imgs)} frames)")

    ms = np.asarray(frame_times[2:]) * 1e3  # skip compile frames
    print(json.dumps({
        "frames": fusion.frames_processed,
        "wall_s": round(wall, 3),
        "fused_ms_p50": round(float(np.percentile(ms, 50)), 3) if len(ms) else None,
        "fused_ms_p95": round(float(np.percentile(ms, 95)), 3) if len(ms) else None,
        "saved_pngs": sink.saved,
        "registration_fitness": registration.pipeline.telemetry[-1].fitness
        if registration.pipeline.telemetry else None,
    }))


if __name__ == "__main__":
    main()
