"""One-command deployment composition — the ``ros2 launch`` equivalent.

The reference stands up its distributed system from launch files that
compose camera/fusion/registration/image nodes with YAML parameter
overrides (camera_node/launch/camera_left.launch.py:19-28,
fusion_node/launch/standalone.launch.py). This module is that capability
for this framework: ONE manifest describes every node of a deployment —
N camera sources (local synthetic, recorded ``.npz`` replays, or
``tcp://`` remote camera hosts), the fusion tier (dual-camera FusionNodeApp
or N-camera RigFusionNodeApp), the registration service cadence, and the
viewer sink — and ``pdf-tpu-launch --deployment file.yaml`` runs it.

Manifest schema (all sections optional except ``cameras``)::

    deployment:
      width: 424            # synthetic-source resolution
      height: 240
      frames: 60            # stop after N fused frames (0 = until EOS)
      cameras:
        - name: camera_left
          source: synthetic         # synthetic | tcp://host:port | /x.npz
          seed: 10                  # synthetic only
          pose: left                # left | right (two_camera_rig), an
                                    # index into rig_arc_poses, or
                                    # [tx, ty, tz, yaw_deg]
          config: cam_override.yaml # camera_default.yaml override tier
          serve: 127.0.0.1:0        # ALSO publish this camera over TCP
                                    # (the cross-machine hop; port 0 = any)
        - name: camera_right
          source: synthetic
          seed: 20
          pose: right
      fusion:
        config: fusion_override.yaml   # fusion_default.yaml override tier
      registration:
        every_n_frames: 15             # 0 disables the service
        config: reg_override.yaml      # registration_default.yaml override
      viewer:
        out_dir: /tmp/pdf_launch       # PNG sink (ImageNode)
        every_n: 8

Two cameras compose the reference's exact topology (capture ×2 →
ApproximateTime sync → fusion + 0.5 Hz-style registration → viewer);
three or more compose the N-camera rig tier (RigFusionNodeApp with
per-adjacent-pair calibration sweeps).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np


def load_manifest(path: str) -> dict:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    manifest = doc.get("deployment", doc) if isinstance(doc, dict) else doc
    if not isinstance(manifest, dict) or "cameras" not in manifest:
        raise ValueError(
            f"{path}: manifest needs a 'deployment:' mapping with a "
            "'cameras:' list"
        )
    return manifest


class _TeeSource:
    """FramesetSource view of a CameraNode's published frameset stream.

    A manifest camera with ``serve:`` is consumed TWICE — by the local
    fusion feeder and by the TCP server. Pulling the CameraNode from both
    would steal alternating frames from each consumer and race the
    temporal-filter state across threads; instead the server reads this
    tee, fed by the camera's publish fan-out (every frame the LOCAL
    consumer captures reaches both — the reference's one-capture-loop,
    many-subscribers shape, camera_node.cpp:338-343). Bounded keep-last
    queue: a stalled/slow remote client drops oldest, never stalls local
    capture."""

    def __init__(self, cam, depth: int = 4):
        import queue as _queue
        import threading as _threading

        self._q: "_queue.Queue" = _queue.Queue(depth)
        self._closed = _threading.Event()
        self.intrinsics = cam.intrinsics
        cam.subscribe_frameset(self._on_frame)

    def _on_frame(self, fs) -> None:
        while True:
            try:
                self._q.put_nowait(fs)
                return
            except Exception:  # Full: drop oldest (keep-last QoS)
                try:
                    self._q.get_nowait()
                except Exception:
                    pass

    def next_frame(self):
        import queue as _queue

        while not self._closed.is_set():
            try:
                return self._q.get(timeout=0.2)
            except _queue.Empty:
                continue
        return None

    def close(self) -> None:
        self._closed.set()


def _camera_pose(spec, index: int, n: int):
    """Resolve a manifest pose entry to a 4×4 world_from_camera matrix."""
    from pointcloud_depthfusion_tpu.io.synthetic import (
        rig_arc_poses,
        two_camera_rig,
    )

    pose = spec.get("pose", index)
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    if isinstance(pose, str):
        if pose == "left":
            return wl
        if pose == "right":
            return wr
        raise ValueError(f"camera pose {pose!r}: use left/right, an index, "
                         "or [tx, ty, tz, yaw_deg]")
    if isinstance(pose, (list, tuple)):
        tx, ty, tz, yaw_deg = (float(v) for v in pose)
        yaw = np.deg2rad(yaw_deg)
        m = np.eye(4)
        m[:3, :3] = [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                     [-np.sin(yaw), 0, np.cos(yaw)]]
        m[:3, 3] = [tx, ty, tz]
        return m
    # integer index: 2 cameras → the reference's stereo rig; more → a
    # CONVERGING arc (adjacent frusta overlap, which the per-pair
    # registration sweeps need — the diverging bench fan does not).
    if n == 2:
        return (wl, wr)[int(pose)]
    return rig_arc_poses(n, span=0.8, toe_in_deg_per_m=37.5)[int(pose)]


def _build_camera(spec: dict, index: int, n: int, width: int, height: int,
                  servers: list):
    """One manifest camera entry → a CameraNode (+ optional TCP server)."""
    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import (
        NativeSyntheticSource,
        SyntheticSource,
    )
    from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene
    from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu.runtime import is_available as native_ok
    from pointcloud_depthfusion_tpu.utils import factory

    name = spec.get("name", f"camera_{index}")
    kind = str(spec.get("source", "synthetic"))
    pose = _camera_pose(spec, index, n) if kind == "synthetic" else None
    temporal = True
    if kind.startswith("tcp://"):
        from pointcloud_depthfusion_tpu.io.network import NetworkSource

        host, _, port = kind[len("tcp://"):].partition(":")
        source = NetworkSource(host, int(port or 7447))
    elif kind != "synthetic":
        # A path: recorded dataset replay. The recording already carries
        # its capture path's temporal EMA — re-filtering would double it.
        from pointcloud_depthfusion_tpu.io.recorded import RecordedSource

        source = RecordedSource(kind, loop=True)
        temporal = False
    else:
        fx = 631.0 * width / 848.0
        intr = Intrinsics.create(width, height, fx=fx, fy=fx,
                                 ppx=width / 2, ppy=height / 2)
        cls = NativeSyntheticSource if native_ok() else SyntheticSource
        source = cls(
            SyntheticScene(), intr, pose,
            depth_noise_std=float(spec.get("depth_noise_std", 0.002)),
            seed=int(spec.get("seed", 10 * (index + 1))),
        )

    cam = CameraNode(name, source, temporal_filter=temporal)
    cam.attach_config(factory.camera_config(name, spec.get("config")))
    # Synthetic sources know their true world pose — the rig tier seeds
    # its cam_to_virtual calibration from these when EVERY camera has one
    # (tcp/recorded deployments start at identity and calibrate via the
    # per-pair registration sweeps instead).
    cam.launch_pose = pose

    serve = spec.get("serve")
    if serve:
        # Cross-machine hop: publish this camera's framesets over TCP so a
        # remote manifest can consume it as source: tcp://host:port. The
        # server reads a subscription TEE, not the CameraNode itself — the
        # node is already pulled by the local fusion feeder, and two
        # pullers would steal alternating frames from each other.
        from pointcloud_depthfusion_tpu.io.network import FramesetStreamServer

        host, _, port = str(serve).partition(":")
        srv = FramesetStreamServer(_TeeSource(cam), host=host or "127.0.0.1",
                                   port=int(port or 0), name=name)
        srv.start()
        servers.append(srv)
    return cam


def run_deployment(manifest: dict, cpu: bool = False,
                   frames: Optional[int] = None) -> dict:
    """Stand up every node in the manifest, run, and return a summary."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")

    from pointcloud_depthfusion_tpu.nodes.image_node import ImageNode
    from pointcloud_depthfusion_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    width = int(manifest.get("width", 424))
    height = int(manifest.get("height", 240))
    max_frames = frames if frames is not None else int(
        manifest.get("frames", 0)
    )
    cam_specs = manifest["cameras"]
    if len(cam_specs) < 2:
        raise ValueError("a deployment needs at least 2 cameras")

    servers: list = []
    fused = []
    t0 = time.perf_counter()
    # The try covers CONSTRUCTION too: a camera that raises mid-build
    # (unreachable tcp:// peer, bad recording path) must not leak the TCP
    # servers earlier cameras already bound and started.
    try:
        cameras = [
            _build_camera(spec, i, len(cam_specs), width, height, servers)
            for i, spec in enumerate(cam_specs)
        ]

        fusion_section = manifest.get("fusion") or {}
        reg_section = manifest.get("registration") or {}
        reg_every = int(reg_section.get("every_n_frames", 15))
        viewer_section = manifest.get("viewer") or {}

        sink = None
        if viewer_section.get("out_dir"):
            sink = ImageNode(out_dir=str(viewer_section["out_dir"]),
                             every_n=int(viewer_section.get("every_n", 8)))

        if len(cameras) == 2:
            frames_done, reg_ticks, reg_fitness = _run_dual(
                cameras, fusion_section, reg_section, reg_every, sink,
                fused, max_frames,
            )
        else:
            frames_done, reg_ticks, reg_fitness = _run_rig(
                cameras, fusion_section, reg_every, sink, fused,
                max_frames,
            )
    finally:
        for srv in servers:
            # Close the tee FIRST: its producer thread is otherwise blocked
            # polling for frames that stopped arriving (the local run
            # ended), and srv.stop() would burn its full join timeout per
            # served camera and leak a spinning daemon thread.
            close = getattr(srv.source, "close", None)
            if close is not None:
                close()
            srv.stop()
    wall = time.perf_counter() - t0

    summary = {
        "cameras": len(cameras),
        "tier": "dual" if len(cameras) == 2 else "rig",
        "frames": frames_done,
        "published": len(fused),
        "wall_s": round(wall, 3),
        "fused_shape": list(fused[-1].shape) if fused else None,
        "fused_coverage": round(
            float((fused[-1].sum(-1) > 0).mean()), 3
        ) if fused else None,
        "registration_ticks": reg_ticks,
        "registration_fitness": reg_fitness,
        "saved_pngs": sink.saved if sink else 0,
        "served_ports": [srv.port for srv in servers],
    }
    return summary


def _run_dual(cameras, fusion_section, reg_section, reg_every, sink, fused,
              max_frames):
    from pointcloud_depthfusion_tpu.nodes.fusion_node import FusionNodeApp
    from pointcloud_depthfusion_tpu.nodes.registration_node import (
        RegistrationNodeApp,
    )
    from pointcloud_depthfusion_tpu.utils import factory

    fusion_cfg, fusion_tree = factory.fusion_config(
        fusion_section.get("config")
    )
    node_kwargs = factory.fusion_node_kwargs_from_tree(fusion_tree)
    fusion = FusionNodeApp(cameras[0], cameras[1], config=fusion_cfg,
                           **node_kwargs)
    fusion.subscribe_fused(lambda img, ts: fused.append(img))
    if sink is not None:
        fusion.subscribe_fused(sink)

    registration = None
    if reg_every:
        reg_settings, reg_tree = factory.registration_settings(
            reg_section.get("config")
        )
        registration = RegistrationNodeApp(
            cameras[0], cameras[1], settings=reg_settings,
            **factory.registration_node_kwargs_from_tree(reg_tree),
        )
        registration.subscribe_transform(fusion.on_transform)

    done = ticks = 0
    with fusion.feeder as feeder:
        for i, pair in enumerate(feeder):
            if registration is not None and i % reg_every == 0:
                registration.tick()
                ticks += 1
            fusion.process_pair(pair)
            done += 1
            if max_frames and done >= max_frames:
                break
    fusion.flush_pending()
    fitness = None
    if registration is not None:
        registration.stop()
        if registration.pipeline.telemetry:
            fitness = float(registration.pipeline.telemetry[-1].fitness)
    return done, ticks, fitness


def _run_rig(cameras, fusion_section, reg_every, sink, fused, max_frames):
    from pointcloud_depthfusion_tpu.nodes.rig_node import RigFusionNodeApp
    from pointcloud_depthfusion_tpu.utils import factory

    n = len(cameras)
    config = None
    if fusion_section.get("config"):
        config, _ = factory.fusion_config(fusion_section["config"])
    # PER-CAMERA intrinsics: heterogeneous rigs (tcp:// remotes each hand
    # their own fx/ppx through the handshake) must not silently deproject
    # cameras 1..N-1 with camera 0's calibration.
    intrs = [c.intrinsics for c in cameras]
    # Initial calibration: synthetic manifests seed the true source poses
    # (cam→world == cam→virtual for the world-frame virtual camera); live
    # tcp/recorded deployments start at identity and calibrate through the
    # per-pair registration sweeps.
    poses = [getattr(c, "launch_pose", None) for c in cameras]
    if all(p is not None for p in poses):
        initial = np.stack(poses).astype(np.float32)
    else:
        initial = np.eye(4)[None].repeat(n, 0)
    app = RigFusionNodeApp(
        cameras, intrs, initial,
        config=config,
        registration_every=reg_every,
        registration_async=False,  # deterministic frame counts
    )
    app.subscribe_fused(lambda img, ts: fused.append(img))
    if sink is not None:
        app.subscribe_fused(lambda img, ts: sink(img, ts[0]))
    done = app.run(max_frames=max_frames or None)
    return done, app.registration_ticks, None


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--deployment", required=True,
                        help="YAML manifest (see module docstring)")
    parser.add_argument("--frames", type=int, default=None,
                        help="override the manifest's frame bound")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    manifest = load_manifest(args.deployment)
    summary = run_deployment(manifest, cpu=args.cpu, frames=args.frames)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
