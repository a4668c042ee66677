"""Fusion node application: wires cameras → feeder → pipeline → sinks.

The application-level equivalent of the reference FusionNode + its DDS
plumbing: fetches calibration via the camera nodes' parameter service,
builds the jitted FusionPipeline, consumes synchronized device pairs from
the DeviceFeeder, listens for registration-transform updates, and publishes
fused frames to subscriber callbacks with FPS/stage telemetry.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import jax
import numpy as np

from pointcloud_depthfusion_tpu.core.camera import (
    camera_info_to_intrinsics,
)
from pointcloud_depthfusion_tpu.fusion.pipeline import (
    FusionConfig,
    FusionPipeline,
    FusionResult,
)
from pointcloud_depthfusion_tpu.io.feeder import (
    ApproximateTimePairer,
    DeviceFeeder,
    DevicePair,
)
from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode
from pointcloud_depthfusion_tpu.utils.profiling import (
    FpsCounter,
    StageLog,
)


class FusionNodeApp:
    def __init__(
        self,
        camera_left: CameraNode,
        camera_right: CameraNode,
        config: Optional[FusionConfig] = None,
        legacy_int_truncation: bool = True,
        max_sync_interval_s: float = 0.017,
        sync_queue_size: int = 10,
        feeder_depth: int = 2,
        profiling_path: Optional[str] = None,
        profiling_log_size: int = 400,
        device: Optional[jax.Device] = None,
        save_data_dir: Optional[str] = None,
        async_readback: bool = False,
        donate: bool = False,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
    ):
        """``async_readback=True`` double-buffers the output side:
        frame N's device→host copy is started asynchronously and published
        while frame N+1 computes — the reference's capture-side
        double-buffer/std::async discipline (camera_node.cpp:315-343) applied
        to the output. Publishing lags one frame (``run()`` drains the last
        frame via :meth:`flush_pending`; callers driving
        :meth:`process_pair` directly must call it themselves); ignored
        while per-stage profiling is on (stage fences serialize everything
        anyway).

        ``donate=True`` donates each frame's depth/color device
        buffers to the fused program — safe here because the DeviceFeeder
        uploads FRESH buffers every frame; keep False if the caller re-uses
        DevicePairs (e.g. processing the same pair twice).

        Both default False (conservative library contract); the streaming
        application tier opts in via configs/fusion_default.yaml
        (donate/async_readback keys, read by utils/factory.py).

        ``lifespan_s``: drop synchronized pairs older than this at dequeue —
        the reference's 1 s QoS message lifespan (fusion_node.cpp:183-187).
        Pass 1.0 for real-time streaming (the demo does); the None default
        keeps finite recorded streams lossless across the first-jit stall."""
        self.camera_left = camera_left
        self.camera_right = camera_right
        self.config = config or FusionConfig.create()

        # Startup handshake (fusion_node.cpp:92-148): fetch calibration.
        params_left = camera_left.get_camera_parameters()
        self.intr_left = camera_info_to_intrinsics(
            params_left.color_info, legacy_int_truncation=legacy_int_truncation
        )
        params_right = camera_right.get_camera_parameters()
        self.intr_right = camera_info_to_intrinsics(
            params_right.color_info, legacy_int_truncation=legacy_int_truncation
        )

        # Pin the align splat-box cap from the CONCRETE handshake intrinsics:
        # inside the jitted pipeline the frameset intrinsics are traced, so
        # "auto" would fall back to the conservative default there.
        if self.config.align_frames and self.config.align_footprint == "auto":
            import dataclasses as _dc

            from pointcloud_depthfusion_tpu.ops.align import auto_footprint

            from pointcloud_depthfusion_tpu.core.camera import Extrinsics

            bound = max(
                auto_footprint(
                    camera_info_to_intrinsics(
                        p.depth_info,
                        legacy_int_truncation=legacy_int_truncation,
                    ),
                    c_intr,
                    Extrinsics.create(
                        np.asarray(p.extrinsic_rotation).reshape(3, 3).T,
                        p.extrinsic_translation,
                    ),
                    min_depth=float(self.config.min_depth),
                )
                for p, c_intr in (
                    (params_left, self.intr_left),
                    (params_right, self.intr_right),
                )
            )
            self.config = _dc.replace(self.config, align_footprint=bound)

        self.pipeline = FusionPipeline(self.intr_left, self.config, donate=donate)
        # Feed THROUGH the camera nodes (they are FramesetSources), not their
        # raw sources: capture() applies the rs2-equivalent temporal filter,
        # which the reference always runs in getFrames (realsense.cpp:398-404).
        self.feeder = DeviceFeeder(
            camera_left,
            camera_right,
            pairer=ApproximateTimePairer(
                max_interval_s=max_sync_interval_s,
                queue_size=sync_queue_size,
            ),
            depth=feeder_depth,
            device=device,
            lifespan_s=lifespan_s,
            pack_color=pack_color,
        )
        self._fused_subs: List[Callable[[np.ndarray, float], None]] = []
        self._sync_debug_subs: List[Callable[[str], None]] = []
        self.fps_counter = FpsCounter(name="fusion/fps")
        self.stage_log = (
            StageLog(profiling_path, log_size=profiling_log_size)
            if profiling_path else None
        )
        self._transform_lock = threading.Lock()
        self.frames_processed = 0
        self.save_data_dir = save_data_dir
        self.async_readback = async_readback
        # (result, stamp, pair, frame_index) awaiting async readback
        self._pending: Optional[tuple] = None
        self._last_sync_time: Optional[float] = None

    # -- dynamic reconfiguration ------------------------------------------

    def attach_config(self, cfg) -> None:
        """Wire a ConfigTree for RUNTIME debug/profiling reconfiguration.

        The reference dispatches ``debug.*`` / ``profiling.*`` parameter
        updates while the node runs (parametersCallback, config.cpp:118-137);
        here ``cfg.set("debug.save_data", True)`` starts dumping artifact
        PNGs mid-stream and ``profiling.enable_profiling`` switches the
        split-program stage-timing mode on/off between frames.
        """
        self.node_config = cfg
        default_dir = self.save_data_dir or "fusion_debug"
        if bool(cfg.declare("debug.save_data", self.save_data_dir is not None)):
            self.save_data_dir = str(
                cfg.declare("debug.save_data_dir", default_dir)
            )
        else:
            cfg.declare("debug.save_data_dir", default_dir)
        self.fps_counter.publish = bool(
            cfg.declare("profiling.publish_fps", self.fps_counter.publish)
        )
        prof_path = str(
            cfg.declare(
                "profiling.log_path",
                self.stage_log.path if self.stage_log else "fusion_profiling.csv",
            )
        )
        if bool(cfg.declare(
            "profiling.enable_profiling", self.stage_log is not None
        )) and self.stage_log is None:
            self.stage_log = StageLog(prof_path)

        def on_change(key: str, value) -> None:
            truthy = CameraNode._coerce_option(True, value)
            if key == "debug.save_data":
                self.save_data_dir = (
                    str(self.node_config.get("debug.save_data_dir", default_dir))
                    if truthy else None
                )
            elif key == "debug.save_data_dir":
                if self.save_data_dir is not None:
                    self.save_data_dir = str(value)
            elif key == "profiling.enable_profiling":
                if truthy and self.stage_log is None:
                    self.stage_log = StageLog(
                        str(self.node_config.get("profiling.log_path", prof_path))
                    )
                elif not truthy and self.stage_log is not None:
                    self.stage_log.flush()
                    self.stage_log = None
            elif key == "profiling.publish_fps":
                self.fps_counter.publish = truthy

        cfg.on_change(on_change)

    # -- topic-equivalents -------------------------------------------------

    def subscribe_fused(self, cb: Callable[[np.ndarray, float], None]) -> None:
        """Subscribe to /fused_image-equivalent output (rgb8 ndarray + stamp)."""
        self._fused_subs.append(cb)

    def on_transform(self, transform: np.ndarray) -> None:
        """/registration/transform update (transformCallback)."""
        with self._transform_lock:
            self.pipeline.set_right_transform(np.asarray(transform, np.float32))

    def subscribe_sync_debug(self, cb: Callable[[str], None]) -> None:
        """Subscribe to /fusion_sync_debug-style strings
        (fusion_node.cpp:674-698: sync cadence, stamp skew, latency)."""
        self._sync_debug_subs.append(cb)

    def _publish_sync_debug(self, pair: DevicePair) -> None:
        if not self._sync_debug_subs:
            return
        import time as _time

        now = _time.perf_counter()
        sync_ms = (
            (now - self._last_sync_time) * 1e3 if self._last_sync_time else 0.0
        )
        self._last_sync_time = now
        diff_ms = (pair.host_left.timestamp - pair.host_right.timestamp) * 1e3
        fps = 1000.0 / sync_ms if sync_ms > 0 else 0.0
        msg = (
            f"sync callback: {sync_ms:.2f} ms, {fps:.2f} fps, "
            f"diff: {diff_ms:.2f}, dropped: {self.feeder.pairer.dropped}"
        )
        for cb in self._sync_debug_subs:
            cb(msg)

    def _save_data(
        self, pair: DevicePair, image: np.ndarray, index: Optional[int] = None
    ) -> None:
        """save_data artifact dumps (depth/color inputs + fused output),
        like the reference's debug PNG path (depth_frame.cpp:201-228)."""
        from pointcloud_depthfusion_tpu.io.artifacts import save_png  # noqa: PLC0415
        import os  # noqa: PLC0415

        i = self.frames_processed if index is None else index
        d = self.save_data_dir
        save_png(os.path.join(d, f"{i:06d}_left_depth.png"), pair.host_left.depth)
        save_png(os.path.join(d, f"{i:06d}_left_color.png"), pair.host_left.color)
        save_png(os.path.join(d, f"{i:06d}_right_depth.png"), pair.host_right.depth)
        save_png(os.path.join(d, f"{i:06d}_right_color.png"), pair.host_right.color)
        save_png(os.path.join(d, f"{i:06d}_fused.png"), image)

    # -- steady state ------------------------------------------------------

    def process_pair(self, pair: DevicePair) -> FusionResult:
        import time as _time

        t_loop = _time.perf_counter()
        self._publish_sync_debug(pair)
        profiling = self.stage_log is not None
        if self._pending is not None and (profiling or not self.async_readback):
            # A mode flip mid-stream (profiling toggled on via attach_config,
            # or async_readback turned off) must not strand the in-flight
            # async frame: publish it FIRST, or flush_pending() at
            # end-of-run would emit it AFTER younger frames (subscribers
            # would see a time-travelling frame).
            prev, self._pending = self._pending, None
            self._publish_ready(prev)
        laps = {}
        if profiling:
            # Split-program profiling mode: the fused pipeline has no
            # internal boundaries, so measure the real per-stage times on
            # sub-programs with device fences (the reference's getTiming
            # discipline, fusion_node.cpp:620-631).
            laps["callback"] = (_time.perf_counter() - t_loop) * 1e3
            with self._transform_lock:
                result, stage_laps, image = self.pipeline.process_profiled(
                    pair.left, pair.right
                )
            laps.update(stage_laps)
        elif self.async_readback:
            with self._transform_lock:
                result = self.pipeline.process(pair.left, pair.right)
            try:
                result.image.copy_to_host_async()  # start D2H of frame N
            except AttributeError:  # backend without async copies
                pass
            prev, self._pending = self._pending, (
                result, float(pair.host_left.timestamp), pair,
                self.frames_processed,
            )
            self.frames_processed += 1
            if prev is not None:
                self._publish_ready(prev)
            self.fps_counter.tick()
            return result
        else:
            with self._transform_lock:
                result = self.pipeline.process(pair.left, pair.right)
            image = np.asarray(result.image)  # D2H fence
        stamp = float(pair.host_left.timestamp)
        t_pub = _time.perf_counter()
        for cb in self._fused_subs:
            cb(image, stamp)
        if profiling:
            laps["publish"] = (_time.perf_counter() - t_pub) * 1e3
            laps["diff"] = abs(
                pair.host_left.timestamp - pair.host_right.timestamp
            ) * 1e3
            laps["copy_to_gpu"] = pair.upload_ms
            # frame age at publish time (the reference's latency field) —
            # only meaningful for wall-clock-stamped sources.
            age_s = _time.time() - stamp
            if 0.0 <= age_s < 3600.0:
                laps["latency"] = age_s * 1e3
        if self.save_data_dir:
            self._save_data(pair, image)
        self.fps_counter.tick()
        if self.stage_log:
            laps["loop"] = (_time.perf_counter() - t_loop) * 1e3
            self.stage_log.add(laps)
        self.frames_processed += 1
        return result

    def _publish_ready(self, pending: tuple) -> None:
        """Publish a frame whose async D2H has had a frame of compute to
        overlap (the fence lands here, one frame late)."""
        result, stamp, pair, index = pending
        image = np.asarray(result.image)
        for cb in self._fused_subs:
            cb(image, stamp)
        if self.save_data_dir:
            self._save_data(pair, image, index=index)

    def flush_pending(self) -> None:
        """Publish the last in-flight frame (end-of-stream drain)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._publish_ready(pending)

    def run(self, max_frames: Optional[int] = None) -> int:
        """Consume the feeder until end-of-stream (or max_frames)."""
        with self.feeder as feeder:
            for pair in feeder:
                self.process_pair(pair)
                if max_frames is not None and self.frames_processed >= max_frames:
                    break
        self.flush_pending()
        if self.stage_log:
            self.stage_log.flush()
        return self.frames_processed
