"""Live RealSense capture → TCP frameset stream (camera-host bridge).

The fusion host need not have a USB camera stack, so live capture runs on the machine the
sensor is plugged into (the reference's Jetson role, realsense.cpp:57-444)
and streams framesets to the fusion host over `io/network.py`. This module
is that bridge: it drives a RealSense through pyrealsense2 — device
discovery by serial, the reference's stream presets, align-to-color, the
active temporal filter, hardware→system clock rebase — and serves the
result with :class:`FramesetStreamServer`.

Run ON THE CAMERA HOST (needs `pyrealsense2`, which is deliberately NOT a
dependency of this package — the import is guarded):

    python -m pointcloud_depthfusion_tpu.io.realsense_host \
        --name camera_left --port 7447 [--serial <S>] [--model D455]

On the fusion host, consume with ``camera_node --source tcp://camerahost:7447``
or a :class:`~pointcloud_depthfusion_tpu.io.network.NetworkSource`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from pointcloud_depthfusion_tpu.core.camera import (
    Distortion,
    Extrinsics,
    Intrinsics,
    model_preset,
)
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu.io.feeder import FramesetSource

# rs2 distortion enum → our Distortion (rs.distortion values are stable).
_RS_DISTORTION = {
    0: Distortion.NONE,  # none
    1: Distortion.MODIFIED_BROWN_CONRADY,
    2: Distortion.INVERSE_BROWN_CONRADY,
    3: Distortion.FTHETA,
    4: Distortion.BROWN_CONRADY,
    5: Distortion.KANNALA_BRANDT4,
}


def _require_rs2():
    try:
        import pyrealsense2 as rs  # noqa: PLC0415
    except ImportError as exc:  # pragma: no cover - sensor-host only
        raise RuntimeError(
            "pyrealsense2 is not installed — this bridge runs on the "
            "CAMERA host (with the RealSense SDK), not on the fusion host; "
            "install librealsense2 + pyrealsense2 there"
        ) from exc
    return rs


class RealsenseSource(FramesetSource):
    """FramesetSource over a live RealSense device (pyrealsense2).

    Reproduces the reference capture behavior (realsense.cpp):
      * device discovery by serial, first device otherwise (:57-110);
      * stream preset per model — D455/D435/D415 1280×720 Z16+RGB8 @30,
        L515 1024×768 depth (:226-236) — via core.camera.model_preset;
      * align-to-color per frame (:239, :373-376);
      * ONLY the temporal filter active in the hot loop (:398-404);
      * hardware-clock → system-clock timestamp rebase at start
        (:318-334, :424-431);
      * four warm-up grabs (camera_node.cpp:166-169).
    """

    def __init__(
        self,
        serial: str = "",
        model: str = "D455",
        fps: Optional[float] = None,
        width: int = 0,
        height: int = 0,
        warmup_frames: int = 4,
        timeout_ms: int = 5000,
    ):  # pragma: no cover - requires a physical sensor
        rs = _require_rs2()
        preset = model_preset(model)
        cw, ch = preset["color_size"]
        dw, dh = preset["depth_size"]
        if width:
            cw = dw = width
        if height:
            ch = dh = height
        self.fps = float(fps or preset["fps"])
        self.timeout_ms = timeout_ms

        ctx = rs.context()
        devices = ctx.query_devices()
        if len(devices) == 0:
            raise RuntimeError("no RealSense device connected")
        if serial:
            if serial not in {
                d.get_info(rs.camera_info.serial_number) for d in devices
            }:
                raise RuntimeError(f"RealSense serial {serial} not found")

        self._cfg = rs.config()
        if serial:
            self._cfg.enable_device(serial)
        self._cfg.enable_stream(
            rs.stream.depth, dw, dh, rs.format.z16, int(self.fps)
        )
        self._cfg.enable_stream(
            rs.stream.color, cw, ch, rs.format.rgb8, int(self.fps)
        )
        self._pipe = rs.pipeline(ctx)
        profile = self._pipe.start(self._cfg)

        self._align = rs.align(rs.stream.color)
        self._temporal = rs.temporal_filter()

        dev = profile.get_device()
        self.depth_scale = float(
            dev.first_depth_sensor().get_depth_scale()
        )

        # Aligned depth shares the COLOR stream profile (:670-680).
        vsp = profile.get_stream(rs.stream.color).as_video_stream_profile()
        ci = vsp.get_intrinsics()
        self._intr = Intrinsics.create(
            ci.width, ci.height, fx=ci.fx, fy=ci.fy, ppx=ci.ppx, ppy=ci.ppy,
            model=_RS_DISTORTION.get(int(ci.model), Distortion.NONE),
            coeffs=list(ci.coeffs),
        )
        # Aligned output ⇒ depth is already in the color frame; identity
        # extrinsics, exactly like the reference's aligned path.
        self.depth_to_color = Extrinsics.identity()

        # HW-clock → system-clock rebase (:318-334).
        frames = self._pipe.wait_for_frames(self.timeout_ms)
        self._clock_offset = time.time() - (
            frames.get_timestamp() / 1e3
        )
        for _ in range(max(0, warmup_frames - 1)):
            self._pipe.wait_for_frames(self.timeout_ms)

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    def next_frame(self) -> Optional[HostFrameset]:  # pragma: no cover
        # Bounded retry over partial framesets (one stream missing after
        # align — common transiently under USB pressure): a SKIP, never a
        # None — None would make FramesetStreamServer send its clean
        # end-sentinel and the remote fusion host would shut down
        # mid-capture with zero diagnostic while the sensor is healthy
        # (the silent-EOS trap io/network.py raises TimeoutError to avoid).
        for _ in range(64):
            try:
                frames = self._pipe.wait_for_frames(self.timeout_ms)
            except RuntimeError as exc:
                # RAISE, never return None: a live sensor has no natural
                # end of stream, so every wait_for_frames RuntimeError
                # (capture timeout, USB stall, device disconnect) is a
                # FAILURE.
                raise TimeoutError(
                    f"RealSense capture failed after {self.timeout_ms} ms "
                    f"({exc}) — sensor stalled or disconnected"
                ) from exc
            frames = self._align.process(frames)
            depth = frames.get_depth_frame()
            color = frames.get_color_frame()
            if depth and color:
                break
        else:
            raise TimeoutError(
                "RealSense delivered 64 consecutive partial framesets "
                "(missing depth or color after align) — sensor failing"
            )
        depth = self._temporal.process(depth)
        stamp = frames.get_timestamp() / 1e3 + self._clock_offset
        return HostFrameset(
            depth=np.asanyarray(depth.get_data()).copy(),
            color=np.asanyarray(color.get_data()).copy(),
            timestamp=stamp,
            depth_scale=self.depth_scale,
        )

    def stop(self) -> None:  # pragma: no cover
        self._pipe.stop()


def main() -> None:  # pragma: no cover - requires a physical sensor
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--name", default="camera_left")
    parser.add_argument("--serial", default="")
    parser.add_argument("--model", default="D455")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7447)
    parser.add_argument("--fps", type=float, default=0.0)
    parser.add_argument("--width", type=int, default=0,
                        help="override the model preset's stream width")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--warmup-frames", type=int, default=4)
    parser.add_argument("--timeout-ms", type=int, default=5000)
    parser.add_argument(
        "--codec", default="png", choices=["png", "raw"],
        help="frame codec: 'png' (compressed — thin links) or 'raw' (zero "
        "encode cost on this camera host — wired-LAN deployments; a "
        "720p@30 stream's per-frame PNG encode can exceed the 33 ms "
        "budget on Jetson-class hosts and silently halve the delivered "
        "rate via the drop-oldest QoS)",
    )
    args = parser.parse_args()

    from pointcloud_depthfusion_tpu.io.network import FramesetStreamServer

    source = RealsenseSource(
        serial=args.serial, model=args.model, fps=args.fps or None,
        width=args.width, height=args.height,
        warmup_frames=args.warmup_frames, timeout_ms=args.timeout_ms,
    )
    server = FramesetStreamServer(
        source, host=args.host, port=args.port, name=args.name,
        fps=source.fps, depth_to_color=source.depth_to_color,
        codec=args.codec,
    )
    server.start()
    print(f"{args.name}: RealSense → tcp://{server.host}:{server.port} "
          f"({args.codec})")
    try:
        while True:
            time.sleep(5)
            print(f"sent {server.frames_sent} dropped {server.frames_dropped}")
    except KeyboardInterrupt:
        pass
    finally:
        # Stop on ANY exit path (not just ^C): a crashed status loop must
        # still release the sensor pipeline and close the client socket.
        server.stop()
        source.stop()


if __name__ == "__main__":
    main()
