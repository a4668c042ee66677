"""Camera node: frameset acquisition + calibration service.

Equivalent of the reference camera_node (camera_node/src/camera_node.cpp):
wraps a FramesetSource (synthetic/recorded/tcp://; live capture runs on
camera hosts, io/realsense_host.py), serves camera parameters (the GetCameraParameters service,
camera_node.cpp:377-386), publishes framesets and depth images to
subscribers, and reports FPS. Runs pull-based inside a DeviceFeeder or
push-based via :meth:`spin` on a thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from pointcloud_depthfusion_tpu.core.camera import (
    CameraInfo,
    Extrinsics,
    Intrinsics,
)
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu.io.feeder import FramesetSource
from pointcloud_depthfusion_tpu.ops import filters as F
from pointcloud_depthfusion_tpu.utils.profiling import FpsCounter


@dataclasses.dataclass
class CameraParameters:
    """GetCameraParameters response (GetCameraParameters.srv:1-10)."""

    depth_info: CameraInfo
    color_info: CameraInfo
    extrinsic_rotation: np.ndarray  # (9,) column-major
    extrinsic_translation: np.ndarray  # (3,)


class CameraNode(FramesetSource):
    """One camera's acquisition pipeline.

    Also a :class:`FramesetSource` itself (``next_frame`` → :meth:`capture`)
    so composed applications (FusionNodeApp's DeviceFeeder) pull through the
    node and get its rs2-equivalent post-processing — the reference always
    runs the temporal filter inside getFrames (realsense.cpp:398-404), so
    feeding from the raw source would silently skip it.
    """

    # The reflected depth-sensor option set: every attribute here becomes a
    # ``sensor.depth.<name>`` parameter (declare + runtime dispatch), the
    # equivalent of the reference's declareRosParameters sweep over the
    # RealSense option list (realsense.cpp:608-664).
    DEPTH_OPTIONS = (
        "temporal_filter", "temporal_alpha", "temporal_delta",
        "decimation_filter", "decimation_magnitude",
        "spatial_filter", "spatial_alpha", "spatial_delta",
        "spatial_magnitude",
        "disparity_domain", "stereo_baseline_m",
        "threshold_filter", "threshold_min_m", "threshold_max_m",
        "hole_filling", "hole_fill_mode",
    )
    # Color-stream options, reflected as ``sensor.color.*`` (the reference's
    # small-preview geometry, camera_node config.hpp:101-102: 608×608).
    COLOR_OPTIONS = ("small_image_width", "small_image_height")

    def __init__(
        self,
        name: str,
        source: FramesetSource,
        depth_to_color: Optional[Extrinsics] = None,
        fps: float = 30.0,
        temporal_filter: bool = True,
        temporal_alpha: float = 0.4,
        temporal_delta: float = 20.0,
        decimation_filter: bool = False,
        decimation_magnitude: int = 2,
        spatial_filter: bool = False,
        spatial_alpha: float = 0.55,
        spatial_delta: float = 20.0,
        spatial_magnitude: int = 2,
        disparity_domain: bool = False,
        stereo_baseline_m: float = 0.095,
        threshold_filter: bool = False,
        threshold_min_m: float = 0.0,
        threshold_max_m: float = 2.0,
        hole_filling: bool = False,
        hole_fill_mode: str = "farthest",
        small_image_width: int = 608,
        small_image_height: int = 608,
    ):
        """The full rs2 post-processing bank is available; defaults mirror
        the reference's ACTIVE set (only the temporal filter runs in
        getFrames, realsense.cpp:398-404) while the construction-time
        parameterization of the others (decimation magnitude 2, spatial
        alpha 0.55, threshold 0-2 m, hole fill mode 1, disparity transforms;
        realsense.cpp:239-250) provides their defaults here. Filter order
        when enabled follows the librealsense recommendation: decimation →
        threshold → depth-to-disparity → spatial → temporal →
        disparity-to-depth → hole filling.
        """
        self.name = name
        self.source = source
        self.fps = fps
        self.depth_to_color = depth_to_color or Extrinsics.identity()
        self.temporal_filter = temporal_filter
        self.temporal_alpha = temporal_alpha
        self.temporal_delta = temporal_delta
        self.decimation_filter = decimation_filter
        self.decimation_magnitude = decimation_magnitude
        self.spatial_filter = spatial_filter
        self.spatial_alpha = spatial_alpha
        self.spatial_delta = spatial_delta
        self.spatial_magnitude = spatial_magnitude
        self.disparity_domain = disparity_domain
        self.stereo_baseline_m = stereo_baseline_m
        self.threshold_filter = threshold_filter
        self.threshold_min_m = threshold_min_m
        self.threshold_max_m = threshold_max_m
        self.hole_filling = hole_filling
        self.hole_fill_mode = hole_fill_mode
        self.small_image_width = small_image_width
        self.small_image_height = small_image_height
        # Runtime debug/profiling namespace (reference parametersCallback
        # dispatches debug.enable_debug / profiling.publish_fps while the
        # node streams, config.cpp:118-137) — togglable via attach_config.
        self.verbose = False
        self.debug_save_data = False
        self.debug_save_dir = f"{name}_debug"
        self._debug_frame_idx = 0
        self._fx_cache: Optional[float] = None
        self._prev_depth: Optional[np.ndarray] = None
        self._frameset_subs: List[Callable[[HostFrameset], None]] = []
        self._depth_subs: List[Callable[[np.ndarray, float], None]] = []
        self._small_subs: List[Callable[[np.ndarray, float], None]] = []
        self.fps_counter = FpsCounter(name=f"{name}/fps")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- dynamic reconfiguration ------------------------------------------

    def sensor_options(self) -> dict:
        """The reflected option tree: {group: {name: current value}}.

        Node-level filter options live under ``depth``; a source may expose
        its own options (e.g. the synthetic sensor's noise model) by
        implementing ``sensor_options()`` — they are merged in, like the
        reference reflecting every option of every rs2 sensor.
        """
        groups: dict = {
            "depth": {name: getattr(self, name) for name in self.DEPTH_OPTIONS},
            "color": {name: getattr(self, name) for name in self.COLOR_OPTIONS},
        }
        src_opts = getattr(self.source, "sensor_options", None)
        if callable(src_opts):
            for group, opts in src_opts().items():
                groups.setdefault(group, {}).update(opts)
        return groups

    @staticmethod
    def _coerce_option(current, value):
        """Type inference from the current value, like the reference's rs2
        option-type switch (config.cpp:53-169). Strings parse properly:
        ``bool("false")`` would be True, so booleans accept true/false/1/0
        spellings and numeric types go through float first."""
        if isinstance(current, bool):
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if isinstance(current, int) and not isinstance(current, bool):
            return int(float(value))
        if isinstance(current, float):
            return float(value)
        return type(current)(value)

    # Enumerated string options: validated AT SET TIME (parametersCallback
    # semantics) — the generic str() coercion would accept any spelling and
    # defer the failure to hole_fill_np inside capture(), killing the
    # streaming thread frames later instead of rejecting the bad value.
    _ENUM_OPTIONS = {"hole_fill_mode": ("farthest", "nearest", "left")}

    def _set_option(self, group: str, name: str, value) -> bool:
        """Dispatch one runtime option update (parametersCallback
        equivalent, config.cpp:53-169)."""
        own = (group == "depth" and name in self.DEPTH_OPTIONS) or (
            group == "color" and name in self.COLOR_OPTIONS
        )
        if own:
            coerced = self._coerce_option(getattr(self, name), value)
            allowed = self._ENUM_OPTIONS.get(name)
            if allowed is not None and coerced not in allowed:
                raise ValueError(
                    f"sensor.{group}.{name} must be one of {allowed}, "
                    f"not {value!r}"
                )
            setattr(self, name, coerced)
            return True
        src_opts = getattr(self.source, "sensor_options", None)
        if callable(src_opts) and name in src_opts().get(group, {}):
            current = getattr(self.source, name)
            setattr(self.source, name, self._coerce_option(current, value))
            return True
        return False

    def attach_config(self, cfg) -> None:
        """Wire a ConfigTree for dynamic reconfiguration.

        Declares the FULL reflected option set as ``sensor.<group>.<name>``
        parameters (declare_parameter sweep, realsense.cpp:608-664), applies
        any values already present in the tree, and dispatches runtime
        updates back into the node/source. ``fps`` retunes the loop rate.
        Call ``cfg.set("sensor.depth.temporal_alpha", 0.5)`` at runtime and
        the node picks it up immediately.
        """
        self.config = cfg
        self.fps = float(cfg.declare("fps", self.fps))
        self.verbose = bool(cfg.declare("verbose", self.verbose))
        # Runtime debug/profiling namespaces (config.cpp:118-137): these
        # dispatch on SET while the node streams, not just at load time.
        self.debug_save_data = bool(
            cfg.declare("debug.enable_debug", self.debug_save_data)
        )
        self.debug_save_dir = str(
            cfg.declare("debug.save_data_dir", self.debug_save_dir)
        )
        self.fps_counter.publish = bool(
            cfg.declare("profiling.publish_fps", self.fps_counter.publish)
        )
        for group, opts in self.sensor_options().items():
            for name, default in opts.items():
                value = cfg.declare(f"sensor.{group}.{name}", default)
                if value is not default:
                    self._set_option(group, name, value)

        def on_change(key: str, value) -> None:
            if key == "fps":
                self.fps = float(value)
                return
            if key == "verbose":
                self.verbose = self._coerce_option(True, value)
                return
            parts = key.split(".")
            if len(parts) == 3 and parts[0] == "sensor":
                self._set_option(parts[1], parts[2], value)
            elif parts[0] == "debug":
                if parts[-1] == "enable_debug":
                    self.debug_save_data = self._coerce_option(True, value)
                elif parts[-1] == "save_data_dir":
                    self.debug_save_dir = str(value)
            elif parts[0] == "profiling":
                if parts[-1] == "publish_fps":
                    self.fps_counter.publish = self._coerce_option(True, value)

        cfg.on_change(on_change)

    # -- service -----------------------------------------------------------

    def get_camera_parameters(self) -> CameraParameters:
        intr = self.source.intrinsics
        info = CameraInfo.from_intrinsics(intr)
        depth_info = info  # aligned: depth shares the color profile
        if self.decimation_filter:
            # Decimation shrinks the depth stream; its profile scales like
            # librealsense's decimated stream profile.
            from pointcloud_depthfusion_tpu.ops.filters import (  # noqa: PLC0415
                decimate_intrinsics,
            )

            depth_info = CameraInfo.from_intrinsics(
                decimate_intrinsics(intr, self.decimation_magnitude)
            )
        rot = np.asarray(self.depth_to_color.rotation)
        return CameraParameters(
            depth_info=depth_info,
            color_info=info,
            extrinsic_rotation=rot.flatten(order="F"),
            extrinsic_translation=np.asarray(self.depth_to_color.translation),
        )

    # -- topics ------------------------------------------------------------

    def subscribe_frameset(self, cb: Callable[[HostFrameset], None]) -> None:
        self._frameset_subs.append(cb)

    def subscribe_depth(self, cb: Callable[[np.ndarray, float], None]) -> None:
        self._depth_subs.append(cb)

    def subscribe_color_small(self, cb: Callable[[np.ndarray, float], None]) -> None:
        """The color/image_small preview topic: a bilinear resize of the
        color frame to small_image_{width,height} (camera_node.cpp:349-352,
        config default 608×608). Computed only while subscribed."""
        self._small_subs.append(cb)

    # -- acquisition --------------------------------------------------------

    @property
    def intrinsics(self) -> Intrinsics:
        """The COLOR stream profile (what the feeder uploads framesets
        with). A decimated depth stream has its own profile — reported by
        get_camera_parameters().depth_info — and cannot feed the composed
        fusion path (the DeviceFeeder rejects the size mismatch)."""
        return self.source.intrinsics

    def next_frame(self) -> Optional[HostFrameset]:
        """FramesetSource face: one filtered frame (see class docstring)."""
        return self.capture()

    def capture(self) -> Optional[HostFrameset]:
        """Grab one frame, run the rs2-equivalent post-processing bank (by
        default only the temporal filter is active, matching getFrames,
        realsense.cpp:398-404), publish."""
        fs = self.source.next_frame()
        if fs is None:
            return None
        fs = self._apply_filter_bank(fs)
        if self.debug_save_data:
            self._dump_debug(fs)
        if self.verbose:
            print(
                f"{self.name}: frame {self._debug_frame_idx} "
                f"stamp {fs.timestamp:.4f}"
            )
        self._debug_frame_idx += 1
        for cb in self._frameset_subs:
            cb(fs)
        for cb in self._depth_subs:
            cb(fs.depth, fs.timestamp)
        if self._small_subs:
            from PIL import Image  # noqa: PLC0415

            small = np.asarray(
                Image.fromarray(fs.color).resize(
                    (self.small_image_width, self.small_image_height),
                    Image.BILINEAR,
                )
            )
            for cb in self._small_subs:
                cb(small, fs.timestamp)
        self.fps_counter.tick()
        return fs

    def _dump_debug(self, fs: HostFrameset) -> None:
        """debug.enable_debug artifact path: dump each captured frameset as
        PNGs (the reference's save-every-stage debug dumps,
        depth_frame.cpp:157-181, gated by m_debug at runtime)."""
        import os  # noqa: PLC0415

        from pointcloud_depthfusion_tpu.io.artifacts import save_png  # noqa: PLC0415

        os.makedirs(self.debug_save_dir, exist_ok=True)
        i = self._debug_frame_idx
        save_png(
            os.path.join(self.debug_save_dir, f"{i:06d}_depth.png"), fs.depth
        )
        save_png(
            os.path.join(self.debug_save_dir, f"{i:06d}_color.png"), fs.color
        )

    def _apply_filter_bank(self, fs: HostFrameset) -> HostFrameset:
        """decimation → threshold → [→disparity] → spatial → temporal
        [→depth] → hole fill, in the librealsense-recommended order the
        reference documents (realsense.cpp:377-389).

        Pure numpy on the capture thread: a device round-trip per frame
        (H2D+D2H) costs far more than these filters; the device twins in
        ops.filters are value-equivalent (tested)."""
        from pointcloud_depthfusion_tpu.ops import host_filters as HF  # noqa: PLC0415

        depth = fs.depth
        # fx is only consumed by the decimation/disparity branches (both
        # off by default) and Intrinsics leaves are DEVICE arrays: an
        # unconditional float() here was a device→host fetch on EVERY
        # captured frame — a device round trip per frame on the capture
        # hot path. Read it lazily, once.
        fx = self._fx_host() if (
            self.decimation_filter or self.disparity_domain
        ) else 0.0
        if self.decimation_filter:
            depth = HF.decimation_filter_np(depth, self.decimation_magnitude)
            fx /= self.decimation_magnitude
        if self.threshold_filter:
            depth = HF.threshold_filter_np(
                depth, fs.depth_scale, self.threshold_min_m, self.threshold_max_m
            )
        data = (
            HF.depth_to_disparity_np(
                depth, fs.depth_scale, fx, self.stereo_baseline_m
            )
            if self.disparity_domain
            else depth
        )
        if self.spatial_filter:
            data = HF.spatial_filter_np(
                data, self.spatial_alpha, self.spatial_delta,
                self.spatial_magnitude,
            )
        if self.temporal_filter:
            data = self._apply_temporal(data)
        depth = (
            HF.disparity_to_depth_np(
                data, fs.depth_scale, fx, self.stereo_baseline_m
            )
            if self.disparity_domain
            else data
        )
        if self.hole_filling:
            depth = HF.hole_fill_np(depth, self.hole_fill_mode)
        if depth is fs.depth:
            return fs
        return HostFrameset(
            depth=depth,
            color=fs.color,
            timestamp=fs.timestamp,
            depth_scale=fs.depth_scale,
        )

    def _fx_host(self) -> float:
        """The source's fx as a host float, fetched from the device ONCE."""
        if self._fx_cache is None:
            self._fx_cache = float(self.source.intrinsics.fx)
        return self._fx_cache

    def _apply_temporal(self, data: np.ndarray) -> np.ndarray:
        """Temporal EMA step in the current domain (u16 depth or f32
        disparity). Same semantics as ops.filters.temporal_filter (tested
        equivalent); history resets if the stream shape/domain changes."""
        prev = self._prev_depth
        if prev is None or prev.shape != data.shape or prev.dtype != data.dtype:
            self._prev_depth = data
            return data
        cur = data.astype(np.float32)
        prev_f = prev.astype(np.float32)
        have_both = (cur > 0) & (prev_f > 0)
        close = np.abs(cur - prev_f) <= self.temporal_delta
        out = np.where(
            have_both & close,
            self.temporal_alpha * cur + (1.0 - self.temporal_alpha) * prev_f,
            cur,
        )
        out = np.where((cur == 0) & (prev_f > 0), prev_f, out)
        if np.issubdtype(data.dtype, np.integer):
            out = np.clip(np.rint(out), 0, 65535)
        out = out.astype(data.dtype)
        self._prev_depth = out
        return out

    # -- push-mode loop ------------------------------------------------------

    def spin(self, realtime: bool = True, max_frames: Optional[int] = None) -> None:
        count = 0
        while not self._stop.is_set():
            # Re-read per iteration: attach_config's ``fps`` handler retunes
            # the loop rate of a RUNNING node (config.cpp dynamic
            # reconfigure semantics).
            period = 1.0 / self.fps if self.fps > 0 else 0.0
            t0 = time.perf_counter()
            if self.capture() is None:
                return
            count += 1
            if max_frames is not None and count >= max_frames:
                return
            if realtime:
                dt = time.perf_counter() - t0
                if dt < period:
                    time.sleep(period - dt)

    def start(self, **spin_kw) -> "CameraNode":
        self._thread = threading.Thread(
            target=self.spin, kwargs=spin_kw, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)


def main() -> None:
    """Standalone camera node: stream a synthetic camera and record it.

    The CLI face of the reference camera_node main (--name selects the
    camera, camera_node/src/main.cpp:60-100), adapted to a host without
    a sensor: the source is synthetic/recorded and the output is a dataset
    file (.npz via io.recorded or .pdfe via io.encoded) instead of DDS
    topics.
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--name", default="camera_left",
                        choices=["camera_left", "camera_right"])
    parser.add_argument("--model", default="D455")
    parser.add_argument("--width", type=int, default=0,
                        help="override preset width")
    parser.add_argument("--height", type=int, default=0)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--out", default="",
                        help="output dataset (.npz or .pdfe); empty = none")
    parser.add_argument("--fps", type=float, default=0.0)
    parser.add_argument("--source", default="",
                        help="tcp://host:port — front a remote frameset "
                        "stream (io/network.py server on the camera host) — "
                        "or a recorded .npz dataset (see --out) to replay, "
                        "instead of the local synthetic camera")
    args = parser.parse_args()

    import numpy as np  # noqa: PLC0415

    # Capture/record is pure host work; keep jax off the accelerator
    # (calibration field reads would each be a device round trip, and the
    # card stays free for the fusion process).
    import jax  # noqa: PLC0415

    jax.config.update("jax_platforms", "cpu")

    from pointcloud_depthfusion_tpu.core.camera import (  # noqa: PLC0415
        Intrinsics,
        model_preset,
    )
    from pointcloud_depthfusion_tpu.io.feeder import (  # noqa: PLC0415
        NativeSyntheticSource,
        SyntheticSource,
    )
    from pointcloud_depthfusion_tpu.io.synthetic import (  # noqa: PLC0415
        SyntheticScene,
        two_camera_rig,
    )
    from pointcloud_depthfusion_tpu.runtime import is_available  # noqa: PLC0415

    preset = model_preset(args.model)
    w, h = preset["color_size"]
    if args.width:
        w = args.width
    if args.height:
        h = args.height
    fps = args.fps or preset["fps"]
    if args.source.startswith("tcp://"):
        from pointcloud_depthfusion_tpu.io.network import NetworkSource  # noqa: PLC0415

        host, _, port = args.source[len("tcp://"):].partition(":")
        source = NetworkSource(host, int(port or 7447))
        intr = source.intrinsics
        w, h = intr.width, intr.height
        fps = args.fps or source.fps or 30.0
    elif args.source:
        # Replay a recorded dataset (the rosbag-replay analogue): loop so
        # --frames beyond the recording length keeps streaming.
        from pointcloud_depthfusion_tpu.io.recorded import RecordedSource  # noqa: PLC0415

        source = RecordedSource(args.source, loop=True)
        intr = source.intrinsics
        w, h = intr.width, intr.height
        fps = args.fps or source.fps
    else:
        fx = 631.0 * w / 1280.0
        intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2)
        wl, wr = two_camera_rig()
        pose = wl if args.name == "camera_left" else wr
        src_cls = NativeSyntheticSource if is_available() else SyntheticSource
        source = src_cls(
            SyntheticScene(), intr, pose, fps=fps,
            depth_noise_std=0.002, hole_fraction=0.01,
        )
    # Apply the temporal EMA exactly ONCE per stream, like the reference's
    # getFrames: a network bridge (io/realsense_host.py) and a recording
    # captured through a CameraNode both deliver ALREADY-filtered depth —
    # re-filtering here would double the EMA (extra motion lag/ghosting).
    # Only the local synthetic sensor needs the node-level filter.
    node = CameraNode(
        args.name, source, fps=fps, temporal_filter=not args.source
    )

    frames = []
    node.subscribe_frameset(frames.append)
    node.spin(realtime=False, max_frames=args.frames)
    msg = node.fps_counter.tick()
    print(f"{args.name}: captured {len(frames)} frames @ {w}x{h}")

    if args.out.endswith(".npz"):
        from pointcloud_depthfusion_tpu.io.recorded import record_dataset  # noqa: PLC0415

        record_dataset(args.out, frames, intr)
        print(f"wrote {args.out}")
    elif args.out.endswith(".pdfe"):
        from pointcloud_depthfusion_tpu.io.encoded import write_encoded_stream  # noqa: PLC0415

        write_encoded_stream(args.out, frames)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
