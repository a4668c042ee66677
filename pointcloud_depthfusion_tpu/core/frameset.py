"""Frameset: one synchronized depth+color frame pair with calibration.

Equivalent of the reference's Frameset/DepthFrame/ColorFrame device
buffer objects (pointcloud_processing/src/frameset.cpp, depth_frame.cpp,
color_frame.cpp) and of the DepthFrameset wire message
(camera_interfaces/msg/DepthFrameset.msg:1-8).

Where the reference manages raw CUDA buffers plus host/device intrinsics
copies, here a Frameset is an immutable pytree of dense arrays — XLA owns all
memory, and the whole per-frame pipeline consumes/produces Framesets inside a
single jitted program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_depthfusion_tpu.core.camera import Extrinsics, Intrinsics

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Frameset:
    """A depth (uint16) + color (uint8 RGB) frame pair with calibration.

    ``depth`` is the depth image aligned to the color camera (the reference
    default: rs2::align to color, realsense.cpp:373-376); when carrying an
    unaligned depth image, ``depth_intrinsics``/``depth_to_color`` describe it
    and ops/align.py produces the aligned version.

    ``timestamp`` is seconds (float64 on host, float32 on device) — the
    capture time used for cross-camera pairing.
    """

    depth: Array  # (H, W) uint16
    color: Array  # (H, W, 3) uint8
    depth_intrinsics: Intrinsics
    color_intrinsics: Intrinsics
    depth_to_color: Extrinsics
    depth_scale: Array  # scalar, meters per LSB
    timestamp: Array  # scalar, seconds SINCE timestamp_epoch (f32-precise)
    # Quantized absolute epoch (multiple of STAMP_EPOCH_GRID_S; exact in
    # f32). Absolute time = timestamp_epoch + timestamp; see split_stamp.
    timestamp_epoch: Array
    # Optional pre-packed color: (H, W) int32, (r<<16)|(g<<8)|b — the exact
    # rgb24 winner key of the tiled/exact render. Slicing channel planes
    # out of the (H, W, 3) u8 HWC layout inside the fused program costs a
    # stride-3 minor-dim relayout every frame; a host- (or upload-time-)
    # packed plane removes that from the hot path. None ⇒ hot paths pack from ``color`` as before. Presence
    # is part of the pytree structure (a different jit specialization).
    color_packed: Optional[Array] = None

    @staticmethod
    def create(
        depth,
        color,
        color_intrinsics: Intrinsics,
        depth_intrinsics: Optional[Intrinsics] = None,
        depth_to_color: Optional[Extrinsics] = None,
        depth_scale: float = 0.001,
        timestamp: float = 0.0,
        pack_color: bool = False,
    ) -> "Frameset":
        """``timestamp`` is split into a quantized epoch + offset before the
        f32 device cast: raw epoch-scale seconds (~1.7e9) have >60 ms f32
        quantization — far coarser than the 17 ms pairing gate — while the
        (epoch, offset) pair keeps ≤0.25 ms device precision and exact
        host-side reconstruction. The same clock-rebase idea as the
        reference's system-time restamping (realsense.cpp:424-431).
        Host-side pairing uses HostFrameset's float64 stamps and is
        unaffected; recover an absolute time with :func:`absolute_stamp`."""
        packed = None
        pack_on_device = False
        if pack_color:
            # Pack on the host when the input still lives there (the feeder
            # path); np.asarray on a device array would force a D2H copy, so
            # device inputs defer to the with_packed_color device pack.
            if isinstance(color, jax.Array):
                pack_on_device = True
            else:
                packed = jnp.asarray(
                    pack_rgb24_host(np.asarray(color)), jnp.int32
                )
        depth = jnp.asarray(depth, jnp.uint16)
        color = jnp.asarray(color, jnp.uint8)
        epoch, timestamp = split_stamp(float(timestamp))
        if depth_intrinsics is None:
            # Aligned framesets share the color intrinsics
            # (realsense.cpp:670-680: depth intrinsics = color stream profile
            # when aligned).
            depth_intrinsics = color_intrinsics
        if depth_to_color is None:
            depth_to_color = Extrinsics.identity()
        fs = Frameset(
            depth=depth,
            color=color,
            depth_intrinsics=depth_intrinsics,
            color_intrinsics=color_intrinsics,
            depth_to_color=depth_to_color,
            depth_scale=jnp.asarray(depth_scale, jnp.float32),
            timestamp=jnp.asarray(timestamp, jnp.float32),
            timestamp_epoch=jnp.asarray(epoch, jnp.float32),
            color_packed=packed,
        )
        if pack_on_device:
            fs = fs.with_packed_color()
        return fs

    def with_packed_color(self) -> "Frameset":
        """Return a copy carrying ``color_packed`` (device-side pack).

        For host-built framesets prefer ``create(..., pack_color=True)`` /
        :func:`pack_rgb24_host`, which keeps the one-time HWC relayout off
        the device entirely."""
        if self.color_packed is not None:
            return self
        # Jitted, not eager: every device pack is one compiled program
        # instead of a dispatch per op.
        return dataclasses.replace(
            self, color_packed=_pack_rgb24_device(self.color)
        )

    @property
    def height(self) -> int:
        return self.depth.shape[0]

    @property
    def width(self) -> int:
        return self.depth.shape[1]

    def depth_metric(self) -> Array:
        """Depth in meters, float32."""
        return self.depth.astype(jnp.float32) * self.depth_scale

    def to_host(self) -> "HostFrameset":
        return HostFrameset(
            depth=np.asarray(self.depth),
            color=np.asarray(self.color),
            timestamp=absolute_stamp(
                float(self.timestamp), float(self.timestamp_epoch)
            ),
            depth_scale=float(self.depth_scale),
        )


@dataclasses.dataclass
class HostFrameset:
    """Host-side (numpy) frameset used by the IO feeder before device_put.

    ``timestamp`` stays a float64 absolute time — all pairing math
    (ApproximateTimePairer's 17 ms gate) runs on these host stamps, never on
    the f32 device copies."""

    depth: np.ndarray  # (H, W) uint16
    color: np.ndarray  # (H, W, 3) uint8
    timestamp: float
    depth_scale: float = 0.001


def pack_rgb24_host(color_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 → (H, W) int32 ``(r<<16)|(g<<8)|b`` on the host.

    The host-side twin of ops/render.pack_rgb, used to populate
    ``Frameset.color_packed`` before upload (numpy does the byte shuffle
    once, off the device hot path)."""
    # Wrap to u8 FIRST — Frameset stores color as jnp.uint8 (wrapping), so
    # packing wider input without the wrap would produce a plane
    # inconsistent with the stored color (and bits above 0xFFFFFF).
    c = np.asarray(color_u8).astype(np.uint8).astype(np.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


@jax.jit
def _pack_rgb24_device(color_u8: Array) -> Array:
    c = color_u8.astype(jnp.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


# -- device timestamp epoch ----------------------------------------------
#
# Device stamps are f32; storing raw epoch seconds would quantize to >60 ms
# (coarser than the 17 ms pairing gate). Each Frameset carries a
# DETERMINISTIC quantized epoch (floor to a 4096 s grid) plus the f32
# offset: 4096 = 2^12, so every epoch value below 2^36 s is exactly
# representable in f32, and offsets stay below 4096 s where the f32 quantum
# is ≤ 0.25 ms. No process-global state — the split depends only on the
# timestamp itself, so streams with different clock bases coexist and
# reconstruction (epoch + offset) is exact regardless of creation order.

STAMP_EPOCH_GRID_S = 4096.0


def split_stamp(timestamp: float) -> Tuple[float, float]:
    """Absolute seconds → (exact-f32 epoch, sub-ms-precise f32 offset)."""
    epoch = float(np.floor(timestamp / STAMP_EPOCH_GRID_S) * STAMP_EPOCH_GRID_S)
    return epoch, timestamp - epoch


def absolute_stamp(offset: float, epoch: float) -> float:
    """Inverse of :func:`split_stamp` (float64 on host)."""
    return float(epoch) + float(offset)
