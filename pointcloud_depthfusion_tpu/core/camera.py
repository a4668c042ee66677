"""Camera models: pinhole intrinsics, distortion, depth→color extrinsics.

Equivalent of the reference's camera-model structs
(reference: pointcloud_processing/include/pointcloud_processing/intrinsics.h:6-39)
and the CameraInfo conversion (fusion_node/src/fusion_node.cpp:570-581).

Intrinsics/Extrinsics are registered JAX pytrees so they can be passed through
`jit` boundaries; the static image geometry (width/height/model) is hashable
aux data so shapes stay static under tracing.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


class Distortion(enum.IntEnum):
    """Distortion model enumeration (RealSense model set).

    Mirrors the reference enum (intrinsics.h:6-15).
    """

    NONE = 0
    MODIFIED_BROWN_CONRADY = 1
    INVERSE_BROWN_CONRADY = 2
    FTHETA = 3
    BROWN_CONRADY = 4
    KANNALA_BRANDT4 = 5


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole camera intrinsics with 5-coefficient distortion.

    ``width``/``height``/``model`` are static (Python ints / enum) so array
    shapes derived from them are compile-time constants; ``ppx/ppy/fx/fy`` and
    ``coeffs`` are JAX leaves (traced).
    """

    ppx: jax.Array
    ppy: jax.Array
    fx: jax.Array
    fy: jax.Array
    coeffs: jax.Array  # (5,)
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    model: Distortion = dataclasses.field(
        default=Distortion.NONE, metadata=dict(static=True)
    )

    @staticmethod
    def create(
        width: int,
        height: int,
        fx: float,
        fy: float,
        ppx: float,
        ppy: float,
        model: Distortion = Distortion.NONE,
        coeffs=(0.0, 0.0, 0.0, 0.0, 0.0),
        dtype=jnp.float32,
    ) -> "Intrinsics":
        return Intrinsics(
            ppx=jnp.asarray(ppx, dtype),
            ppy=jnp.asarray(ppy, dtype),
            fx=jnp.asarray(fx, dtype),
            fy=jnp.asarray(fy, dtype),
            coeffs=jnp.asarray(coeffs, dtype),
            width=int(width),
            height=int(height),
            model=Distortion(model),
        )

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    def transposed(self) -> "Intrinsics":
        """Swap x/y axes (vertical output image, fusion_node.cpp:156-162)."""
        return Intrinsics(
            ppx=self.ppy,
            ppy=self.ppx,
            fx=self.fy,
            fy=self.fx,
            coeffs=self.coeffs,
            width=self.height,
            height=self.width,
            model=self.model,
        )

    def with_centered_pp(self) -> "Intrinsics":
        """Principal point forced to the image center.

        Reproduces the reference's integer division
        ``ppx = width / 2`` (C++ int division, fusion_node.cpp:164-165).
        """
        return dataclasses.replace(
            self,
            ppx=jnp.asarray(float(self.width // 2), self.ppx.dtype),
            ppy=jnp.asarray(float(self.height // 2), self.ppy.dtype),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Extrinsics:
    """Rigid transform between two sensors (e.g. depth→color).

    ``rotation`` is a row-major 3×3 matrix applied as ``R.T @ p`` in the
    reference's column-vector convention (kernels.cu:128-136 multiplies with
    the transposed layout: rotation[0],rotation[3],rotation[6] form row 0 of
    the effective matrix). Here we store the effective column-vector matrix
    directly: ``p' = rotation @ p + translation``.
    """

    rotation: jax.Array  # (3, 3), applied as rotation @ p
    translation: jax.Array  # (3,)

    @staticmethod
    def identity(dtype=jnp.float32) -> "Extrinsics":
        return Extrinsics(jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype))

    @staticmethod
    def create(rotation, translation, dtype=jnp.float32) -> "Extrinsics":
        return Extrinsics(
            jnp.asarray(rotation, dtype).reshape(3, 3),
            jnp.asarray(translation, dtype).reshape(3),
        )

    @staticmethod
    def from_column_major_flat(rotation9, translation3, dtype=jnp.float32) -> "Extrinsics":
        """Build from the reference wire format: float32[9] column-major R.

        The GetCameraParameters service carries a column-major flattened 3×3
        (camera_interfaces/srv/GetCameraParameters.srv:1-10); the reference
        kernels index it as rotation[0],rotation[3],rotation[6] per output row
        (kernels.cu:128-136), i.e. effective matrix = reshape(9, order='F').
        """
        r = np.asarray(rotation9, dtype=np.float32).reshape(3, 3, order="F")
        return Extrinsics.create(r, translation3, dtype)

    def as_matrix(self) -> jax.Array:
        """Return the 4×4 homogeneous transform."""
        m = jnp.eye(4, dtype=self.rotation.dtype)
        m = m.at[:3, :3].set(self.rotation)
        m = m.at[:3, 3].set(self.translation)
        return m


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Host-side camera calibration record (ROS sensor_msgs/CameraInfo shape).

    ``k`` is the row-major 3×3 camera matrix [fx 0 ppx; 0 fy ppy; 0 0 1],
    ``d`` the distortion coefficients. Plain numpy — this is config/state,
    not device data.
    """

    width: int
    height: int
    k: np.ndarray  # (9,)
    d: np.ndarray  # (5,)
    distortion_model: str = "plumb_bob"

    @staticmethod
    def from_intrinsics(intr: Intrinsics) -> "CameraInfo":
        k = np.zeros(9, np.float64)
        k[0] = float(intr.fx)
        k[4] = float(intr.fy)
        k[2] = float(intr.ppx)
        k[5] = float(intr.ppy)
        k[8] = 1.0
        return CameraInfo(
            width=intr.width,
            height=intr.height,
            k=k,
            d=np.asarray(intr.coeffs, np.float64),
        )


def camera_info_to_intrinsics(
    info: CameraInfo,
    model: Distortion = Distortion.BROWN_CONRADY,
    legacy_int_truncation: bool = True,
) -> Intrinsics:
    """Convert a CameraInfo record to Intrinsics.

    The reference truncates fx/fy/ppx/ppy to int during this conversion
    (fusion_node.cpp:574-577) — a deliberate quirk we reproduce by default so
    fused outputs match; pass ``legacy_int_truncation=False`` for full
    precision.
    """
    cast = (lambda v: float(int(v))) if legacy_int_truncation else float
    return Intrinsics.create(
        width=int(info.width),
        height=int(info.height),
        fx=cast(info.k[0]),
        fy=cast(info.k[4]),
        ppx=cast(info.k[2]),
        ppy=cast(info.k[5]),
        model=model,
        # Pad to exactly 5: ROS CameraInfo.d may carry 0 (plumb_bob with no
        # distortion) or 8 coefficients; the distortion models index
        # coeffs[0..4] and a short tuple would fail (and change the pytree
        # leaf shape between sources, forcing recompiles).
        coeffs=tuple(
            (list(float(c) for c in np.asarray(info.d)[:5]) + [0.0] * 5)[:5]
        ),
    )


def fused_virtual_intrinsics(
    color_left: Intrinsics, vertical_image: bool
) -> Intrinsics:
    """Derive the fused virtual-camera intrinsics.

    = left color intrinsics, transposed if the output is vertical, with the
    principal point forced to the image center (fusion_node.cpp:150-165).
    """
    intr = color_left.transposed() if vertical_image else color_left
    return intr.with_centered_pp()


#: Per-model stream presets (resolution, fps, depth scale) mirroring the
#: reference's camera configuration (realsense.cpp:226-236: D455/D435/D415 →
#: 1280×720 Z16+RGB8 @30; L515 → 1024×768 depth + 1280×720 color; depth
#: scales from the config files).
CAMERA_MODEL_PRESETS = {
    "D455": dict(depth_size=(1280, 720), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.001),
    "D435": dict(depth_size=(1280, 720), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.001),
    "D415": dict(depth_size=(1280, 720), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.001),
    "L515": dict(depth_size=(1024, 768), color_size=(1280, 720), fps=30.0,
                 depth_scale=0.00025),
}


def model_preset(model: str) -> dict:
    """Stream preset for a camera model name (case-insensitive)."""
    key = model.upper().replace("INTEL REALSENSE ", "")
    if key not in CAMERA_MODEL_PRESETS:
        raise KeyError(
            f"unknown camera model {model!r}; known: {sorted(CAMERA_MODEL_PRESETS)}"
        )
    return dict(CAMERA_MODEL_PRESETS[key])


def d455_default_intrinsics(
    width: int = 848, height: int = 480, dtype=jnp.float32
) -> Intrinsics:
    """Plausible D455-like pinhole intrinsics for synthetic streams/tests.

    (D455: ~1.88 mm focal length ≈ 631 px at 1280×720; scaled for other
    resolutions. fusion_node.cpp:163 comment.)
    """
    fx = 631.0 * width / 1280.0
    fy = 631.0 * height / 720.0
    return Intrinsics.create(
        width, height, fx=fx, fy=fy, ppx=width / 2.0, ppy=height / 2.0, dtype=dtype
    )


def intrinsics_as_numpy(intr: Intrinsics) -> Tuple[float, float, float, float]:
    return (float(intr.fx), float(intr.fy), float(intr.ppx), float(intr.ppy))
