"""Dense camera geometry: deprojection, projection, rigid transforms, SE(3).

Replacements for the reference CUDA kernels
(pointcloud_processing/src/kernels.cu):

  * :func:`deproject` — kernel_deproject_depth (kernels.cu:183-221), but
    dense over the whole H×W frame with a validity mask instead of gathering
    through a compacted index list. Invalid pixels get z=0 and are masked.
  * :func:`project_points` — the pixel-coordinate part of
    kernel_project_pointcloud (kernels.cu:239-274); the z-buffered image
    formation lives in :mod:`pointcloud_depthfusion_tpu.ops.render`.
  * :func:`transform_points` — kernel_transform (kernels.cu:161-181).
  * quaternion/slerp/euler utilities — Eigen equivalents used by
    interpolateTransform (fusion_node.cpp:589-604) and the registration
    gating (registration_node.cpp:363-393, registration.cpp extractEulerAngles).

Everything is a pure jnp function of statically-shaped arrays; the matching
numpy oracles for testing live in tests/oracles.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from pointcloud_depthfusion_tpu.core.camera import Distortion, Intrinsics

Array = jax.Array


# ---------------------------------------------------------------------------
# Pixel grids
# ---------------------------------------------------------------------------


def pixel_grid(height: int, width: int, dtype=jnp.float32) -> Tuple[Array, Array]:
    """Return (u, v) pixel-coordinate grids of shape (height, width)."""
    u = jax.lax.broadcasted_iota(dtype, (height, width), 1)
    v = jax.lax.broadcasted_iota(dtype, (height, width), 0)
    return u, v


# ---------------------------------------------------------------------------
# Deprojection (pixel + depth -> 3D point)
# ---------------------------------------------------------------------------


def _undistort_inverse_brown_conrady(
    x: Array, y: Array, coeffs: Array
) -> Tuple[Array, Array]:
    """Inverse-Brown-Conrady undistortion applied to normalized coords.

    Matches the reference math exactly (kernels.cu:56-63).
    """
    r2 = x * x + y * y
    f = 1.0 + coeffs[0] * r2 + coeffs[1] * r2 * r2 + coeffs[4] * r2 * r2 * r2
    ux = x * f + 2.0 * coeffs[2] * x * y + coeffs[3] * (r2 + 2.0 * x * x)
    uy = y * f + 2.0 * coeffs[3] * x * y + coeffs[2] * (r2 + 2.0 * y * y)
    return ux, uy


def deproject_pixels(
    u: Array, v: Array, depth: Array, intrinsics: Intrinsics
) -> Array:
    """Deproject pixel coordinates + metric depth to 3D points.

    Args:
      u, v: pixel coordinates, any matching shape.
      depth: metric depth (same shape).
    Returns:
      points of shape (*shape, 3).
    """
    x = (u - intrinsics.ppx) / intrinsics.fx
    y = (v - intrinsics.ppy) / intrinsics.fy
    if intrinsics.model == Distortion.INVERSE_BROWN_CONRADY:
        x, y = _undistort_inverse_brown_conrady(x, y, intrinsics.coeffs)
    return jnp.stack([depth * x, depth * y, depth], axis=-1)


def deproject(
    depth_m: Array,
    intrinsics: Intrinsics,
    mask: Optional[Array] = None,
) -> Tuple[Array, Array]:
    """Dense frame deprojection.

    Args:
      depth_m: (H, W) metric depth (already scaled by depth_scale).
      mask: optional (H, W) bool validity mask. Defaults to depth_m > 0.

    Returns:
      (points, valid): points (H, W, 3) float32 camera-frame coordinates and
      a bool validity mask. Invalid points have z = 0 which keeps them inert
      in downstream z-buffer mins (they are additionally masked explicitly).

    Replaces kernel_deproject_depth (kernels.cu:183-221); the reference's
    compacted index gather becomes a dense compute + mask (fixed shapes —
    see SURVEY.md §7).
    """
    h, w = depth_m.shape
    u, v = pixel_grid(h, w, depth_m.dtype)
    valid = depth_m > 0 if mask is None else mask & (depth_m > 0)
    points = deproject_pixels(u, v, depth_m, intrinsics)
    return points, valid


def deproject_planar(
    depth_m: Array,
    intrinsics: Intrinsics,
    mask: Optional[Array] = None,
) -> Tuple[Array, Array, Array, Array]:
    """Structure-of-arrays deprojection: returns (x, y, z, valid) planes.

    Identical math to :func:`deproject` but keeps the minor dimension =
    image width (no trailing stride-3 xyz axis). Hot
    paths (fusion/pipeline.py) use this; the (H, W, 3) variant remains for
    API convenience.
    """
    h, w = depth_m.shape
    u, v = pixel_grid(h, w, depth_m.dtype)
    valid = depth_m > 0 if mask is None else mask & (depth_m > 0)
    nx = (u - intrinsics.ppx) / intrinsics.fx
    ny = (v - intrinsics.ppy) / intrinsics.fy
    if intrinsics.model == Distortion.INVERSE_BROWN_CONRADY:
        nx, ny = _undistort_inverse_brown_conrady(nx, ny, intrinsics.coeffs)
    return depth_m * nx, depth_m * ny, depth_m, valid


def transform_planar(
    x: Array, y: Array, z: Array, transform: Array
) -> Tuple[Array, Array, Array]:
    """Rigid transform on coordinate planes (kernel_transform equivalent)."""
    t = transform.astype(x.dtype)
    xo = t[0, 0] * x + t[0, 1] * y + t[0, 2] * z + t[0, 3]
    yo = t[1, 0] * x + t[1, 1] * y + t[1, 2] * z + t[1, 3]
    zo = t[2, 0] * x + t[2, 1] * y + t[2, 2] * z + t[2, 3]
    return xo, yo, zo


# ---------------------------------------------------------------------------
# Projection (3D point -> pixel)
# ---------------------------------------------------------------------------


def project_points(points: Array, intrinsics: Intrinsics) -> Tuple[Array, Array]:
    """Project 3D points to continuous pixel coordinates.

    Args:
      points: (..., 3).
    Returns:
      (image_x, image_y) of shape (...,). Uses the pinhole part of the
      reference projection (kernels.cu:247-248); distortion forward models
      (modified Brown-Conrady, f-theta, kernels.cu:92-116) are applied when
      the intrinsics request them.
    """
    z = points[..., 2]
    safe_z = jnp.where(z == 0, 1.0, z)
    x = points[..., 0] / safe_z
    y = points[..., 1] / safe_z

    if intrinsics.model == Distortion.MODIFIED_BROWN_CONRADY:
        c = intrinsics.coeffs
        r2 = x * x + y * y
        f = 1.0 + c[0] * r2 + c[1] * r2 * r2 + c[4] * r2 * r2 * r2
        xf = x * f
        yf = y * f
        x = xf + 2.0 * c[2] * xf * yf + c[3] * (r2 + 2.0 * xf * xf)
        y = yf + 2.0 * c[3] * xf * yf + c[2] * (r2 + 2.0 * yf * yf)
    elif intrinsics.model == Distortion.FTHETA:
        c0 = intrinsics.coeffs[0]
        r = jnp.sqrt(x * x + y * y)
        safe_r = jnp.where(r == 0, 1.0, r)
        rd = (1.0 / c0) * jnp.arctan(2.0 * r * jnp.tan(c0 / 2.0))
        x = x * rd / safe_r
        y = y * rd / safe_r

    return x * intrinsics.fx + intrinsics.ppx, y * intrinsics.fy + intrinsics.ppy


# ---------------------------------------------------------------------------
# Rigid transforms
# ---------------------------------------------------------------------------

# Every matmul in this module is a tiny pose compose or an (N,3)×(3,3) point
# transform. On an NVIDIA GPU an f32 matmul at default precision may run on
# the tensor cores in TF32 (10-bit mantissa, ~5e-4 relative error per
# operand) — pixel-scale projection shifts and a drifting GICP solve in
# pose math, which only the cross-backend parity gate (tpu_check.py) can
# catch, because CPU tests ignore precision. Full f32 is forced here; none
# of these ops are throughput-relevant (the hot path's per-point
# transforms are elementwise planes, transform_planar).
_F32 = jax.lax.Precision.HIGHEST


def mm(a: Array, b: Array) -> Array:
    """Matrix multiply at full f32 precision (pose composes — see _F32)."""
    return jnp.matmul(a, b, precision=_F32)


def transform_points(points: Array, transform: Array) -> Array:
    """Apply a 4×4 homogeneous transform to (..., 3) points.

    Equivalent to kernel_transform (kernels.cu:161-181) — one matmul instead
    of per-point scalar arithmetic (at forced f32 operand precision; see
    _F32 above).
    """
    r = transform[:3, :3].astype(points.dtype)
    t = transform[:3, 3].astype(points.dtype)
    return mm(points, r.T) + t


def transform_extrinsic(points: Array, rotation: Array, translation: Array) -> Array:
    """Apply an Extrinsics-style transform: rotation @ p + translation."""
    return mm(points, rotation.astype(points.dtype).T) + translation.astype(
        points.dtype
    )


# ---------------------------------------------------------------------------
# SO(3)/SE(3) utilities (Eigen equivalents)
# ---------------------------------------------------------------------------


def quaternion_from_matrix(r: Array) -> Array:
    """Rotation matrix (3,3) -> quaternion (w, x, y, z), w >= 0 not enforced.

    Branch selection replicates Eigen's ``Quaternion(Matrix3)`` EXACTLY
    (jit-safe via lax.switch): the w-branch whenever trace > 0, otherwise
    the dominant-diagonal branch. The distinction matters for SIGN parity,
    not accuracy: for rotations with trace > 0 but a dominant diagonal
    (angles in (90°, 120°)) the argmax-of-all-four rule would pick a
    diagonal branch and return the NEGATION of Eigen's quaternion — and
    ``interpolate_transform``'s reference quirk ("invert the midpoint when
    q_right.w < 0", fusion_node.cpp:603) keys on that sign, so it would
    fire on poses where the reference's does not. The w-branch always
    yields w > 0, exactly like Eigen.
    """
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    tr = m00 + m11 + m22

    # Four candidates, one per dominant component.
    def cand_w():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2.0
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])

    def cand_x():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])

    def cand_y():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])

    def cand_z():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])

    diag = jnp.stack([m00, m11, m22])
    idx = jnp.where(tr > 0, 0, 1 + jnp.argmax(diag)).astype(jnp.int32)
    q = jax.lax.switch(idx, [cand_w, cand_x, cand_y, cand_z])
    return q / jnp.linalg.norm(q)


def matrix_from_quaternion(q: Array) -> Array:
    """Quaternion (w, x, y, z) -> rotation matrix (3,3)."""
    q = q / jnp.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def quaternion_slerp(q0: Array, q1: Array, t) -> Array:
    """Spherical linear interpolation, Eigen ``Quaterniond::slerp`` semantics.

    Takes the short path (negates q1 when the dot product is negative) and
    falls back to lerp for nearly-parallel quaternions.
    """
    d = jnp.dot(q0, q1, precision=_F32)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(d)
    d = jnp.minimum(d, 1.0)
    theta = jnp.arccos(d)
    sin_theta = jnp.sin(theta)
    use_lerp = sin_theta < 1e-6
    safe_sin = jnp.where(use_lerp, 1.0, sin_theta)
    w0 = jnp.where(use_lerp, 1.0 - t, jnp.sin((1.0 - t) * theta) / safe_sin)
    w1 = jnp.where(use_lerp, t, jnp.sin(t * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / jnp.linalg.norm(q)


def interpolate_transform(left: Array, right: Array) -> Array:
    """Midpoint interpolation of two 4×4 transforms.

    Reproduces FusionNode::interpolateTransform (fusion_node.cpp:589-604):
    slerp(0.5) of the rotations + lerp(0.5) of the translations, and the
    quirk that when the right rotation's quaternion w component is negative
    the whole interpolated transform is inverted (fusion_node.cpp:603).
    """
    q_l = quaternion_from_matrix(left[:3, :3])
    q_r = quaternion_from_matrix(right[:3, :3])
    q = quaternion_slerp(q_l, q_r, 0.5)
    t = 0.5 * left[:3, 3] + 0.5 * right[:3, 3]
    m = jnp.eye(4, dtype=left.dtype)
    m = m.at[:3, :3].set(matrix_from_quaternion(q))
    m = m.at[:3, 3].set(t)
    inv = invert_rigid(m)
    return jnp.where(q_r[0] < 0, inv, m)


def invert_rigid(transform: Array) -> Array:
    """Invert a rigid 4×4 transform without a general solve."""
    r = transform[:3, :3]
    t = transform[:3, 3]
    m = jnp.eye(4, dtype=transform.dtype)
    m = m.at[:3, :3].set(r.T)
    m = m.at[:3, 3].set(-mm(r.T, t))
    return m


def extract_euler_angles(rotation: Array) -> Array:
    """Rotation matrix -> (x, y, z) Euler angles.

    Matches Registration::extractEulerAngles (registration.cpp): atan2/asin
    XYZ extraction used by the transform-gating logic.
    """
    ea_x = jnp.arctan2(rotation[2, 1], rotation[2, 2])
    ea_y = -jnp.arcsin(jnp.clip(rotation[2, 0], -1.0, 1.0))
    ea_z = jnp.arctan2(rotation[1, 0], rotation[0, 0])
    return jnp.stack([ea_x, ea_y, ea_z])


def euler_to_matrix(angles) -> Array:
    """(x, y, z) Euler angles -> rotation matrix.

    Composition order matches the reference virtual-camera pose construction:
    R = Rx(ax) @ Ry(ay) @ Rz(az) (fusion_node.cpp:174-177, Eigen AngleAxis
    products).
    """
    angles = jnp.asarray(angles)
    ax, ay, az = angles[0], angles[1], angles[2]
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    rx = jnp.stack(
        [
            jnp.stack([jnp.ones_like(cx), jnp.zeros_like(cx), jnp.zeros_like(cx)]),
            jnp.stack([jnp.zeros_like(cx), cx, -sx]),
            jnp.stack([jnp.zeros_like(cx), sx, cx]),
        ]
    )
    ry = jnp.stack(
        [
            jnp.stack([cy, jnp.zeros_like(cy), sy]),
            jnp.stack([jnp.zeros_like(cy), jnp.ones_like(cy), jnp.zeros_like(cy)]),
            jnp.stack([-sy, jnp.zeros_like(cy), cy]),
        ]
    )
    rz = jnp.stack(
        [
            jnp.stack([cz, -sz, jnp.zeros_like(cz)]),
            jnp.stack([sz, cz, jnp.zeros_like(cz)]),
            jnp.stack([jnp.zeros_like(cz), jnp.zeros_like(cz), jnp.ones_like(cz)]),
        ]
    )
    return mm(mm(rx, ry), rz)


def make_transform(rotation: Array, translation: Array) -> Array:
    m = jnp.eye(4, dtype=rotation.dtype)
    m = m.at[:3, :3].set(rotation)
    m = m.at[:3, 3].set(jnp.asarray(translation, rotation.dtype))
    return m


def rotz(angle_rad, dtype=jnp.float32) -> Array:
    """4×4 rotation about Z (used for the +90° vertical-image pre-rotation,
    fusion_node.cpp:775-778)."""
    a = jnp.asarray(angle_rad, dtype)
    c, s = jnp.cos(a), jnp.sin(a)
    m = jnp.eye(4, dtype=dtype)
    m = m.at[0, 0].set(c)
    m = m.at[0, 1].set(-s)
    m = m.at[1, 0].set(s)
    m = m.at[1, 1].set(c)
    return m


def se3_exp(xi: Array) -> Array:
    """SE(3) exponential map: twist (6,) [rho, phi] -> 4×4 transform.

    Used by the Gauss-Newton update in the VGICP solver
    (registration/gicp.py) — the reference delegates this to fast_gicp's
    internal SO(3) machinery.
    """
    rho = xi[:3]
    phi = xi[3:]
    theta = jnp.linalg.norm(phi)
    small = theta < 1e-8
    safe_theta = jnp.where(small, 1.0, theta)

    k = jnp.array(
        [
            [0.0, -phi[2], phi[1]],
            [phi[2], 0.0, -phi[0]],
            [-phi[1], phi[0], 0.0],
        ],
        xi.dtype,
    )
    eye = jnp.eye(3, dtype=xi.dtype)
    a = jnp.where(small, 1.0, jnp.sin(safe_theta) / safe_theta)
    b = jnp.where(small, 0.5, (1.0 - jnp.cos(safe_theta)) / (safe_theta * safe_theta))
    c = jnp.where(
        small, 1.0 / 6.0, (safe_theta - jnp.sin(safe_theta)) / (safe_theta**3)
    )
    kk = mm(k, k)
    r = eye + a * k + b * kk
    v = eye + b * k + c * kk
    m = jnp.eye(4, dtype=xi.dtype)
    m = m.at[:3, :3].set(r)
    m = m.at[:3, 3].set(mm(v, rho))
    return m


def deg2rad(deg):
    return jnp.asarray(deg) * (jnp.pi / 180.0)


def rad2deg(rad):
    return jnp.asarray(rad) * (180.0 / jnp.pi)
