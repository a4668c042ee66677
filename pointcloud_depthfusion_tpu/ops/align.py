"""Depth→color alignment (GPU re-implementation of librealsense align).

Replaces the reference's three-kernel alignment
(kernels.cu:138-158 kernel_transfer_pixels, :276-301
kernel_align_depth_to_color, :303-322, host orchestration :714-747):

  * each depth pixel's ±0.5-pixel corners are deprojected, transformed
    through the depth→color extrinsics and projected into the color camera,
    giving an integer footprint box [p0, p1];
  * the raw uint16 depth is scatter-min'ed into every color pixel of the box;
  * untouched pixels (sentinel 0xffff) become 0.

The CUDA kernel walks a data-dependent box with nested loops; here the
footprint is statically bounded (``max_footprint``, default 4 ⇒ a 4×4 box)
and expressed as K² masked scatter-mins — static shapes, no dynamic control
flow. For the D455 geometry the true box is 1-2 px wide, so 4 is generous;
boxes that would exceed the cap are clipped (and counted in debug mode).

Deviation from the reference, documented: the CUDA kernel emulates uint16
atomicMin by atomically min-ing *pairs* of pixels as one 32-bit word
(kernels.cu:292-299), which couples each even pixel's result to its odd
neighbor. We min each pixel independently — strictly more correct.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from pointcloud_depthfusion_tpu.core.camera import Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu.core import geometry as G
from pointcloud_depthfusion_tpu.ops.backend import choose

Array = jax.Array

# Plain Python int, NOT jnp.int32: a module-level device constant would
# initialize the JAX backend at import time. jnp.where/full promote it
# identically inside traces.
_SENTINEL = 0xFFFF


def _map_corner(
    u: Array,
    v: Array,
    depth_m: Array,
    shift: float,
    depth_intrinsics: Intrinsics,
    color_intrinsics: Intrinsics,
    extrinsics: Extrinsics,
) -> Tuple[Array, Array]:
    """Map a depth pixel corner into integer color-image coordinates.

    Matches kernel_transfer_pixels (kernels.cu:138-158): deproject at
    (u+shift, v+shift), transform, project, then ``(int)(x + 0.5f)``.
    """
    pts = G.deproject_pixels(u + shift, v + shift, depth_m, depth_intrinsics)
    pts = G.transform_extrinsic(pts, extrinsics.rotation, extrinsics.translation)
    px, py = G.project_points(pts, color_intrinsics)
    return (px + 0.5).astype(jnp.int32), (py + 0.5).astype(jnp.int32)


def auto_footprint(
    depth_intrinsics: Intrinsics,
    color_intrinsics: Intrinsics,
    extrinsics: Extrinsics | None = None,
    min_depth: float = 0.2,
) -> int:
    """Static bound on the per-pixel splat box edge (pixels).

    A depth pixel's ±0.5-px corner pair spans ``fx_c/fx_d`` color pixels,
    inflated by the worst-case perspective scaling of the depth→color
    extrinsics — a color camera sitting ``|t|`` behind the depth origin
    magnifies a point at ``z`` by up to ``z/(z − |t|)``, worst at
    ``min_depth`` — and by ~7% for rotations up to 20°; plus one pixel for
    the integer rounding of each corner. The reference walks the exact
    data-dependent box (kernels.cu:276-301); this cap only clips boxes the
    bounded geometry cannot produce. The scatter's update count scales
    with the SQUARE of the bound, so a D455-like
    same-resolution pair (ratio ~1.5, 1.5 cm baseline → bound 3) cuts the
    16-offset default cap to 9 entries per pixel.
    """
    import math

    try:
        # All inputs must be CONCRETE to pick a static entry count; when
        # the intrinsics are traced jit arguments (e.g. the jitted pipeline
        # passes framesets as pytrees) keep the conservative default cap.
        rx = float(color_intrinsics.fx) / max(float(depth_intrinsics.fx), 1e-6)
        ry = float(color_intrinsics.fy) / max(float(depth_intrinsics.fy), 1e-6)
        t_norm = 0.0
        rot_deg = 0.0
        if extrinsics is not None:
            import numpy as _np

            t_norm = float(_np.linalg.norm(_np.asarray(extrinsics.translation)))
            tr = float(_np.trace(_np.asarray(extrinsics.rotation)))
            rot_deg = math.degrees(
                math.acos(min(1.0, max(-1.0, (tr - 1.0) / 2.0)))
            )
    except jax.errors.ConcretizationTypeError:
        import warnings

        warnings.warn(
            "auto_footprint: traced intrinsics — falling back to the "
            "conservative splat cap 4; pin FusionConfig.align_footprint "
            "from concrete intrinsics to get the tight bound",
            stacklevel=2,
        )
        return 4
    z_floor = max(min_depth, 1e-3)
    perspective = z_floor / max(z_floor - t_norm, z_floor * 0.25)
    ratio = max(rx, ry) * perspective * 1.07  # rotation margin (≤20° toe-in)
    bound = max(2, int(math.ceil(ratio)) + 1)
    # Outside the calibrated envelope (the perspective term clamps at 4×
    # once |t| ≥ 0.75·z_floor, and the 1.07 margin only covers ≤20° of
    # rotation) the tight formula can UNDER-size the splat box and punch
    # alignment holes with no diagnostic — the very extrinsics trap this
    # bound exists to prevent. Warn and take the conservative cap instead.
    if t_norm > 0.5 * z_floor or rot_deg > 20.0:
        import warnings

        warnings.warn(
            f"auto_footprint: depth→color extrinsics outside the bound's "
            f"envelope (|t|={t_norm:.3f} m vs min_depth={z_floor:.3f} m, "
            f"rotation {rot_deg:.1f}°) — using conservative splat cap "
            f"{max(bound, 8)}; pin FusionConfig.align_footprint manually "
            "to trade coverage for entry count",
            stacklevel=2,
        )
        return max(bound, 8)
    return bound


def align_depth_to_color(
    depth_u16: Array,
    depth_scale,
    depth_intrinsics: Intrinsics,
    color_intrinsics: Intrinsics,
    depth_to_color: Extrinsics,
    max_footprint: int = 4,
    method: str | None = None,
) -> Array:
    """Align a depth image to the color camera's pixel grid.

    Args:
      depth_u16: (Hd, Wd) raw depth.
      depth_scale: meters per LSB.
      max_footprint: static cap on the per-pixel splat box edge length.
      method: ``"scatter"`` does K² masked scatter-mins of the raw depth
        (the oracle-tested reference path). ``"binned"`` factors the K×K
        splat out of the update stream: each depth pixel emits ONE
        scatter-min into a (box-extent-class, x0, y0) bin space — N
        updates instead of K²·N — and the splat is recovered afterwards
        as a minimum over ≤K² SHIFTED class images (elementwise work).
        The two are bit-identical. Default: the platform's choice in
        ops/backend.py.

    Returns:
      (Hc, Wc) uint16 aligned depth.
    """
    if max_footprint == "auto":
        max_footprint = auto_footprint(
            depth_intrinsics, color_intrinsics, depth_to_color
        )
    if method is None:
        method = choose("align")
    if method not in ("scatter", "binned"):
        raise ValueError(f"unknown align method {method!r}")
    dh, dw = depth_u16.shape
    ch, cw = color_intrinsics.height, color_intrinsics.width
    n_px = cw * ch

    u, v = G.pixel_grid(dh, dw)
    z = depth_u16.astype(jnp.float32) * depth_scale
    has_depth = depth_u16 > 0

    x0, y0 = _map_corner(
        u, v, z, -0.5, depth_intrinsics, color_intrinsics, depth_to_color
    )
    x1, y1 = _map_corner(
        u, v, z, +0.5, depth_intrinsics, color_intrinsics, depth_to_color
    )

    # Reference validity: entire box must be inside the color image
    # (kernels.cu:290).
    ok = has_depth & (x0 >= 0) & (y0 >= 0) & (x1 < cw) & (y1 < ch)

    raw = depth_u16.astype(jnp.int32).reshape(-1)
    x0f, y0f = x0.reshape(-1), y0.reshape(-1)
    wx = (x1 - x0).reshape(-1)  # box extents (>= 0 in normal geometry)
    wy = (y1 - y0).reshape(-1)
    okf = ok.reshape(-1)

    if method == "binned":
        k = max_footprint
        maxi = jnp.int32(0x7FFFFFFF)
        # A depth pixel's whole splat is determined by (x0, y0, wx, wy, raw).
        # Bin entries by (extent class, anchor pixel): ONE update per depth
        # pixel into a K²-plane image space — N scatter-min updates instead
        # of the direct path's K²·N. Each class plane then holds, per
        # anchor, the min raw depth of entries with that clipped box
        # extent — and the final image is the min over classes of their
        # plane shifted by every (dy ≤ wy_c, dx ≤ wx_c), recovering the
        # reference's box walk (kernels.cu:294-300) with elementwise mins.
        # Extents clip to the static cap like the scatter path; empty
        # boxes (x1 < x0) drop out.
        wxc = jnp.minimum(wx, k - 1)
        wyc = jnp.minimum(wy, k - 1)
        active = okf & (wx >= 0) & (wy >= 0)
        cls = wyc * k + wxc
        n_bins = n_px * k * k
        idx = jnp.where(active, cls * n_px + y0f * cw + x0f, n_bins)
        vals = jnp.where(active, raw, maxi)
        buf = jnp.full((n_bins + 1,), maxi, jnp.int32)
        buf = buf.at[idx].min(vals, mode="drop")
        planes = buf[:n_bins].reshape(k, k, ch, cw)  # [wy_c, wx_c] anchors
        out = jnp.full((ch, cw), maxi)
        for wy_c in range(k):
            for wx_c in range(k):
                plane = planes[wy_c, wx_c]
                for dy in range(wy_c + 1):
                    for dx in range(wx_c + 1):
                        # anchor (y0, x0) covers (y0+dy, x0+dx): shift the
                        # plane down-right, back-filling with the sentinel.
                        shifted = plane
                        if dy or dx:
                            shifted = jnp.full((ch, cw), maxi).at[
                                dy:, dx:
                            ].set(plane[: ch - dy, : cw - dx])
                        out = jnp.minimum(out, shifted)
        out = jnp.where((out == maxi) | (out == _SENTINEL), 0, out)
        return out.astype(jnp.uint16).reshape(ch, cw)

    out = jnp.full((n_px + 1,), _SENTINEL, jnp.int32)
    for dy in range(max_footprint):
        for dx in range(max_footprint):
            active = okf & (dy <= wy) & (dx <= wx)
            tx = jnp.clip(x0f + dx, 0, cw - 1)
            ty = jnp.clip(y0f + dy, 0, ch - 1)
            idx = jnp.where(active, ty * cw + tx, n_px)
            val = jnp.where(active, raw, _SENTINEL)
            out = out.at[idx].min(val, mode="drop")

    out = out[:n_px]
    out = jnp.where(out == _SENTINEL, 0, out)
    return out.astype(jnp.uint16).reshape(ch, cw)
