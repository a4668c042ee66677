"""Dense image filters: the NPP-filter-suite equivalent.

Replaces the reference's NPP calls and depth-filter pipeline
(pointcloud_processing/src/kernels.cu:353-540, :594-712, :749-779 and
depth_frame.cpp:153-182) with jnp window ops that XLA fuses into the
surrounding pipeline. All filters keep static shapes; "ROI" semantics are
expressed with masks rather than pointer offsets.

Filter inventory (reference parity):
  * minmax threshold-to-zero          (nppiThreshold_LTValGTVal, kernels.cu:353-369)
  * >0 compare mask with ROI          (nppiCompareC,            kernels.cu:371-395)
  * morphological open/close, 5×5 SE with zeroed corners
                                      (nppiMorph*Border,        kernels.cu:397-499)
  * mask count                        (nppiSum,                 kernels.cu:501-540)
  * color median 3×3 (interior ROI)   (nppiFilterMedian_8u_C3R, kernels.cu:594-630)
  * color Gauss 3×3 (interior ROI)    (nppiFilterGauss_8u_C3R,  kernels.cu:632-653)
  * depth median 3×3                  (nppiFilterMedian_16u,    kernels.cu:655-688)
  * depth Gauss 5×5                   (nppiFilterGauss_16u,     kernels.cu:690-712)
  * depth bilateral Gauss             (nppiFilterBilateralGaussBorder, kernels.cu:749-779)
  * temporal EMA filter               (rs2::temporal_filter,    realsense.cpp:398-404)
"""

from __future__ import annotations


from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


# ---------------------------------------------------------------------------
# Depth range filtering
# ---------------------------------------------------------------------------


def filter_depth_minmax(
    depth_u16: Array, depth_scale, min_depth, max_depth
) -> Array:
    """Zero out depth values outside [min_depth, max_depth] meters.

    NPP semantics: thresholds are computed on the raw uint16 grid with
    truncating casts (kernels.cu:357-359), so comparisons happen in integer
    space.
    """
    lo = (jnp.asarray(min_depth, jnp.float32) / depth_scale).astype(jnp.uint16)
    hi = (jnp.asarray(max_depth, jnp.float32) / depth_scale).astype(jnp.uint16)
    keep = (depth_u16 >= lo) & (depth_u16 <= hi)
    return jnp.where(keep, depth_u16, jnp.zeros_like(depth_u16))


def _clamped_roi(height: int, width: int, roi) -> Tuple[int, int, int, int]:
    """Shared [x, y, w, h] clamping for both ROI-mask builders.

    Negative fields select the full image, like the reference
    (kernels.cu:379-382). A box exceeding the image bounds keeps its
    origin and CLIPS at the edge — deliberately NOT the reference's
    behavior: kernels.cu:381-382 resets the size to the full width/height
    while keeping the offset, so the NPP region overruns each row and
    wraps into the next one (reads/writes past the ROI's rows — a latent
    out-of-bounds bug, documented here instead of reproduced).
    """
    x0, y0, rw, rh = (int(v) for v in roi)
    x0 = max(x0, 0)
    y0 = max(y0, 0)
    rw = width if (rw < 0 or x0 + rw > width) else rw
    rh = height if (rh < 0 or y0 + rh > height) else rh
    return x0, y0, rw, rh


def roi_mask_traced(height: int, width: int, roi) -> Array:
    """:func:`roi_mask` built from iota compares so it traces as cheap
    vector ops instead of an embedded (H, W) bool literal — use inside
    jitted bodies that must not close over large constants (the rig
    paths)."""
    if roi is None:
        return jnp.ones((height, width), bool)
    x0, y0, rw, rh = _clamped_roi(height, width, roi)
    yy = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    return (yy >= y0) & (yy < y0 + rh) & (xx >= x0) & (xx < x0 + rw)


def roi_mask(
    height: int, width: int, roi: Optional[Sequence[int]], dtype=jnp.bool_
) -> Array:
    """Build a rectangular ROI mask [x, y, w, h] as a host-side constant
    (clamping rules: see :func:`_clamped_roi`)."""
    if roi is None:
        return jnp.ones((height, width), dtype)
    x0, y0, rw, rh = _clamped_roi(height, width, roi)
    m = np.zeros((height, width), bool)
    m[y0 : y0 + rh, x0 : x0 + rw] = True
    return jnp.asarray(m, dtype)


def depth_validity_mask(
    depth_u16: Array, roi: Optional[Sequence[int]] = None
) -> Array:
    """depth > 0 within the ROI — the compare-mask stage
    (kernels.cu:371-395). Outside the ROI the mask is False, which is what
    the compacted-index pipeline in the reference effectively produces (it
    only writes mask bytes inside the ROI of a zero-initialised buffer)."""
    h, w = depth_u16.shape
    valid = depth_u16 > 0
    if roi is not None:
        valid = valid & roi_mask(h, w, roi)
    return valid


def mask_count(mask: Array) -> Array:
    """Number of valid pixels (nppiSum equivalent, kernels.cu:501-540)."""
    return jnp.sum(mask.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Morphology (5×5 structuring element with zeroed corners)
# ---------------------------------------------------------------------------

_CROSS5 = np.ones((5, 5), np.bool_)
_CROSS5[0, 0] = _CROSS5[0, 4] = _CROSS5[4, 0] = _CROSS5[4, 4] = False
_CROSS5_OFFSETS = tuple(
    (int(dy) - 2, int(dx) - 2) for dy, dx in np.argwhere(_CROSS5)
)


def _window_reduce(mask: Array, offsets, reduce_fn, init: bool) -> Array:
    """Reduce a boolean image over a set of (dy, dx) offsets with replicate
    padding (NPP_BORDER_REPLICATE). Expressed as shifted slices so XLA turns
    it into fused vector ops instead of a gather."""
    h, w = mask.shape
    pad = 2
    padded = jnp.pad(mask, pad, mode="edge")
    out = jnp.full((h, w), init, mask.dtype)
    for dy, dx in offsets:
        window = jax.lax.dynamic_slice(padded, (pad + dy, pad + dx), (h, w))
        out = reduce_fn(out, window)
    return out


def erode(mask: Array) -> Array:
    """Binary erosion with the 21-point structuring element."""
    return _window_reduce(mask, _CROSS5_OFFSETS, jnp.logical_and, True)


def dilate(mask: Array) -> Array:
    """Binary dilation with the 21-point structuring element."""
    return _window_reduce(mask, _CROSS5_OFFSETS, jnp.logical_or, False)


def morph_open(mask: Array) -> Array:
    """Erosion then dilation (nppiMorphOpenBorder, kernels.cu:397-447).

    Note: disabled at the reference call site (depth_frame.cpp:175-178) but
    part of the public filter API.
    """
    return dilate(erode(mask))


def morph_close(mask: Array) -> Array:
    """Dilation then erosion (nppiMorphCloseBorder, kernels.cu:449-499)."""
    return erode(dilate(mask))


# ---------------------------------------------------------------------------
# Rank / convolution filters
# ---------------------------------------------------------------------------


def _shifted_stack(img: Array, radius: int) -> Array:
    """Stack the (2r+1)² shifted neighborhoods of a 2D/3D image along a new
    leading axis, replicate-padded."""
    h, w = img.shape[:2]
    k = 2 * radius + 1
    pad_width = [(radius, radius), (radius, radius)] + [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad_width, mode="edge")
    stack = []
    for dy in range(k):
        for dx in range(k):
            start = (dy, dx) + (0,) * (img.ndim - 2)
            size = (h, w) + img.shape[2:]
            stack.append(jax.lax.dynamic_slice(padded, start, size))
    return jnp.stack(stack)


def _interior_only(filtered: Array, original: Array, border: int) -> Array:
    """Keep the filter output on the interior, original values on the
    border — NPP's offset-ROI convention as used by the reference
    (kernels.cu:600-609: ROI shrunk by the mask border)."""
    h, w = original.shape[:2]
    row = jnp.arange(h)
    col = jnp.arange(w)
    interior = (
        (row[:, None] >= border)
        & (row[:, None] < h - border)
        & (col[None, :] >= border)
        & (col[None, :] < w - border)
    )
    if original.ndim == 3:
        interior = interior[..., None]
    return jnp.where(interior, filtered, original)


def _median9_network(p):
    """Median of 9 arrays via the classic 19-exchange min/max network —
    far cheaper as elementwise work than a general sort of the stacked axis."""
    def s(a, b):
        return jnp.minimum(a, b), jnp.maximum(a, b)

    p = list(p)
    p[1], p[2] = s(p[1], p[2]); p[4], p[5] = s(p[4], p[5]); p[7], p[8] = s(p[7], p[8])
    p[0], p[1] = s(p[0], p[1]); p[3], p[4] = s(p[3], p[4]); p[6], p[7] = s(p[6], p[7])
    p[1], p[2] = s(p[1], p[2]); p[4], p[5] = s(p[4], p[5]); p[7], p[8] = s(p[7], p[8])
    p[0], p[3] = s(p[0], p[3]); p[5], p[8] = s(p[5], p[8]); p[4], p[7] = s(p[4], p[7])
    p[3], p[6] = s(p[3], p[6]); p[1], p[4] = s(p[1], p[4]); p[2], p[5] = s(p[2], p[5])
    p[4], p[7] = s(p[4], p[7]); p[4], p[2] = s(p[4], p[2]); p[6], p[4] = s(p[6], p[4])
    p[4], p[2] = s(p[4], p[2])
    return p[4]


def median_filter(img: Array, radius: int = 1, interior_roi: bool = True) -> Array:
    """Per-channel square median filter.

    ``interior_roi=True`` reproduces the NPP call pattern: the border keeps
    its input value. radius=1 uses a 19-exchange median-of-9 network;
    larger radii fall back to a stacked sort.
    """
    stack = _shifted_stack(img, radius)
    if radius == 1:
        med = _median9_network([stack[i] for i in range(9)])
    else:
        k2 = stack.shape[0]
        med = jnp.sort(stack, axis=0)[k2 // 2]
    return _interior_only(med, img, radius) if interior_roi else med


def _gauss_kernel_1d(size: int) -> np.ndarray:
    """NPP fixed Gauss kernels are binomial; 3→[1,2,1]/4, 5→[1,4,6,4,1]/16."""
    k = np.array([1.0])
    for _ in range(size - 1):
        k = np.convolve(k, [1.0, 1.0])
    return k / k.sum()


def gauss_filter(
    img: Array, size: int = 3, interior_roi: bool = True
) -> Array:
    """Separable binomial Gauss filter (uint8/uint16 in, same dtype out).

    Rounds HALF-UP (floor(x+0.5)) like NPP's fixed-point path
    ((sum + (1<<(shift-1))) >> shift on non-negative sums) — NOT
    jnp.round's half-to-even: the binomial kernels are exact binary
    fractions, so x.5 ties are common and exact in f32, and the two rules
    differ by 1 LSB exactly there. Same convention as _spatial_sweep.
    All arithmetic is exact in f32 up to the 5×5 u16 case
    (256·65535 < 2²⁴), so this matches integer NPP bit-for-bit."""
    radius = size // 2
    k1 = _gauss_kernel_1d(size)
    x = img.astype(jnp.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    pad = [(radius, radius), (0, 0), (0, 0)]
    xp = jnp.pad(x, pad, mode="edge")
    rows = sum(
        k1[i] * jax.lax.dynamic_slice_in_dim(xp, i, x.shape[0], axis=0)
        for i in range(size)
    )
    pad = [(0, 0), (radius, radius), (0, 0)]
    rp = jnp.pad(rows, pad, mode="edge")
    out = sum(
        k1[i] * jax.lax.dynamic_slice_in_dim(rp, i, x.shape[1], axis=1)
        for i in range(size)
    )
    out = jnp.clip(
        jnp.floor(out + 0.5), 0, float(jnp.iinfo(img.dtype).max)
    ).astype(img.dtype)
    if squeeze:
        out = out[..., 0]
    return _interior_only(out, img, radius) if interior_roi else out


def filter_color(color: Array, use_median: bool) -> Array:
    """Fused-image color filter: 3×3 median or 3×3 Gauss, selected like the
    reference's ``use_median_filter`` switch (frameset.cpp filterColor →
    kernels.cu:594-653).

    Runs channel-planar ((3, H, W) via vmap) so the minor dimension is the
    image width rather than the 3-channel axis.
    """
    planar = jnp.moveaxis(color, -1, 0)
    if use_median:
        out = jax.vmap(lambda c: median_filter(c, 1))(planar)
    else:
        out = jax.vmap(lambda c: gauss_filter(c, 3))(planar)
    return jnp.moveaxis(out, 0, -1)


def filter_color_planar(r: Array, g: Array, b: Array, use_median: bool) -> Array:
    """:func:`filter_color` on already-planar (H, W) channel planes.

    Identical math (3×3 median / Gauss per channel) but avoids the
    (H, W, 3) ↔ (3, H, W) relayout round-trip and the vmap: channels stay
    width-major through the filter and are stacked to HWC exactly once.
    """
    if use_median:
        f = lambda c: median_filter(c, 1)  # noqa: E731
    else:
        f = lambda c: gauss_filter(c, 3)  # noqa: E731
    return jnp.stack([f(r), f(g), f(b)], axis=-1)


def bilateral_filter_depth(
    depth_u16: Array,
    radius: int = 10,
    val_square_sigma: float = 9_000_000.0,
    pos_square_sigma: float = 10_000.0,
) -> Array:
    """Bilateral Gauss on uint16 depth (kernels.cu:749-779 parameters).

    Note: unused in the reference main path; provided for parity. The
    (2r+1)² window is materialised as shifted slices — at r=10 this is 441
    shifts, so call it off the hot path.
    """
    h, w = depth_u16.shape
    x = depth_u16.astype(jnp.float32)
    k = 2 * radius + 1
    padded = jnp.pad(x, radius, mode="edge")
    num = jnp.zeros((h, w), jnp.float32)
    den = jnp.zeros((h, w), jnp.float32)
    for dy in range(k):
        for dx in range(k):
            win = jax.lax.dynamic_slice(padded, (dy, dx), (h, w))
            gd = (dy - radius) ** 2 + (dx - radius) ** 2
            wg = np.exp(-gd / (2.0 * pos_square_sigma))
            vd = (win - x) ** 2
            wv = jnp.exp(-vd / (2.0 * val_square_sigma))
            wgt = wg * wv
            num = num + wgt * win
            den = den + wgt
    out = num / jnp.maximum(den, 1e-12)
    return jnp.clip(jnp.round(out), 0, 65535).astype(jnp.uint16)


# ---------------------------------------------------------------------------
# Temporal filter (librealsense rs2::temporal_filter equivalent)
# ---------------------------------------------------------------------------


def temporal_filter(
    depth_u16: Array,
    prev_u16: Array,
    alpha: float = 0.4,
    delta: float = 20.0,
    persistence: bool = True,
) -> Tuple[Array, Array]:
    """One step of the temporal EMA filter.

    Semantics follow the rs2 temporal filter as configured by the reference
    (smooth_alpha = 0.4, realsense.cpp:249; delta default 20): where both the
    current and previous frames are valid and within ``delta`` raw units,
    blend ``alpha·cur + (1-alpha)·prev``; where the current frame is invalid
    and persistence is enabled, hold the previous value.

    Returns (filtered, new_history). Use with ``lax.scan`` over a frame
    sequence or carry the history through the host feeder.
    """
    cur = depth_u16.astype(jnp.float32)
    prev = prev_u16.astype(jnp.float32)
    have_both = (cur > 0) & (prev > 0)
    close = jnp.abs(cur - prev) <= delta
    blended = alpha * cur + (1.0 - alpha) * prev
    out = jnp.where(have_both & close, blended, cur)
    if persistence:
        out = jnp.where((cur == 0) & (prev > 0), prev, out)
    out_u16 = jnp.clip(jnp.round(out), 0, 65535).astype(jnp.uint16)
    return out_u16, out_u16


# ---------------------------------------------------------------------------
# Hole filling (rs2::hole_filling_filter equivalent)
# ---------------------------------------------------------------------------


def hole_fill(depth_u16: Array, mode: str = "farthest") -> Array:
    """Fill zero-depth holes, matching the rs2 hole-filling filter modes
    (configured by the reference with HOLES_FILL=1, realsense.cpp:250,
    though inactive in its default pipeline):

      * ``left``     — fill from the previous valid pixel in the row
        (rs2 mode 0); an O(log W) associative scan.
      * ``farthest`` — the farthest valid value in the 3×3 neighborhood
        (rs2 mode 1).
      * ``nearest``  — the nearest valid value in the 3×3 neighborhood
        (rs2 mode 2).
    """
    d = depth_u16.astype(jnp.int32)
    hole = d == 0
    if mode == "left":
        # Forward-fill along rows: carry the last valid value.
        def combine(a, b):
            return jnp.where(b > 0, b, a)

        filled = jax.lax.associative_scan(combine, d, axis=1)
        out = jnp.where(hole, filled, d)
        return out.astype(jnp.uint16)

    stack = _shifted_stack(d, 1)  # (9, H, W)
    if mode == "farthest":
        nb = jnp.max(stack, axis=0)
    elif mode == "nearest":
        big = jnp.where(stack > 0, stack, jnp.int32(1 << 30))
        nb = jnp.min(big, axis=0)
        nb = jnp.where(nb == (1 << 30), 0, nb)
    else:
        raise ValueError(f"unknown hole_fill mode {mode!r}")
    out = jnp.where(hole, nb, d)
    return out.astype(jnp.uint16)


# ---------------------------------------------------------------------------
# Decimation filter (rs2::decimation_filter equivalent)
# ---------------------------------------------------------------------------


def decimation_filter(depth_u16: Array, magnitude: int = 2) -> Array:
    """Depth decimation: per-block median of the NONZERO values.

    Matches librealsense's decimation_filter semantics as constructed by the
    reference (FILTER_MAGNITUDE 2, realsense.cpp:244): each magnitude×
    magnitude block contributes the upper median (`sorted[count/2]`) of its
    nonzero depths, or 0 when the whole block is holes. Output is
    (H/magnitude, W/magnitude); H and W must divide evenly (librealsense
    pads the output to a multiple of 4 for SIMD — an implementation detail
    not reproduced here).
    """
    h, w = depth_u16.shape
    m = int(magnitude)
    if m <= 1:
        return depth_u16
    if h % m or w % m:
        raise ValueError(f"image {h}x{w} not divisible by magnitude {m}")
    blocks = depth_u16.reshape(h // m, m, w // m, m)
    vals = jnp.moveaxis(blocks, (1, 3), (2, 3)).reshape(h // m, w // m, m * m)
    vals = vals.astype(jnp.int32)
    # Upper median of nonzero values: sort with zeros pushed to the FRONT
    # (they sort first naturally), then index (zeros + count/2) =
    # (k - count + count/2) = k - (count+1)/2 ... derived below.
    s = jnp.sort(vals, axis=-1)  # zeros first, then nonzero ascending
    count = jnp.sum(vals > 0, axis=-1)
    k = m * m
    # nonzero values occupy s[k-count:]; upper median = s[k-count + count//2].
    idx = jnp.clip(k - count + count // 2, 0, k - 1)
    med = jnp.take_along_axis(s, idx[..., None], axis=-1)[..., 0]
    return jnp.where(count > 0, med, 0).astype(jnp.uint16)


def decimate_intrinsics(intr, magnitude: int = 2):
    """Scale intrinsics for a decimated stream (librealsense updates the
    stream profile the same way: all linear quantities divided by the
    magnitude)."""
    from pointcloud_depthfusion_tpu.core.camera import Intrinsics  # noqa: PLC0415

    m = int(magnitude)
    if m <= 1:
        return intr
    return Intrinsics.create(
        intr.width // m,
        intr.height // m,
        fx=float(intr.fx) / m,
        fy=float(intr.fy) / m,
        ppx=float(intr.ppx) / m,
        ppy=float(intr.ppy) / m,
        model=intr.model,
        coeffs=np.asarray(intr.coeffs, np.float32),
    )


# ---------------------------------------------------------------------------
# Spatial edge-preserving filter (rs2::spatial_filter equivalent)
# ---------------------------------------------------------------------------


def _spatial_sweep(x: Array, alpha: float, delta: float, integer_domain: bool,
                   holes_radius: int = 0):
    """One left→right recursive EMA sweep along axis 1 (vectorized over
    rows). The recurrence is data-dependent (the gate compares against the
    FILTERED previous value), so it is a lax.scan, not an associative scan.

    ``holes_radius > 0`` adds the rs2 hole-persistence behavior to THIS
    sweep: a hole (0) within ``holes_radius`` pixels of the last valid
    value to its left inherits that value exactly (left-value fill); hole
    runs longer than the radius stay 0 past it. The filled value then
    participates as the carry like any valid pixel.
    """

    if holes_radius:
        def step(carry, col):
            prev, run = carry
            is_hole = col == 0
            run = jnp.where(is_hole, run + 1, 0)
            fill = is_hole & (prev > 0) & (run <= holes_radius)
            col = jnp.where(fill, prev, col)
            gate = (col > 0) & (prev > 0) & (jnp.abs(col - prev) <= delta)
            blended = col * alpha + prev * (1.0 - alpha)
            if integer_domain:
                blended = jnp.floor(blended + 0.5)
            out = jnp.where(gate, blended, col)
            return (out, run), out

        init = (x[:, 0], jnp.zeros_like(x[:, 0], jnp.int32))
        _, cols = jax.lax.scan(step, init, jnp.moveaxis(x[:, 1:], 1, 0))
        return jnp.concatenate([x[:, :1], jnp.moveaxis(cols, 0, 1)], axis=1)

    def step(carry, col):
        gate = (col > 0) & (carry > 0) & (jnp.abs(col - carry) <= delta)
        blended = col * alpha + carry * (1.0 - alpha)
        if integer_domain:
            # librealsense stores (T)(filtered + 0.5f): round half up.
            blended = jnp.floor(blended + 0.5)
        out = jnp.where(gate, blended, col)
        return out, out

    init = x[:, 0]
    _, cols = jax.lax.scan(step, init, jnp.moveaxis(x[:, 1:], 1, 0))
    return jnp.concatenate([x[:, :1], jnp.moveaxis(cols, 0, 1)], axis=1)


def spatial_holes_radius(holes_fill: int, width: int) -> int:
    """rs2 spatial-filter holes_fill option → persistence radius in pixels:
    0 disabled, 1..4 → 2/4/8/16, 5 → unlimited (the row width)."""
    holes_fill = int(holes_fill)
    if not 0 <= holes_fill <= 5:
        raise ValueError(f"holes_fill must be 0..5, got {holes_fill}")
    if holes_fill == 0:
        return 0
    if holes_fill == 5:
        return int(width)
    return 1 << holes_fill


def spatial_filter(
    depth: Array,
    alpha: float = 0.55,
    delta: float = 20.0,
    magnitude: int = 2,
    holes_fill: int = 0,
) -> Array:
    """rs2 spatial edge-preserving filter (1D recursive EMA, four sweep
    directions per iteration, ``magnitude`` iterations).

    Parameters follow the reference's construction (smooth_alpha 0.55,
    realsense.cpp:248; delta 20 and magnitude 2 are the librealsense
    defaults it leaves untouched). Where adjacent values are both valid and
    within ``delta``, blend ``alpha·cur + (1-alpha)·prev_filtered``; the
    edge gate compares against the already-filtered neighbor, which is what
    makes the filter edge-preserving rather than a separable blur.
    Works on uint16 depth (librealsense's rounding reproduced) or float32
    disparity.

    ``holes_fill`` selects the rs2 hole-persistence radius (the SDK option
    set the reference's spatial filter configuration exposes,
    realsense.cpp:245-247): 0 disabled (the reference's active value),
    1→2 px, 2→4, 3→8, 4→16, 5→unlimited. Persistence is applied during the
    left→right sweep of every iteration: a hole inherits the nearest valid
    value to its LEFT, propagated through at most `radius` consecutive
    holes. Identical semantics in the numpy/native host mirrors
    (ops/host_filters.py, runtime/pdf_runtime.cpp) and the scalar oracle.
    """
    holes_radius = spatial_holes_radius(holes_fill, depth.shape[1])
    integer_domain = jnp.issubdtype(depth.dtype, jnp.integer)
    x = depth.astype(jnp.float32)
    for _ in range(int(magnitude)):
        x = _spatial_sweep(x, alpha, delta, integer_domain,
                           holes_radius=holes_radius)  # left→right
        x = _spatial_sweep(x[:, ::-1], alpha, delta, integer_domain)[:, ::-1]
        xt = jnp.swapaxes(x, 0, 1)
        xt = _spatial_sweep(xt, alpha, delta, integer_domain)  # top→bottom
        xt = _spatial_sweep(xt[:, ::-1], alpha, delta, integer_domain)[:, ::-1]
        x = jnp.swapaxes(xt, 0, 1)
    if integer_domain:
        return jnp.clip(x, 0, 65535).astype(depth.dtype)
    return x


# ---------------------------------------------------------------------------
# Disparity transforms (rs2::disparity_transform equivalents)
# ---------------------------------------------------------------------------


def depth_to_disparity(
    depth_u16: Array, depth_scale, fx, baseline_m: float = 0.095
) -> Array:
    """Z16 depth → float32 disparity (pixels): ``fx · baseline / depth_m``.

    The rs2 depth↔disparity transform pair the reference constructs
    (realsense.cpp:240-241); 0 depth maps to 0 disparity. baseline defaults
    to the D455 stereo baseline (~95 mm).
    """
    depth_m = depth_u16.astype(jnp.float32) * jnp.float32(depth_scale)
    factor = jnp.float32(fx) * jnp.float32(baseline_m)
    return jnp.where(depth_u16 > 0, factor / jnp.maximum(depth_m, 1e-9), 0.0)


def disparity_to_depth(
    disparity: Array, depth_scale, fx, baseline_m: float = 0.095
) -> Array:
    """float32 disparity → Z16 depth (inverse of :func:`depth_to_disparity`,
    rounded to the nearest raw depth unit)."""
    factor = jnp.float32(fx) * jnp.float32(baseline_m)
    depth_m = jnp.where(disparity > 0, factor / jnp.maximum(disparity, 1e-9), 0.0)
    raw = depth_m / jnp.float32(depth_scale)
    return jnp.clip(jnp.round(raw), 0, 65535).astype(jnp.uint16)


# ---------------------------------------------------------------------------
# The composed depth filter stage (reference DepthFrame::filter pipeline)
# ---------------------------------------------------------------------------


def filter_depth(
    depth_u16: Array,
    depth_scale,
    min_depth,
    max_depth,
    roi: Optional[Sequence[int]] = None,
    use_morphology: bool = False,
) -> Tuple[Array, Array]:
    """The composed per-frame depth filter: minmax → mask(ROI) [→ open/close].

    Mirrors DepthFrame::filter (depth_frame.cpp:153-182); morphology is off
    by default, matching the disabled call site (depth_frame.cpp:175-178).
    Where the reference then compacts indices, we return the dense mask —
    the replacement for compactor.cuh (SURVEY.md §2.7 item 2).

    Returns (filtered_depth_u16, valid_mask).
    """
    d = filter_depth_minmax(depth_u16, depth_scale, min_depth, max_depth)
    valid = depth_validity_mask(d, roi)
    if use_morphology:
        valid = morph_close(morph_open(valid))
    d = jnp.where(valid, d, jnp.zeros_like(d))
    return d, valid
