"""Pure-numpy reference oracles for every device op.

These mirror the reference CUDA math 1:1 (scalar loops, same order of
operations) and serve the role of the reference's own CPU oracle
`deprojectDepthCpu` (registration_node.cpp:554-592), extended to every kernel.
They are deliberately slow and simple.
"""

from __future__ import annotations

import numpy as np


# --- camera model -----------------------------------------------------------


def deproject_oracle(depth_m, fx, fy, ppx, ppy, coeffs=None, inverse_bc=False):
    """Dense deprojection oracle. depth_m: (H, W) meters -> (H, W, 3)."""
    h, w = depth_m.shape
    pts = np.zeros((h, w, 3), np.float64)
    for v in range(h):
        for u in range(w):
            d = depth_m[v, u]
            x = (u - ppx) / fx
            y = (v - ppy) / fy
            if inverse_bc and coeffs is not None:
                r2 = x * x + y * y
                f = 1 + coeffs[0] * r2 + coeffs[1] * r2**2 + coeffs[4] * r2**3
                ux = x * f + 2 * coeffs[2] * x * y + coeffs[3] * (r2 + 2 * x * x)
                uy = y * f + 2 * coeffs[3] * x * y + coeffs[2] * (r2 + 2 * y * y)
                x, y = ux, uy
            pts[v, u] = (d * x, d * y, d)
    return pts


def project_oracle(points, fx, fy, ppx, ppy):
    """(N, 3) -> (N, 2) continuous pixel coordinates (pinhole)."""
    pts = np.asarray(points, np.float64)
    z = pts[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = pts[:, 0] / z
        y = pts[:, 1] / z
    return np.stack([x * fx + ppx, y * fy + ppy], -1)


def transform_oracle(points, transform):
    """(N, 3) x (4, 4) -> (N, 3)."""
    pts = np.asarray(points, np.float64)
    r = transform[:3, :3]
    t = transform[:3, 3]
    return pts @ r.T + t


# --- z-buffer render --------------------------------------------------------


def project_zbuffer_oracle(points, colors, valid, fx, fy, ppx, ppy, width, height,
                           mirror=False):
    """Sequential z-buffer projection oracle.

    Mirrors kernel_project_pointcloud (kernels.cu:239-274) but resolves the
    color-store race deterministically: for equal depths the point with the
    smallest packed RGB wins (the framework's documented tie-break).
    Returns (image uint8 (H, W, 3), zbuf float (H, W)).
    """
    img = np.zeros((height, width, 3), np.uint8)
    zbuf = np.full((height, width), np.finfo(np.float32).max, np.float64)
    packed = np.full((height, width), 2**24, np.int64)
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    cols = np.asarray(colors).reshape(-1, 3)
    val = np.asarray(valid).reshape(-1)
    for i in range(pts.shape[0]):
        if not val[i]:
            continue
        x, y, z = pts[i]
        if z <= 0:
            continue
        # C cast semantics: truncation toward zero (kernels.cu:249-250).
        px = int(np.float32(x / z * fx + ppx) + np.float32(0.5))
        py = int(np.float32(y / z * fy + ppy) + np.float32(0.5))
        if px < 0 or py < 0 or px > width - 1 or py > height - 1:
            continue
        if mirror:
            px = width - 1 - px
        p = (int(cols[i][0]) << 16) | (int(cols[i][1]) << 8) | int(cols[i][2])
        zf = np.float32(z)
        if zf < zbuf[py, px] or (zf == zbuf[py, px] and p < packed[py, px]):
            zbuf[py, px] = zf
            packed[py, px] = p
            img[py, px] = cols[i]
    return img, zbuf


def winner_oracle(pix, zbits, rgb, n_px):
    """Sequential per-pixel winner of (pixel, z-bits, rgb24) entries: the
    least (z-bits, rgb) pair; entries outside [0, n_px) are dropped.
    Returns (minz, mrgb) int64 arrays, 0x7FFFFFFF where nothing landed."""
    none = 0x7FFFFFFF
    minz = np.full(n_px, none, np.int64)
    mrgb = np.full(n_px, none, np.int64)
    for p, z, c in zip(np.asarray(pix).ravel(), np.asarray(zbits).ravel(),
                       np.asarray(rgb).ravel()):
        if not 0 <= p < n_px:
            continue
        if (z, c) < (minz[p], mrgb[p]):
            minz[p], mrgb[p] = z, c
    return minz, mrgb


# --- filters ----------------------------------------------------------------


def minmax_filter_oracle(depth_u16, depth_scale, min_depth, max_depth):
    """Threshold-to-zero like nppiThreshold_LTValGTVal (kernels.cu:353-369).

    NPP thresholds on raw uint16 against truncated uint16 thresholds.
    """
    lo = np.uint16(min_depth / depth_scale)
    hi = np.uint16(max_depth / depth_scale)
    d = np.asarray(depth_u16, np.uint16).copy()
    d[d < lo] = 0
    d[d > hi] = 0
    return d


def median3x3_oracle(img):
    """Per-channel 3×3 median on the interior; border left untouched.

    Mirrors nppiFilterMedian semantics as invoked (kernels.cu:594-630: ROI is
    the interior, borders keep their input values).
    """
    img = np.asarray(img)
    out = img.copy()
    h, w = img.shape[:2]
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            patch = img[y - 1 : y + 2, x - 1 : x + 2]
            out[y, x] = np.median(patch.reshape(9, -1), axis=0).astype(img.dtype)
    return out


def gauss3x3_oracle(img):
    """Binomial 3×3 Gauss ([1 2 1]⊗[1 2 1]/16) on the interior.

    Rounds half-up like NPP's fixed-point (sum + 8) >> 4 — the kernel is
    an exact binary fraction so x.5 ties are common and half-even (rint)
    would differ by 1 LSB exactly there."""
    img = np.asarray(img).astype(np.float64)
    out = img.copy()
    k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float64) / 16.0
    h, w = img.shape[:2]
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            patch = img[y - 1 : y + 2, x - 1 : x + 2]
            out[y, x] = np.tensordot(k, patch, axes=([0, 1], [0, 1]))
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


CROSS5_SE = np.ones((5, 5), bool)
CROSS5_SE[0, 0] = CROSS5_SE[0, 4] = CROSS5_SE[4, 0] = CROSS5_SE[4, 4] = False
"""5×5 structuring element with zeroed corners (kernels.cu:413-418)."""


def erode_oracle(mask, se=CROSS5_SE):
    h, w = mask.shape
    kh, kw = se.shape
    ah, aw = kh // 2, kw // 2
    pad = np.pad(mask, ((ah, ah), (aw, aw)), mode="edge")
    out = np.zeros_like(mask)
    for y in range(h):
        for x in range(w):
            patch = pad[y : y + kh, x : x + kw]
            out[y, x] = np.all(patch[se])
    return out


def dilate_oracle(mask, se=CROSS5_SE):
    h, w = mask.shape
    kh, kw = se.shape
    ah, aw = kh // 2, kw // 2
    pad = np.pad(mask, ((ah, ah), (aw, aw)), mode="edge")
    out = np.zeros_like(mask)
    for y in range(h):
        for x in range(w):
            patch = pad[y : y + kh, x : x + kw]
            out[y, x] = np.any(patch[se])
    return out


def morph_open_oracle(mask, se=CROSS5_SE):
    return dilate_oracle(erode_oracle(mask, se), se)


def morph_close_oracle(mask, se=CROSS5_SE):
    return erode_oracle(dilate_oracle(mask, se), se)


def temporal_filter_oracle(depth, prev, alpha=0.4, delta=20.0, persistence=True):
    """librealsense temporal filter (valid-2/last-8-frames simplified to
    previous-frame persistence; realsense.cpp:398-404 uses alpha=0.4).

    depth/prev: uint16 frames; returns filtered uint16 + new history.
    """
    d = np.asarray(depth, np.float64)
    p = np.asarray(prev, np.float64)
    out = d.copy()
    have_both = (d > 0) & (p > 0)
    close = np.abs(d - p) <= delta
    blend = have_both & close
    out[blend] = alpha * d[blend] + (1 - alpha) * p[blend]
    if persistence:
        fill = (d == 0) & (p > 0)
        out[fill] = p[fill]
    return np.clip(np.rint(out), 0, 65535).astype(np.uint16)


# --- depth->color alignment -------------------------------------------------


def decimation_filter_oracle(depth_u16, magnitude=2):
    """Scalar rs2 decimation oracle: per-block upper median of nonzero
    depths (librealsense decimation_filter semantics; constructed with
    magnitude 2 at realsense.cpp:244)."""
    d = np.asarray(depth_u16)
    h, w = d.shape
    m = magnitude
    out = np.zeros((h // m, w // m), np.uint16)
    for i in range(h // m):
        for j in range(w // m):
            vals = sorted(
                int(v) for v in d[i * m:(i + 1) * m, j * m:(j + 1) * m].ravel()
                if v != 0
            )
            out[i, j] = vals[len(vals) // 2] if vals else 0
    return out


def spatial_filter_oracle(depth, alpha=0.55, delta=20.0, magnitude=2,
                          holes_fill=0):
    """Scalar rs2 spatial filter oracle: recursive EMA, four sweep
    directions per iteration, gate compares against the FILTERED neighbor
    (alpha 0.55 per realsense.cpp:248). ``holes_fill`` 1..5 adds the rs2
    persistence radii (2/4/8/16/unlimited px): in the LEFT→RIGHT sweep a
    hole inherits the nearest valid value to its left through at most
    `radius` consecutive holes."""
    d = np.asarray(depth)
    integer_domain = np.issubdtype(d.dtype, np.integer)
    # float32 like the implementations (numpy mirror, native C++, and the
    # reference's float math): an f64 blend rounds differently at ties —
    # e.g. 0.55·1 + 0.45·11 is exactly 5.5 in f32 (rounds to 6) but
    # 5.4999999999999996 in f64 (rounds to 5).
    x = d.astype(np.float32)
    h, w = x.shape
    alpha = np.float32(alpha)
    one_m = np.float32(1.0) - alpha
    radius = 0
    if holes_fill:
        radius = w if holes_fill >= 5 else (1 << holes_fill)

    def sweep_row(row, holes_radius=0):
        run = 0
        for u in range(1, len(row)):
            if holes_radius:
                if row[u] == 0:
                    run += 1
                    if row[u - 1] > 0 and run <= holes_radius:
                        row[u] = row[u - 1]
                else:
                    run = 0
            if row[u] > 0 and row[u - 1] > 0 and abs(row[u] - row[u - 1]) <= delta:
                v = row[u] * alpha + row[u - 1] * one_m
                row[u] = np.floor(v + np.float32(0.5)) if integer_domain else v

    for _ in range(magnitude):
        for r in range(h):
            sweep_row(x[r], holes_radius=radius)
        for r in range(h):
            rev = x[r, ::-1].copy()
            sweep_row(rev)
            x[r] = rev[::-1]
        for c in range(w):
            col = x[:, c].copy()
            sweep_row(col)
            x[:, c] = col
        for c in range(w):
            rev = x[::-1, c].copy()
            sweep_row(rev)
            x[:, c] = rev[::-1]
    if integer_domain:
        return np.clip(x, 0, 65535).astype(d.dtype)
    return x.astype(np.float32)


def align_depth_to_color_oracle(
    depth_u16, depth_scale,
    d_fx, d_fy, d_ppx, d_ppy,
    c_fx, c_fy, c_ppx, c_ppy,
    rotation, translation, c_width, c_height,
):
    """Scalar oracle of the two-corner footprint alignment
    (kernels.cu:138-158, :276-301, :714-747)."""
    depth_u16 = np.asarray(depth_u16)
    dh, dw = depth_u16.shape
    out = np.full((c_height, c_width), 0xFFFF, np.uint32)

    def map_pixel(u, v, z):
        x = (u - d_ppx) / d_fx
        y = (v - d_ppy) / d_fy
        pt = np.array([z * x, z * y, z])
        q = rotation @ pt + translation
        px = q[0] / q[2] * c_fx + c_ppx
        py = q[1] / q[2] * c_fy + c_ppy
        return int(px + 0.5), int(py + 0.5)

    for v in range(dh):
        for u in range(dw):
            raw = depth_u16[v, u]
            if raw == 0:
                continue
            z = raw * depth_scale
            p0 = map_pixel(u - 0.5, v - 0.5, z)
            p1 = map_pixel(u + 0.5, v + 0.5, z)
            if p0[0] < 0 or p0[1] < 0 or p1[0] >= c_width or p1[1] >= c_height:
                continue
            for y in range(p0[1], p1[1] + 1):
                for x in range(p0[0], p1[0] + 1):
                    out[y, x] = min(out[y, x], int(raw))
    out[out == 0xFFFF] = 0
    return out.astype(np.uint16)


# --- registration helpers ---------------------------------------------------


def voxel_downsample_oracle(points, leaf):
    """ApproximateVoxelGrid-style: mean of points per occupied voxel
    (registration.cpp voxelFilter). Voxel id by floor(p/leaf)."""
    pts = np.asarray(points, np.float64)
    keys = np.floor(pts / leaf).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    out = np.zeros((len(uniq), 3))
    counts = np.zeros(len(uniq))
    for i, j in enumerate(inv):
        out[j] += pts[i]
        counts[j] += 1
    return out / counts[:, None]


def make_bunny_like_cloud(n=4000, seed=0):
    """Synthetic structured, deliberately asymmetric test cloud standing in
    for the reference's Stanford-bunny golden data
    (registration_node/data/icp_testdata). Asymmetry matters: a symmetric
    object gives rigid registration spurious minima.
    """
    rng = np.random.default_rng(seed)
    n_s = n // 3
    n_b = n // 6
    n_r = n // 6
    n_p = n - n_s - n_b - n_r
    # Off-center hemisphere shell
    phi = rng.uniform(0, np.pi / 2, n_s)
    theta = rng.uniform(0, 2 * np.pi, n_s)
    r = 0.3 + rng.normal(0, 0.003, n_s)
    sphere = np.stack(
        [r * np.sin(phi) * np.cos(theta), r * np.sin(phi) * np.sin(theta), r * np.cos(phi)],
        -1,
    ) + np.array([0.12, -0.05, 0.0])
    # Small bump near one corner
    phi2 = rng.uniform(0, np.pi / 2, n_b)
    th2 = rng.uniform(0, 2 * np.pi, n_b)
    bump = 0.12 * np.stack(
        [np.sin(phi2) * np.cos(th2), np.sin(phi2) * np.sin(th2), np.cos(phi2)], -1
    ) + np.array([-0.35, 0.3, 0.0])
    # A ridge (half-cylinder) along one edge
    tx = rng.uniform(-0.45, 0.1, n_r)
    ang = rng.uniform(0, np.pi, n_r)
    ridge = np.stack(
        [tx, -0.38 + 0.07 * np.cos(ang), 0.07 * np.sin(ang)], -1
    )
    # Rectangular ground patch (not square)
    plane = np.stack(
        [
            rng.uniform(-0.5, 0.5, n_p),
            rng.uniform(-0.42, 0.42, n_p),
            rng.normal(0, 0.002, n_p),
        ],
        -1,
    )
    cloud = np.concatenate([sphere, bump, ridge, plane]) + np.array([0.0, 0.0, 1.0])
    return cloud.astype(np.float32)
