"""Voxel hashing, downsampling, and per-voxel Gaussian statistics.

Replaces PCL's ApproximateVoxelGrid (registration.cpp
voxelFilter) and for the voxel-distribution machinery inside FastVGICPCuda
(SURVEY.md §2.7 items 4-5). Everything is dense and statically shaped:

  * a fixed-size hash table (power-of-two slots) indexed by a spatial hash
    of integer voxel coordinates;
  * scatter-adds accumulate per-voxel count / mean / second moment;
  * "downsampled cloud" = the table of voxel means + occupancy mask — no
    compaction, downstream consumers mask on ``count > 0``.

Hash collisions merge distinct voxels' statistics. PCL's
ApproximateVoxelGrid has exactly the same failure mode (its fixed-size hash
has no collision resolution), which is why it is "approximate"; table sizes
default to ≥4× the expected occupied-voxel count to keep collisions rare.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

# Large odd constants for the spatial hash (Teschner et al. style).
# Plain Python ints, NOT jnp.uint32: module-level device constants
# initialize the JAX backend at import time. They multiply u32 arrays, so
# weak promotion keeps the arithmetic in u32 with wraparound semantics
# unchanged.
_H1 = 73856093
_H2 = 19349669
_H3 = 83492791


def voxel_coords(points: Array, resolution) -> Array:
    """Integer voxel coordinates floor(p / resolution), int32 (..., 3)."""
    return jnp.floor(points / resolution).astype(jnp.int32)


def hash_coords(coords: Array, table_size: int) -> Array:
    """Spatial hash of integer voxel coords into [0, table_size).

    Additive combine + murmur3 finalizer: the classic XOR-of-products hash
    collides pathologically in the masked low bits for the small coordinate
    ranges point clouds produce (measured 13% collisions at 393 voxels in a
    2^15 table; the finalizer brings it to the birthday bound).
    table_size must be a power of two (masked modulo).
    """
    if table_size & (table_size - 1):
        # ValueError, not assert: under python -O the check would vanish
        # and `h & (table_size-1)` silently corrupts the hash mask.
        raise ValueError(f"table_size {table_size} must be a power of 2")
    c = coords.astype(jnp.uint32)
    return hash_coords_planar(c[..., 0], c[..., 1], c[..., 2], table_size)


def hash_coords_planar(cx: Array, cy: Array, cz: Array, table_size: int) -> Array:
    """:func:`hash_coords` on separate coordinate planes (SoA hot paths
    keep the minor dimension long instead of trailing (..., 3) axes)."""
    if table_size & (table_size - 1):
        # ValueError, not assert: under python -O the check would vanish
        # and `h & (table_size-1)` silently corrupts the hash mask.
        raise ValueError(f"table_size {table_size} must be a power of 2")
    h = (
        cx.astype(jnp.uint32) * _H1
        + cy.astype(jnp.uint32) * _H2
        + cz.astype(jnp.uint32) * _H3
    )
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & jnp.uint32(table_size - 1)).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Per-voxel Gaussian statistics in a fixed-size hash table."""

    count: Array  # (M,) float32 — number of points (or total weight)
    mean: Array  # (M, 3)
    cov: Array  # (M, 3, 3) — population covariance (E[ppᵀ] - μμᵀ)
    # (M, 3) int32 — representative voxel coords: the voxel of the
    # lowest-index point that hashed into the slot (a REAL member triple, so
    # when two voxels collide one of them stays matchable; INT32_MAX where
    # empty). Consumers collision-check lookups against these coords.
    coords: Array
    resolution: Array  # scalar

    @property
    def table_size(self) -> int:
        return self.count.shape[0]

    def occupied(self, min_points: float = 1.0) -> Array:
        return self.count >= min_points


def build_voxel_grid(
    points: Array,
    valid: Array,
    resolution,
    table_size: int = 1 << 15,
) -> VoxelGrid:
    """Accumulate per-voxel count/mean/covariance statistics.

    Invalid points are routed to a dump slot (index table_size) and dropped.
    On a GPU the scatter-adds are float atomics, so the sums depend on the
    order the updates land in, to the last bits.
    """
    pts = points.reshape(-1, 3).astype(jnp.float32)
    val = valid.reshape(-1)
    coords = voxel_coords(pts, resolution)

    idx = jnp.where(val, hash_coords(coords, table_size), table_size)

    w = val.astype(jnp.float32)

    # The second-moment matrix is symmetric, so 6 components suffice.
    def acc(values):
        return (
            jnp.zeros((table_size + 1,), jnp.float32)
            .at[idx]
            .add(values * w, mode="drop")[:table_size]
        )

    count = jnp.zeros((table_size + 1,), jnp.float32).at[idx].add(
        w, mode="drop"
    )[:table_size]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    psum = jnp.stack([acc(x), acc(y), acc(z)], axis=-1)
    p6 = jnp.stack(
        [acc(x * x), acc(x * y), acc(x * z), acc(y * y), acc(y * z),
         acc(z * z)],
        axis=-1,
    )
    # Representative coords via min point index + gather: a componentwise
    # coordinate min would mix components of different colliding voxels into
    # a triple belonging to neither (dropping BOTH voxels at lookup); the
    # lowest-index member's coords keep one of them alive.
    n_pts = pts.shape[0]
    sentinel = jnp.uint32(0xFFFFFFFF)
    rep_u32 = (
        jnp.full((table_size + 1,), sentinel, jnp.uint32)
        .at[idx]
        .min(
            jnp.where(val, jnp.arange(n_pts, dtype=jnp.uint32), sentinel),
            mode="drop",
        )
    )[:table_size]
    rep_idx = jnp.where(
        rep_u32 != sentinel, rep_u32, jnp.uint32(0x7FFFFFFF)
    ).astype(jnp.int32)
    return _finalize_grid(count, psum, p6, rep_idx, coords, resolution)


def _finalize_grid(
    count: Array,
    psum: Array,
    p6: Array,
    rep_idx: Array,
    coords: Array,
    resolution,
) -> VoxelGrid:
    """Grid finalization: expand the symmetric-6 second moment, resolve
    representative coords (INT32_MAX rep_idx = empty slot), divide out the
    counts."""
    row0 = jnp.stack([p6[:, 0], p6[:, 1], p6[:, 2]], axis=-1)
    row1 = jnp.stack([p6[:, 1], p6[:, 3], p6[:, 4]], axis=-1)
    row2 = jnp.stack([p6[:, 2], p6[:, 4], p6[:, 5]], axis=-1)
    ppsum = jnp.stack([row0, row1, row2], axis=-2)

    has_rep = rep_idx != jnp.int32(0x7FFFFFFF)
    safe_idx = jnp.where(has_rep, rep_idx, 0)
    rep = jnp.where(
        has_rep[:, None], coords[safe_idx], jnp.iinfo(jnp.int32).max
    )

    safe = jnp.maximum(count, 1.0)
    mean = psum / safe[:, None]
    cov = ppsum / safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    return VoxelGrid(
        count=count,
        mean=mean,
        cov=cov,
        coords=rep,
        resolution=jnp.asarray(resolution, jnp.float32),
    )


def voxel_downsample(
    points: Array,
    valid: Array,
    leaf_size,
    table_size: int = 1 << 15,
) -> Tuple[Array, Array]:
    """ApproximateVoxelGrid: one mean point per occupied voxel.

    Returns (points (M, 3), valid (M,)) — the fixed-shape downsampled cloud.
    """
    grid = build_voxel_grid(points, valid, leaf_size, table_size)
    return grid.mean, grid.occupied()


def smallest_eigenvector_3x3(a: Array) -> Array:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Closed-form (trigonometric/Cardano eigenvalues + cross-product null
    vector) — pure elementwise math, no batched LAPACK call.
    """
    # Slice to component PLANES immediately; everything below is scalar
    # plane arithmetic.
    a11 = a[..., 0, 0]
    a22 = a[..., 1, 1]
    a33 = a[..., 2, 2]
    a12 = 0.5 * (a[..., 0, 1] + a[..., 1, 0])
    a13 = 0.5 * (a[..., 0, 2] + a[..., 2, 0])
    a23 = 0.5 * (a[..., 1, 2] + a[..., 2, 1])

    q = (a11 + a22 + a33) / 3.0
    b11, b22, b33 = a11 - q, a22 - q, a33 - q
    p2 = (
        b11 * b11 + b22 * b22 + b33 * b33
        + 2.0 * (a12 * a12 + a13 * a13 + a23 * a23)
    ) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    inv_p = 1.0 / p
    # Cofactor determinant of b/p (jnp.linalg.det lowers to a slow LU).
    d11, d22, d33 = b11 * inv_p, b22 * inv_p, b33 * inv_p
    d12, d13, d23 = a12 * inv_p, a13 * inv_p, a23 * inv_p
    det_bn = (
        d11 * (d22 * d33 - d23 * d23)
        - d12 * (d12 * d33 - d23 * d13)
        + d13 * (d12 * d23 - d22 * d13)
    )
    r = jnp.clip(det_bn / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # Smallest eigenvalue: q + 2p cos(phi + 2π/3).
    lam = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    m11, m22, m33 = a11 - lam, a22 - lam, a33 - lam
    m12, m13, m23 = a12, a13, a23
    # Null vector of m: the largest cross product of row pairs.
    c01 = (
        m12 * m23 - m13 * m22,
        m13 * m12 - m11 * m23,
        m11 * m22 - m12 * m12,
    )
    c02 = (
        m12 * m33 - m13 * m23,
        m13 * m13 - m11 * m33,
        m11 * m23 - m12 * m13,
    )
    c12 = (
        m22 * m33 - m23 * m23,
        m23 * m13 - m12 * m33,
        m12 * m23 - m22 * m13,
    )
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    pick01 = (n01 >= n02) & (n01 >= n12)
    pick02 = n02 >= n12
    bx, by, bz = (
        jnp.where(pick01, c01[i], jnp.where(pick02, c02[i], c12[i]))
        for i in range(3)
    )
    norm2 = bx * bx + by * by + bz * bz
    norm = jnp.sqrt(norm2)
    inv_n = 1.0 / jnp.maximum(norm, 1e-30)
    # Degenerate (isotropic / zero) covariance: any direction works.
    ok = norm > 1e-12
    return jnp.stack(
        [
            jnp.where(ok, bx * inv_n, 0.0),
            jnp.where(ok, by * inv_n, 0.0),
            jnp.where(ok, bz * inv_n, 1.0),
        ],
        axis=-1,
    )


def regularize_covariances(
    cov: Array, mode: str = "plane", eps: float = 1e-3
) -> Array:
    """GICP covariance regularization.

    ``plane`` (the GICP/VGICP default): eigenvalues are replaced by
    (eps, 1, 1) — every distribution becomes a disc, so the cost measures
    plane-to-plane distance. Computed as ``I - (1-eps)·n nᵀ`` with n the
    smallest-eigenvalue eigenvector (no eigendecomposition needed).
    ``norm``: adds eps·trace/3·I (cheap isotropic fallback).
    """
    if mode == "norm":
        tr = jnp.trace(cov, axis1=-2, axis2=-1)[..., None, None]
        return cov + eps * (tr / 3.0 + 1e-9) * jnp.eye(3, dtype=cov.dtype)
    n = smallest_eigenvector_3x3(cov)
    eye = jnp.eye(3, dtype=cov.dtype)
    return eye - (1.0 - eps) * n[..., :, None] * n[..., None, :]


def neighborhood_moments(
    grid: VoxelGrid, include_cov: bool = True
) -> Tuple[Array, Array, Optional[Array]]:
    """Aggregate each occupied voxel's 3×3×3 neighborhood statistics.

    ``include_cov=False`` skips the 6 second-moment channels end to end —
    (M, 7) gather rows, no covariance accumulate/reconstruct — and returns
    cov=None; the outlier gate (statistical_outlier_removal) only consumes
    count+mean, so the pooled covariances would be dead per-tick work there.

    Returns (count (M,), mean (M,3), cov (M,3,3)) where the moments pool the
    voxel and its 26 face/edge/corner neighbors. This is the dense
    stand-in for fast_gicp's kNN-based per-point covariances: at fine
    resolutions a single voxel holds too few points for a stable covariance
    (degenerate distributions starve the solver of correspondences), while
    the pooled neighborhood recovers the local surface orientation.

    Neighbor lookups are hash gathers, collision-checked against the stored
    representative coords. All per-neighbor fields ride in ONE (M, 13) row
    gather — count, raw first moment (3), symmetric second moment (6), and
    the bitcast coords (3) — instead of four separate gathers.

    Exact collision-check semantics do not survive a push-style (scatter)
    sum: an entry's validity depends on the TARGET slot's representative
    coords. The separable 3-pass variant changes semantics through empty
    intermediate voxels — also rejected (tested).
    """
    m = grid.table_size

    # Reconstruct raw sums from the stored moments; pack the gather table.
    psum = grid.mean * grid.count[:, None]
    ppsum = (
        grid.cov + grid.mean[:, :, None] * grid.mean[:, None, :]
    ) * grid.count[:, None, None]
    pp6 = jnp.stack(
        [
            ppsum[:, 0, 0], ppsum[:, 0, 1], ppsum[:, 0, 2],
            ppsum[:, 1, 1], ppsum[:, 1, 2], ppsum[:, 2, 2],
        ],
        axis=-1,
    )
    coords_f = jax.lax.bitcast_convert_type(grid.coords, jnp.float32)
    parts = [grid.count[:, None], psum]
    if include_cov:
        parts.append(pp6)
    parts.append(coords_f)
    table = jnp.concatenate(parts, axis=-1)  # (M, 13) or (M, 7)
    coord_col = 10 if include_cov else 4

    count_n = jnp.zeros_like(grid.count)
    psum_n = jnp.zeros_like(grid.mean)
    pp6_n = jnp.zeros_like(pp6)

    own_occ = grid.count > 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                off = jnp.asarray([dx, dy, dz], jnp.int32)
                ncoords = grid.coords + off
                idx = hash_coords(ncoords, m)
                rows = table[idx]  # one row gather per neighbor
                rcoords = jax.lax.bitcast_convert_type(
                    rows[:, coord_col : coord_col + 3], jnp.int32
                )
                hit = (
                    own_occ
                    & (rows[:, 0] > 0)
                    & jnp.all(rcoords == ncoords, axis=-1)
                )
                w = hit.astype(jnp.float32)
                count_n = count_n + w * rows[:, 0]
                psum_n = psum_n + w[:, None] * rows[:, 1:4]
                if include_cov:
                    pp6_n = pp6_n + w[:, None] * rows[:, 4:10]

    safe = jnp.maximum(count_n, 1.0)
    mean_n = psum_n / safe[:, None]
    if not include_cov:
        return count_n, mean_n, None
    r0 = jnp.stack([pp6_n[:, 0], pp6_n[:, 1], pp6_n[:, 2]], -1)
    r1 = jnp.stack([pp6_n[:, 1], pp6_n[:, 3], pp6_n[:, 4]], -1)
    r2 = jnp.stack([pp6_n[:, 2], pp6_n[:, 4], pp6_n[:, 5]], -1)
    ppsum_n = jnp.stack([r0, r1, r2], axis=-2)
    cov_n = ppsum_n / safe[:, None, None] - mean_n[:, :, None] * mean_n[:, None, :]
    return count_n, mean_n, cov_n


def lookup_voxels(
    grid: VoxelGrid, points: Array, min_points: float = 6.0
) -> Tuple[Array, Array, Array]:
    """Gather each query point's voxel statistics (VGICP DIRECT1 mode).

    Returns (mean (N,3), cov (N,3,3), found (N,)) where ``found`` also
    verifies the stored representative coords to reject hash collisions
    with empty slots.
    """
    coords = voxel_coords(points, grid.resolution)
    idx = hash_coords(coords, grid.table_size)
    mean = grid.mean[idx]
    cov = grid.cov[idx]
    cnt = grid.count[idx]
    rep = grid.coords[idx]
    same_voxel = jnp.all(rep == coords, axis=-1)
    found = (cnt >= min_points) & same_voxel
    return mean, cov, found


def statistical_outlier_removal(
    points: Array,
    valid: Array,
    resolution,
    stddev_mul_thresh: float = 1.0,
    table_size: int = 1 << 15,
) -> Array:
    """Sparse-outlier rejection: the dense-array equivalent of PCL's
    StatisticalOutlierRemoval (declared by the reference solver,
    registration.cpp:156-163: setMeanK / setStddevMulThresh).

    PCL computes each point's mean distance to its k nearest neighbors and
    discards points whose statistic exceeds mean + mult·stddev of the
    global distribution. Exact kNN is an O(N²)/tree op that maps poorly to
    XLA; the design inversion keeps PCL's *gate* (global mean/std
    thresholding of a local-sparsity statistic) but swaps the statistic
    for voxel-neighborhood machinery the grid already has:

      d_i = distance from p_i to the centroid of the OTHER points in its
            3×3×3 voxel neighborhood at ``resolution``
            (self-excluded — an isolated point must not score 0);
      d_i = 4·resolution (beyond any in-neighborhood distance) when the
            point has no neighbors at all — PCL's far-kNN case.

    ``resolution`` plays mean_k's role as the locality scale: choose it so
    a typical inlier has O(mean_k) points within its neighborhood.

    Returns the filtered validity mask (dense-mask discipline, no
    compaction). Pure jnp + the existing voxel build — jit safe.
    """
    f = jnp.float32
    pts = points.reshape(-1, 3).astype(f)
    val = valid.reshape(-1)
    grid = build_voxel_grid(pts, val, resolution, table_size)
    n_count, n_mean, _ = neighborhood_moments(grid, include_cov=False)

    coords = voxel_coords(pts, resolution)
    idx = hash_coords(coords, table_size)
    hit = jnp.all(grid.coords[idx] == coords, axis=-1) & (
        grid.count[idx] > 0
    )
    nc = n_count[idx]
    mu = n_mean[idx]
    # Self-excluded neighborhood centroid: μ' = (n·μ − p)/(n−1).
    lone = nc <= 1.0
    denom = jnp.maximum(nc - 1.0, 1.0)
    mu_excl = (mu * nc[:, None] - pts) / denom[:, None]
    d = jnp.sqrt(jnp.sum((pts - mu_excl) ** 2, axis=-1))
    far = 4.0 * jnp.asarray(resolution, f)
    d = jnp.where(lone, far, d)

    # Hash-EVICTED points (``~hit``: their voxel lost the table race, so
    # the slot gathered above belongs to a DIFFERENT voxel) must not
    # inherit the far sentinel — that would be a table artifact, not
    # geometry, and in collision-heavy scenes it silently dropped inliers
    # in proportion to the collision rate. Their centroid statistic is
    # unrecoverable (the winning slot's moments describe another voxel),
    # so they are (a) excluded from the global mean/std population and
    # (b) gated GEOMETRICALLY instead: kept iff any voxel of their 3³
    # neighborhood verifies in the table (occupied space nearby ⇒ not a
    # sparse outlier; an evicted point in an otherwise-empty neighborhood
    # drops, same as PCL's far-kNN case). The point's own slot can never
    # verify once evicted, so the (0,0,0) probe adds no self-evidence.
    occupied_nb = jnp.zeros(d.shape, bool)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nb = coords + jnp.asarray([ox, oy, oz], coords.dtype)
                ni = hash_coords(nb, table_size)
                ok = jnp.all(grid.coords[ni] == nb, axis=-1) & (
                    grid.count[ni] > 0
                )
                occupied_nb = occupied_nb | ok

    scored = val & hit
    n_scored = jnp.maximum(jnp.sum(scored, dtype=f), 1.0)
    dv = jnp.where(scored, d, 0.0)
    mean_d = jnp.sum(dv) / n_scored
    var_d = jnp.sum(jnp.where(scored, (d - mean_d) ** 2, 0.0)) / n_scored
    thresh = mean_d + stddev_mul_thresh * jnp.sqrt(jnp.maximum(var_d, 0.0))
    return val & jnp.where(hit, d <= thresh, occupied_nb)
