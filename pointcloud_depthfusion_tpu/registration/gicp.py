"""Voxelized GICP: JAX-native rigid registration.

Replaces the external FastGICP CUDA library (`fast_gicp::FastVGICPCuda`,
registration.cpp:31-47) with a from-scratch distribution-to-distribution
voxelized GICP:

  * both clouds are voxel-downsampled (ApproximateVoxelGrid equivalent,
    ops/voxel.py) at ``voxel_size``;
  * the target is voxelized at ``resolution`` into per-voxel Gaussians with
    plane-regularized covariances (Segal's GICP regularization);
  * source points carry their own voxel's regularized covariance;
  * correspondences are direct voxel lookups of the transformed source
    (VGICP "DIRECT1"), optionally RBF-weighted by residual distance
    (the reference's GPU_RBF_KERNEL analogue, kernel_width/kernel_max_dist,
    registration.cpp:35-38);
  * a `lax.while_loop` runs damped Gauss-Newton on SE(3) with the
    rotation/translation/fitness convergence epsilons as the loop predicate
    (registration.cpp:39-46) — a jit-safe dynamic trip count with static
    shapes, so converged solves stop paying for remaining iterations.

All math is float32 (the reference solves in double via Eigen); the unit
test on the bunny-like golden pair shows recovered poses within ~1e-3 m /
~0.1° of truth, comfortably inside the fusion pipeline's tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from pointcloud_depthfusion_tpu.core import geometry as G
from pointcloud_depthfusion_tpu.ops import voxel as V

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GICPConfig:
    """Solver settings (registration_node/config/config_default.yaml:15-29)."""

    resolution: Array  # VGICP voxel size for distributions (m)
    voxel_size: Array  # downsample leaf size (m)
    rotation_eps: Array  # rad
    translation_eps: Array  # m
    fitness_eps: Array  # m² (change in mean squared error)
    # Relative fitness-plateau criterion: converged when |Δmse| <
    # fitness_rel_eps · mse. The reference's absolute 1e-12 threshold is an
    # f64 Eigen value; in f32 the mse jitters at ~1e-3 relative and the
    # absolute test never fires, so warm solves burned the full iteration
    # budget on sub-noise steps (48 capped iterations at a 9.4e-5 plateau;
    # warm converges in 3 with this at 5e-3). ≤0 disables
    # (the default): cold solves can stall for a few iterations before
    # improving, so the pipeline enables it only for warm post-annealing
    # ticks.
    fitness_rel_eps: Array
    kernel_width: Array  # RBF correspondence weighting width (m); <=0 off
    kernel_max_dist: Array  # residual cutoff (m); <=0 → 3·resolution
    # Levenberg-style diagonal damping of the Gauss-Newton step. A TRACED
    # leaf (pure arithmetic in _solve_6x6): the annealing schedule varies
    # damping per stage, and a static field forced one ~46 s recompile per
    # annealing stage — as a leaf every stage shares one executable.
    damping: Array = None
    # TRACED early-exit budget (int32): the while_loop predicate stops at
    # min(iteration_cap, max_iterations). Lets coarse annealing stages run
    # a hard small budget without splitting the executable (max_iterations
    # is the static trip bound; this is the dynamic one).
    iteration_cap: Array = None
    max_iterations: int = dataclasses.field(default=64, metadata=dict(static=True))
    table_size: int = dataclasses.field(default=1 << 15, metadata=dict(static=True))
    min_voxel_points: float = dataclasses.field(
        default=1.0, metadata=dict(static=True)
    )
    min_cov_points: float = dataclasses.field(
        default=6.0, metadata=dict(static=True)
    )
    cov_regularization: str = dataclasses.field(
        default="plane", metadata=dict(static=True)
    )
    # "planar": the Gauss-Newton iteration in structure-of-arrays form —
    # every (M,3,3)/(M,3,6) batched tensor replaced by component planes.
    # Tiny trailing (3,3) axes make poor vector work; the plane form keeps
    # the long voxel axis innermost. "matrix": the original batched-tensor loop,
    # kept as the readable oracle both are tested against.
    solver: str = dataclasses.field(default="planar", metadata=dict(static=True))
    # Correspondence model (fast_gicp NeighborSearchMethod analogue;
    # the reference solver runs GPU_RBF_KERNEL multi-voxel search,
    # registration.cpp:31). "direct1": one voxel lookup per source point.
    # "direct7"/"direct27": accumulate kernel-weighted residual terms from
    # the face-adjacent / full 3×3×3 neighbor voxels too — a source point
    # whose transformed position falls in an empty voxel still corresponds
    # through its occupied neighbors, widening the convergence basin by
    # about one voxel. Planar solver only; cost ≈ one extra row gather +
    # plane block per neighbor per iteration.
    neighbor_search: str = dataclasses.field(
        default="direct1", metadata=dict(static=True)
    )

    def __post_init__(self):
        # The plain dataclass constructor is a public path and damping/
        # iteration_cap LOOK optional — left as None they would crash
        # mid-trace deep in the solver (None·diag, it < None) and poison
        # pytree flattening. Fill the real defaults here; during pytree
        # unflattening the leaves are never None, so this is a no-op.
        if self.damping is None:
            object.__setattr__(
                self, "damping", jnp.asarray(1e-2, jnp.float32)
            )
        if self.iteration_cap is None:
            object.__setattr__(
                self, "iteration_cap",
                jnp.asarray(self.max_iterations, jnp.int32),
            )

    @staticmethod
    def create(
        resolution: float = 0.01,
        voxel_size: float = 0.01,
        rotation_eps: float = 2e-3,
        translation_eps: float = 1e-4,
        fitness_eps: float = 1e-12,
        kernel_width: float = 0.005,
        kernel_max_dist: float = 0.025,
        fitness_rel_eps: float = 0.0,
        damping: float = 1e-2,
        iteration_cap: int | None = None,
        **static_fields,
    ) -> "GICPConfig":
        f = jnp.float32
        if iteration_cap is None:
            iteration_cap = static_fields.get(
                "max_iterations", GICPConfig.max_iterations
            )
        return GICPConfig(
            iteration_cap=jnp.asarray(iteration_cap, jnp.int32),
            resolution=jnp.asarray(resolution, f),
            voxel_size=jnp.asarray(voxel_size, f),
            rotation_eps=jnp.asarray(rotation_eps, f),
            translation_eps=jnp.asarray(translation_eps, f),
            fitness_eps=jnp.asarray(fitness_eps, f),
            fitness_rel_eps=jnp.asarray(fitness_rel_eps, f),
            kernel_width=jnp.asarray(kernel_width, f),
            kernel_max_dist=jnp.asarray(kernel_max_dist, f),
            damping=jnp.asarray(damping, f),
            **static_fields,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GICPResult:
    transform: Array  # (4, 4) source→target
    fitness: Array  # mean squared residual distance (m²)
    converged: Array  # bool
    iterations: Array  # int32 — iteration at which convergence triggered
    num_correspondences: Array  # int32 (final iteration)


def _loop_seed(transform: Array):
    """Gauss-Newton carry seed: (transform, fitness=inf, done=False,
    iterations=0, correspondences=0).

    Under ``shard_map`` a loop carry must keep its varying mesh axes from
    one iteration to the next. The solve's scalars vary exactly where the
    initial transform does (one pair per device in the batched solve;
    replicated in the point-sharded one), so the constant seeds take its
    varying axes.
    """
    vma = tuple(jax.typeof(transform).vma)

    def seed(value, dtype):
        x = jnp.asarray(value, dtype)
        return jax.lax.pcast(x, vma, to="varying") if vma else x

    return (transform, seed(jnp.inf, jnp.float32), seed(False, jnp.bool_),
            seed(0, jnp.int32), seed(0, jnp.int32))


def _inv3x3(m: Array) -> Array:
    """Closed-form batched 3×3 inverse (adjugate / determinant).

    jnp.linalg.inv on (M, 3, 3) lowers to a batched LU call per iteration
    inside the scan; the cofactor form is pure elementwise math.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    adj = jnp.stack(
        [
            jnp.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _cholesky_solve_6x6(h: Array, g: Array) -> Array:
    """Unrolled 6×6 SPD Cholesky solve (static scalar ops, no LAPACK)."""
    n = 6
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        l[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        for i in range(j + 1, n):
            s = h[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s / l[j][j]
    # forward substitution L y = g
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    # back substitution Lᵀ x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x)


def _solve_6x6(h: Array, g: Array, damping: float) -> Array:
    """Damped Gauss-Newton step: (H + λ·diag(H))⁻¹ g."""
    lm = damping * jnp.diag(jnp.diagonal(h)) + 1e-12 * jnp.eye(6, dtype=h.dtype)
    return _cholesky_solve_6x6(h + lm, g)


def prepare_target(
    target_points: Array,
    target_valid: Array,
    config: GICPConfig,
) -> V.VoxelGrid:
    """Build the regularized target distribution grid (the solve's
    scene-dependent state).

    Split out from :func:`gicp_register` so callers can CACHE it across
    solver ticks while the target scene is static — the reference re-runs
    its per-solve target filtering every tick (registration.cpp:67-71);
    skipping the rebuild halves the warm-tick cost here.

    Means come from the voxel's own members; covariance ORIENTATION pools
    the 3×3×3 voxel neighborhood (fast_gicp computes kNN covariances per
    point — a lone point per fine voxel would otherwise yield degenerate
    distributions and starve the solver of correspondences).
    """
    f = jnp.float32
    # f32 matmul precision: accelerator matmuls may default to reduced-
    # precision inputs (TF32 on NVIDIA tensor cores); covariance products
    # at reduced precision add solver-step noise above the convergence
    # epsilons (warm solves then burn the iteration cap).
    with jax.default_matmul_precision("float32"):
        tgt = target_points.reshape(-1, 3).astype(f)
        tval = target_valid.reshape(-1)
        tgt_ds, tgt_mask = V.voxel_downsample(
            tgt, tval, config.voxel_size, config.table_size
        )
        eye3 = jnp.eye(3, dtype=f)
        tgt_grid = V.build_voxel_grid(
            tgt_ds, tgt_mask, config.resolution, config.table_size
        )
        tn_count, _, tn_cov = V.neighborhood_moments(tgt_grid)
        tgt_cov_reg = jnp.where(
            (tn_count >= config.min_cov_points)[:, None, None],
            V.regularize_covariances(tn_cov, config.cov_regularization),
            eye3,
        )
        return dataclasses.replace(tgt_grid, cov=tgt_cov_reg)


def gicp_register(
    source_points: Array,
    source_valid: Array,
    target_points: Array,
    target_valid: Array,
    initial_transform: Array,
    config: GICPConfig,
) -> GICPResult:
    """Estimate the rigid transform aligning source onto target.

    Args:
      source_points / target_points: (N, 3) float32 (any leading shape,
        flattened internally); invalid entries masked by the *_valid bools.
      initial_transform: (4, 4) initial guess (warm start,
        registration_node.cpp:499-500).

    Returns a GICPResult whose ``transform`` maps source-frame points into
    the target frame (same convention as vgicp_cuda.align's final
    transformation).
    """
    tgt_grid = prepare_target(target_points, target_valid, config)
    return gicp_register_prepared(
        source_points, source_valid, tgt_grid, initial_transform, config
    )


# Neighbor-voxel offset sets for the correspondence search
# (fast_gicp NeighborSearchMethod DIRECT1/DIRECT7/DIRECT27).
_NEIGHBOR_OFFSETS = {
    "direct1": ((0, 0, 0),),
    "direct7": (
        (0, 0, 0),
        (-1, 0, 0), (1, 0, 0),
        (0, -1, 0), (0, 1, 0),
        (0, 0, -1), (0, 0, 1),
    ),
    "direct27": tuple(
        (ox, oy, oz)
        for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)
    ),
}


def _sym_inv6(a, b, c, d, e, f):
    """Closed-form inverse of symmetric [[a,b,c],[b,d,e],[c,e,f]] as its 6
    unique components (adjugate over determinant; pure plane math)."""
    co11 = d * f - e * e
    co12 = c * e - b * f
    co13 = b * e - c * d
    co22 = a * f - c * c
    co23 = b * c - a * e
    co33 = a * d - b * b
    det = a * co11 + b * co12 + c * co13
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
    return (
        co11 * inv_det, co12 * inv_det, co13 * inv_det,
        co22 * inv_det, co23 * inv_det, co33 * inv_det,
    )


def _solve_planar(
    src_ds: Array,
    src_mask: Array,
    src_cov: Array,
    tgt_table: Array,
    resolution: Array,
    table_size: int,
    initial_transform: Array,
    config: GICPConfig,
    max_dist: Array,
    axis_name: str | None = None,
) -> GICPResult:
    """Gauss-Newton VGICP loop in structure-of-arrays (plane) form.

    Mathematically identical to the matrix loop in
    :func:`gicp_register_prepared` (same correspondences, same damped step,
    same convergence tests; f32 sums in a different association order). All
    per-voxel quantities are (M,) planes: the combined covariance
    C = C_t + R C_s Rᵀ, its closed-form symmetric inverse W, and the
    Gauss-Newton normal equations H = Σ w JᵀWJ, g = Σ w JᵀWr with
    J = [-I | [Rp+t]×] are fully unrolled into plane arithmetic — no
    (M,3,3) tensors survive into the loop body.

    ``axis_name``: when set, the source planes are a SHARD of the cloud on
    a mesh axis of that name — every per-point reduction (the 27 normal-
    equation sums, the correspondence count, the fitness numerator) becomes
    a local sum + ``psum`` over the axis, so the GN state (transform,
    convergence flags) stays replicated while the cloud and all O(M) work
    are point-sharded across devices. The per-iteration collective payload
    is 29 scalars — negligible next to the per-point work.
    """
    f = jnp.float32
    sx, sy, sz = src_ds[:, 0], src_ds[:, 1], src_ds[:, 2]
    cs11 = src_cov[:, 0, 0]
    cs12 = src_cov[:, 0, 1]
    cs13 = src_cov[:, 0, 2]
    cs22 = src_cov[:, 1, 1]
    cs23 = src_cov[:, 1, 2]
    cs33 = src_cov[:, 2, 2]
    # Validate here, not only in gicp_register_prepared: the sharded entry
    # point (registration/distributed.py) calls _solve_planar directly, and
    # a raw KeyError mid-trace inside shard_map hides the valid options.
    if config.neighbor_search not in _NEIGHBOR_OFFSETS:
        raise ValueError(
            f"unknown neighbor_search {config.neighbor_search!r} "
            f"(expected one of {sorted(_NEIGHBOR_OFFSETS)})"
        )
    neighbor_offsets = _NEIGHBOR_OFFSETS[config.neighbor_search]

    def step(carry):
        transform, prev_fitness, done, it_count, _ = carry
        r = transform[:3, :3]
        r00, r01, r02 = r[0, 0], r[0, 1], r[0, 2]
        r10, r11, r12 = r[1, 0], r[1, 1], r[1, 2]
        r20, r21, r22 = r[2, 0], r[2, 1], r[2, 2]
        t0, t1, t2 = transform[0, 3], transform[1, 3], transform[2, 3]

        mx = r00 * sx + r01 * sy + r02 * sz + t0
        my = r10 * sx + r11 * sy + r12 * sz + t1
        mz = r20 * sx + r21 * sy + r22 * sz + t2

        cx = jnp.floor(mx / resolution).astype(jnp.int32)
        cy = jnp.floor(my / resolution).astype(jnp.int32)
        cz = jnp.floor(mz / resolution).astype(jnp.int32)

        # --- B = R C_s Rᵀ (6 components via A = R C_s) --------------------
        # Per-point, neighbor-independent: hoisted out of the offset loop.
        a11 = r00 * cs11 + r01 * cs12 + r02 * cs13
        a12 = r00 * cs12 + r01 * cs22 + r02 * cs23
        a13 = r00 * cs13 + r01 * cs23 + r02 * cs33
        a21 = r10 * cs11 + r11 * cs12 + r12 * cs13
        a22 = r10 * cs12 + r11 * cs22 + r12 * cs23
        a23 = r10 * cs13 + r11 * cs23 + r12 * cs33
        a31 = r20 * cs11 + r21 * cs12 + r22 * cs13
        a32 = r20 * cs12 + r21 * cs22 + r22 * cs23
        a33 = r20 * cs13 + r21 * cs23 + r22 * cs33
        b11 = a11 * r00 + a12 * r01 + a13 * r02
        b12 = a11 * r10 + a12 * r11 + a13 * r12
        b13 = a11 * r20 + a12 * r21 + a13 * r22
        b22 = a21 * r10 + a22 * r11 + a23 * r12
        b23 = a21 * r20 + a22 * r21 + a23 * r22
        b33 = a31 * r20 + a32 * r21 + a33 * r22

        # --- per-neighbor correspondence terms, accumulated ---------------
        # Each (source point, neighbor voxel) pair is an independent
        # kernel-weighted residual (fast_gicp multi-voxel semantics); with
        # "direct1" the loop is a single iteration and every op below is
        # identical to the classic single-lookup body.
        stack_acc = None
        n_corr = jnp.int32(0)
        fit_num = jnp.float32(0.0)
        for ox, oy, oz in neighbor_offsets:
            ncx, ncy, ncz = cx + ox, cy + oy, cz + oz
            idx = V.hash_coords_planar(ncx, ncy, ncz, table_size)
            rows = tgt_table[idx]
            rcx = jax.lax.bitcast_convert_type(rows[:, 10], jnp.int32)
            rcy = jax.lax.bitcast_convert_type(rows[:, 11], jnp.int32)
            rcz = jax.lax.bitcast_convert_type(rows[:, 12], jnp.int32)
            found = (
                (rows[:, 0] >= config.min_voxel_points)
                & (rcx == ncx) & (rcy == ncy) & (rcz == ncz)
            )
            ex = rows[:, 1] - mx
            ey = rows[:, 2] - my
            ez = rows[:, 3] - mz
            ct11, ct12, ct13 = rows[:, 4], rows[:, 5], rows[:, 6]
            ct22, ct23, ct33 = rows[:, 7], rows[:, 8], rows[:, 9]

            dist2 = ex * ex + ey * ey + ez * ez
            corr = src_mask & found & (dist2 <= max_dist * max_dist)

            # --- W = (C_t + B + 1e-6 I)⁻¹ --------------------------------
            w11, w12, w13, w22, w23, w33 = _sym_inv6(
                ct11 + b11 + 1e-6, ct12 + b12, ct13 + b13,
                ct22 + b22 + 1e-6, ct23 + b23, ct33 + b33 + 1e-6,
            )

            rbf = jnp.where(
                config.kernel_width > 0,
                jnp.exp(
                    -0.5 * dist2 / jnp.maximum(config.kernel_width**2, 1e-12)
                ),
                1.0,
            )
            w = corr.astype(f) * rbf

            # --- normal equations: H = Σ w JᵀWJ, g = Σ w JᵀWr -------------
            # J = [-I | S], S = [m]× ⇒ H = [[W, -WS], [(−WS)ᵀ, SᵀWS]],
            # g = [−Wr ; −m×(Wr)]. P = W·S and Q = SᵀWS unrolled below.
            vx = w11 * ex + w12 * ey + w13 * ez
            vy = w12 * ex + w22 * ey + w23 * ez
            vz = w13 * ex + w23 * ey + w33 * ez

            p11 = w12 * mz - w13 * my
            p12 = w13 * mx - w11 * mz
            p13 = w11 * my - w12 * mx
            p21 = w22 * mz - w23 * my
            p22 = w23 * mx - w12 * mz
            p23 = w12 * my - w22 * mx
            p31 = w23 * mz - w33 * my
            p32 = w33 * mx - w13 * mz
            p33 = w13 * my - w23 * mx

            q11 = mz * p21 - my * p31
            q12 = mz * p22 - my * p32
            q13 = mz * p23 - my * p33
            q22 = mx * p32 - mz * p12
            q23 = mx * p33 - mz * p13
            q33 = my * p13 - mx * p23

            stack = w * jnp.stack(
                [
                    w11, w12, w13, w22, w23, w33,
                    p11, p12, p13, p21, p22, p23, p31, p32, p33,
                    q11, q12, q13, q22, q23, q33,
                    vx, vy, vz,
                    my * vz - mz * vy,
                    mz * vx - mx * vz,
                    mx * vy - my * vx,
                ]
            )
            stack_acc = stack if stack_acc is None else stack_acc + stack
            n_corr = n_corr + jnp.sum(corr, dtype=jnp.int32)
            fit_num = fit_num + jnp.sum(dist2 * corr.astype(f))

        # ONE (27, M) stacked reduction instead of 27 separate jnp.sum calls:
        # each small reduce is its own kernel launch inside the while_loop
        # and the fixed launch costs, not the FLOPs, dominated the iteration.
        sums = jnp.sum(stack_acc, axis=1)
        if axis_name is not None:
            sums = jax.lax.psum(sums, axis_name)
        (
            sw11, sw12, sw13, sw22, sw23, sw33,
            sp11, sp12, sp13, sp21, sp22, sp23, sp31, sp32, sp33,
            sq11, sq12, sq13, sq22, sq23, sq33,
            svx, svy, svz, scx, scy, scz,
        ) = sums

        h = jnp.array(
            [
                [sw11, sw12, sw13, -sp11, -sp12, -sp13],
                [sw12, sw22, sw23, -sp21, -sp22, -sp23],
                [sw13, sw23, sw33, -sp31, -sp32, -sp33],
                [-sp11, -sp21, -sp31, sq11, sq12, sq13],
                [-sp12, -sp22, -sp32, sq12, sq22, sq23],
                [-sp13, -sp23, -sp33, sq13, sq23, sq33],
            ]
        )
        g = jnp.stack([-svx, -svy, -svz, -scx, -scy, -scz])

        delta_raw = -_solve_6x6(h, g, config.damping)
        # A zeroed step (degenerate Hessian → non-finite delta, or zero
        # correspondences → g = 0) must NOT read as convergence: its step
        # norms are 0 and would satisfy the epsilon test, reporting
        # converged=True for a FAILED solve. The step-norm exit therefore
        # requires a finite step AND live correspondences; a NaN solve then
        # burns out at the iteration cap with converged=False.
        step_finite = jnp.all(jnp.isfinite(delta_raw))
        delta = jnp.where(done | ~step_finite, 0.0, delta_raw)
        new_transform = G.mm(G.se3_exp(delta), transform)

        if axis_name is not None:
            n_corr = jax.lax.psum(n_corr, axis_name)
            fit_num = jax.lax.psum(fit_num, axis_name)
        fitness = jnp.where(
            n_corr > 0,
            fit_num / jnp.maximum(n_corr.astype(f), 1.0),
            jnp.asarray(jnp.finfo(f).max, f),
        )

        rot_step = jnp.linalg.norm(delta[3:])
        trans_step = jnp.linalg.norm(delta[:3])
        fitness_ok = fitness < 1e10
        plateau = (
            (config.fitness_rel_eps > 0)
            & fitness_ok
            & (jnp.abs(prev_fitness - fitness) < config.fitness_rel_eps * fitness)
        )
        newly_done = (
            ((rot_step < config.rotation_eps)
             & (trans_step < config.translation_eps)
             & step_finite & (n_corr > 0))
            | (fitness_ok & (jnp.abs(prev_fitness - fitness) < config.fitness_eps))
            | plateau
        ) & ~done
        it_count = jnp.where(done, it_count, it_count + 1)
        # Zero correspondences still EXITS immediately (the step is zero —
        # further iterations cannot improve), but the result assembly
        # below reports it unconverged via the n_corr>0 conjunct.
        done = done | newly_done | (n_corr == 0)
        return (new_transform, fitness, done, it_count, n_corr)

    init = _loop_seed(initial_transform.astype(f))

    def cond(carry):
        _, _, done, it_count, _ = carry
        return (
            (~done)
            & (it_count < config.max_iterations)
            & (it_count < config.iteration_cap)
        )

    transform, fitness, done, iters, n_corr = jax.lax.while_loop(
        cond, step, init
    )
    return GICPResult(
        transform=transform,
        fitness=fitness,
        # A no-correspondence exit is a FAILURE, not convergence.
        converged=done & (n_corr > 0),
        iterations=iters,
        num_correspondences=n_corr,
    )


def prep_source(
    source_points: Array,
    source_valid: Array,
    config: GICPConfig,
) -> Tuple[Array, Array, Array]:
    """Downsample the source and attach per-point regularized covariances.

    The solve-independent source half of the prep (ApproximateVoxelGrid +
    fast_gicp's per-point covariance model); split out so distributed
    entry points (registration/distributed.py) can shard the GN loop over
    an already-prepared cloud. Returns (src_ds (M,3), src_mask (M,),
    src_cov (M,3,3)).
    """
    with jax.default_matmul_precision("float32"):
        f = jnp.float32
        eye3 = jnp.eye(3, dtype=f)
        src = source_points.reshape(-1, 3).astype(f)
        sval = source_valid.reshape(-1)

        # --- downsample the source (ApproximateVoxelGrid) -----------------
        src_ds, src_mask = V.voxel_downsample(
            src, sval, config.voxel_size, config.table_size
        )

        # --- source per-point covariances from their voxel neighborhoods --
        src_grid = V.build_voxel_grid(
            src_ds, src_mask, config.resolution, config.table_size
        )
        sn_count, _, sn_cov = V.neighborhood_moments(src_grid)
        src_cov_table = jnp.where(
            (sn_count >= config.min_cov_points)[:, None, None],
            V.regularize_covariances(sn_cov, config.cov_regularization),
            eye3,
        )
        s_coords = V.voxel_coords(src_ds, config.resolution)
        s_idx = V.hash_coords(s_coords, config.table_size)
        s_hit = jnp.all(src_grid.coords[s_idx] == s_coords, axis=-1)
        src_cov = jnp.where(s_hit[:, None, None], src_cov_table[s_idx], eye3)
        return src_ds, src_mask, src_cov


def pack_target_table(tgt_grid: V.VoxelGrid) -> Array:
    """Packed (T, 13) per-voxel lookup table, built ONCE per solve: the
    loop's correspondence lookup reads (count, mean, symmetric cov ×6,
    coords) with ONE row gather per iteration instead of the four separate
    gathers in V.lookup_voxels."""
    f = jnp.float32
    cov6 = jnp.stack(
        [
            tgt_grid.cov[:, 0, 0], tgt_grid.cov[:, 0, 1],
            tgt_grid.cov[:, 0, 2], tgt_grid.cov[:, 1, 1],
            tgt_grid.cov[:, 1, 2], tgt_grid.cov[:, 2, 2],
        ],
        axis=-1,
    )
    return jnp.concatenate(
        [
            tgt_grid.count[:, None],
            tgt_grid.mean,
            cov6,
            jax.lax.bitcast_convert_type(tgt_grid.coords, f),
        ],
        axis=-1,
    )  # (T, 13)


def gicp_register_prepared(
    source_points: Array,
    source_valid: Array,
    tgt_grid: V.VoxelGrid,
    initial_transform: Array,
    config: GICPConfig,
) -> GICPResult:
    """:func:`gicp_register` against a pre-built target grid
    (:func:`prepare_target`) — the cache-friendly entry point.
    """
    with jax.default_matmul_precision("float32"):
        f = jnp.float32
        src_ds, src_mask, src_cov = prep_source(
            source_points, source_valid, config
        )

        max_dist = jnp.where(
            config.kernel_max_dist > 0, config.kernel_max_dist, 3.0 * config.resolution
        )
        tgt_table = pack_target_table(tgt_grid)

        if config.neighbor_search not in _NEIGHBOR_OFFSETS:
            raise ValueError(
                f"unknown neighbor_search {config.neighbor_search!r} "
                f"(expected one of {sorted(_NEIGHBOR_OFFSETS)})"
            )
        if config.solver == "planar":
            return _solve_planar(
                src_ds, src_mask, src_cov, tgt_table,
                tgt_grid.resolution, tgt_grid.table_size,
                initial_transform, config, max_dist,
            )
        if config.neighbor_search != "direct1":
            raise ValueError(
                "multi-voxel neighbor_search requires the planar solver "
                "(the matrix loop is the direct1 readability oracle)"
            )

        def lookup_packed(moved):
            coords = V.voxel_coords(moved, tgt_grid.resolution)
            idx = V.hash_coords(coords, tgt_grid.table_size)
            rows = tgt_table[idx]
            rcoords = jax.lax.bitcast_convert_type(rows[:, 10:13], jnp.int32)
            found = (rows[:, 0] >= config.min_voxel_points) & jnp.all(
                rcoords == coords, axis=-1
            )
            mu = rows[:, 1:4]
            c6 = rows[:, 4:10]
            r0 = jnp.stack([c6[:, 0], c6[:, 1], c6[:, 2]], -1)
            r1 = jnp.stack([c6[:, 1], c6[:, 3], c6[:, 4]], -1)
            r2 = jnp.stack([c6[:, 2], c6[:, 4], c6[:, 5]], -1)
            cov = jnp.stack([r0, r1, r2], axis=-2)
            return mu, cov, found

        def step(carry, _):
            transform, prev_fitness, done, it_count, _ = carry
            r_mat = transform[:3, :3]
            t_vec = transform[:3, 3]
            # Precision pinned on every f32 product of this loop: a TF32
            # product would move the oracle by more than its tolerances.
            moved = G.mm(src_ds, r_mat.T) + t_vec  # (M, 3)

            mu, cov_t, found = lookup_packed(moved)
            resid = mu - moved  # (M, 3)
            dist2 = jnp.sum(resid * resid, axis=-1)
            corr = src_mask & found & (dist2 <= max_dist * max_dist)

            # Combined covariance C = C_t + R C_s Rᵀ; weight W = C⁻¹
            # (closed form, see _inv3x3).
            cov_c = cov_t + G.mm(G.mm(r_mat, src_cov), r_mat.T)  # batched (M,3,3)
            w_mat = _inv3x3(cov_c + 1e-6 * jnp.eye(3, dtype=f))

            # Optional RBF correspondence weighting (GPU_RBF_KERNEL analogue).
            rbf = jnp.where(
                config.kernel_width > 0,
                jnp.exp(-0.5 * dist2 / jnp.maximum(config.kernel_width**2, 1e-12)),
                1.0,
            )
            wgt = corr.astype(f) * rbf

            # Jacobian of r = μ - (R p + t) wrt left-perturbation ξ=(ρ, φ):
            # dr/dξ = [-I | [Rp+t]×]  (3×6).
            px, py, pz = moved[:, 0], moved[:, 1], moved[:, 2]
            zeros = jnp.zeros_like(px)
            skew = jnp.stack(
                [
                    jnp.stack([zeros, -pz, py], -1),
                    jnp.stack([pz, zeros, -px], -1),
                    jnp.stack([-py, px, zeros], -1),
                ],
                -2,
            )  # (M, 3, 3) = [moved]×
            jac = jnp.concatenate(
                [-jnp.broadcast_to(jnp.eye(3, dtype=f), skew.shape), skew], axis=-1
            )  # (M, 3, 6)

            wj = G.mm(w_mat, jac)  # (M, 3, 6)
            h = jnp.einsum("nij,nik,n->jk", jac, wj, wgt, precision=jax.lax.Precision.HIGHEST)
            g = jnp.einsum("nij,ni,n->j", wj, resid, wgt, precision=jax.lax.Precision.HIGHEST)

            delta_raw = -_solve_6x6(h, g, config.damping)
            # See the planar loop: a zeroed degenerate step must not pass
            # the step-norm convergence test.
            step_finite = jnp.all(jnp.isfinite(delta_raw))
            delta = jnp.where(done | ~step_finite, 0.0, delta_raw)

            new_transform = G.mm(G.se3_exp(delta), transform)

            n_corr = jnp.sum(corr, dtype=jnp.int32)
            # No correspondences is a FAILURE state, not zero error.
            fitness = jnp.where(
                n_corr > 0,
                jnp.sum(dist2 * corr.astype(f)) / jnp.maximum(n_corr.astype(f), 1.0),
                jnp.asarray(jnp.finfo(f).max, f),
            )

            rot_step = jnp.linalg.norm(delta[3:])
            trans_step = jnp.linalg.norm(delta[:3])
            fitness_ok = fitness < 1e10  # not the no-correspondence sentinel
            plateau = (
                (config.fitness_rel_eps > 0)
                & fitness_ok
                & (jnp.abs(prev_fitness - fitness) < config.fitness_rel_eps * fitness)
            )
            newly_done = (
                ((rot_step < config.rotation_eps)
                 & (trans_step < config.translation_eps)
                 & step_finite & (n_corr > 0))
                | (fitness_ok & (jnp.abs(prev_fitness - fitness) < config.fitness_eps))
                | plateau
            ) & ~done
            it_count = jnp.where(done, it_count, it_count + 1)
            # See the planar loop: exit on zero correspondences, reported
            # unconverged at result assembly.
            done = done | newly_done | (n_corr == 0)

            return (new_transform, fitness, done, it_count, n_corr), None

        init = _loop_seed(initial_transform.astype(f))
        # while_loop instead of a fixed-length scan: converged solves stop
        # paying for the remaining iterations (the convergence epsilons are the
        # loop predicate — jit-safe dynamic trip count, no dynamic shapes).
        def cond(carry):
            _, _, done, it_count, _ = carry
            return (
            (~done)
            & (it_count < config.max_iterations)
            & (it_count < config.iteration_cap)
        )

        transform, fitness, done, iters, n_corr = jax.lax.while_loop(
            cond, lambda c: step(c, None)[0], init
        )
        return GICPResult(
            transform=transform,
            fitness=fitness,
            # A no-correspondence exit is a FAILURE, not convergence.
            converged=done & (n_corr > 0),
            iterations=iters,
            num_correspondences=n_corr,
        )


def gicp_register_multiscale(
    source_points: Array,
    source_valid: Array,
    target_points: Array,
    target_valid: Array,
    initial_transform: Array,
    configs: Tuple[GICPConfig, ...],
) -> GICPResult:
    """Chain several solver stages from coarse to fine resolution.

    The GICP basin of attraction scales with the voxel resolution; a cold
    start with a large pose offset needs coarse voxels first. This is the
    library-level form of the reference's `adjust_resolution` schedule
    (registration_node.cpp:485-530: initial resolution 0.1 stepping down by
    0.05 toward the configured value, voxel = 0.1·resolution). The chain
    warm-starts each stage from the previous one, and — because every
    stage knob (resolution, kernel, epsilons, damping, iteration cap) is a
    traced leaf — all stages share ONE compiled executable.
    """
    result = None
    transform = initial_transform
    for cfg in configs:
        result = gicp_register(
            source_points, source_valid, target_points, target_valid, transform, cfg
        )
        transform = result.transform
    if result is None:
        raise ValueError("multiscale schedule needs at least one stage")
    return result


def default_multiscale_configs(
    resolution: float = 0.01,
    voxel_size: float = 0.01,
    coarse_start: float = 0.1,
    steps: int = 3,
    max_iterations: int = 64,
    coarse_iterations: int = 16,
    **kw,
) -> Tuple[GICPConfig, ...]:
    """Geometric coarse→fine ladder ending at the configured resolution.

    Cold-start budget: a coarse stage only has to land inside the NEXT
    stage's convergence basin, so (a) its step-size epsilons are scaled to
    its own resolution (translation r/100, rotation 0.01 rad) — demanding a
    0.1 mm step at a 0.1 m voxel scale just burns iterations on sub-voxel
    jitter — and (b) its iteration budget is capped at ``coarse_iterations``.
    Only the final stage runs the caller's full epsilons/budget. All stages
    share ONE compiled executable: every varying knob (resolution, kernel,
    epsilons, damping) is a traced leaf; max_iterations is pinned to the
    stage maximum so the static trip-count cap matches too.
    """
    if steps <= 1 or coarse_start <= resolution:
        return (GICPConfig.create(resolution=resolution, voxel_size=voxel_size,
                                  max_iterations=max_iterations, **kw),)
    ratio = (resolution / coarse_start) ** (1.0 / (steps - 1))
    final_rot = kw.pop("rotation_eps", 2e-3)
    final_trans = kw.pop("translation_eps", 1e-4)
    cfgs = []
    for i in range(steps):
        r = coarse_start * (ratio**i)
        last = i == steps - 1
        # Heavier Gauss-Newton damping at coarse scale: undamped steps
        # oscillate when voxels span large scene fractions (measured 50°+
        # divergence on the golden pair at damping 1e-6, res 0.4).
        damping = max(0.01, 0.1 * (r / coarse_start))
        cfgs.append(
            GICPConfig.create(
                resolution=r,
                voxel_size=voxel_size,
                # One STATIC trip bound for every stage (shared
                # executable); the coarse stages' hard budget rides the
                # TRACED iteration_cap leaf instead.
                max_iterations=max_iterations,
                iteration_cap=max_iterations if last else min(
                    coarse_iterations, max_iterations
                ),
                rotation_eps=final_rot if last else max(final_rot, 1e-2),
                translation_eps=final_trans if last else max(final_trans, r / 100.0),
                kernel_max_dist=3.0 * r,
                damping=damping,
                **kw,
            )
        )
    return tuple(cfgs)


def fitness_score(
    source_points: Array,
    source_valid: Array,
    target_grid: V.VoxelGrid,
    transform: Array,
    min_voxel_points: float = 1.0,
) -> Array:
    """Mean squared distance of transformed source points to their matched
    target voxel means (PCL getFitnessScore proxy — PCL uses exact nearest
    neighbors; voxel means agree to O(resolution))."""
    moved = G.transform_points(source_points.reshape(-1, 3), transform)
    mu, _, found = V.lookup_voxels(target_grid, moved, min_voxel_points)
    ok = source_valid.reshape(-1) & found
    d2 = jnp.sum((mu - moved) ** 2, -1)
    return jnp.sum(d2 * ok) / jnp.maximum(jnp.sum(ok), 1)
