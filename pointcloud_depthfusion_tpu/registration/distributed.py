"""Multi-chip GICP: mesh-sharded registration solves.

The reference runs registration as a dedicated machine in the pipeline
(registration_node on smartmirror4-2, README.md:21-34) — one solver, one
GPU. On a multi-device mesh the same service scales two idiomatic ways:

* :func:`gicp_register_sharded` — ONE solve whose source cloud is
  point-sharded over the mesh. Each device evaluates correspondences and
  partial Gauss-Newton normal equations for its shard; a 29-scalar
  ``psum`` per iteration (27 normal-equation sums + correspondence count +
  fitness numerator) keeps the SE(3) state replicated. This is the
  tensor-parallel analogue: O(M) work and memory divide by the device
  count, the collective payload is constant.

* :func:`gicp_register_batched` — B INDEPENDENT pair solves, batch-sharded
  over the mesh (data parallel). Each device runs the complete
  single-device solver on its local pairs (no collectives), so results are
  bit-identical to B sequential :func:`~...gicp.gicp_register` calls. This
  is the shape of multi-camera rig calibration: an N-camera rig registers
  N-1 (or N cyclic) adjacent pairs at once.

Both run on any 1-D ``jax.sharding.Mesh`` (tested on the virtual 8-device
CPU mesh; ``__graft_entry__.dryrun_multichip`` and ``chip_smoke.py
--four-cards`` execute them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pointcloud_depthfusion_tpu.ops import voxel as V
from pointcloud_depthfusion_tpu.registration.gicp import (
    GICPConfig,
    GICPResult,
    _solve_planar,
    pack_target_table,
    prep_source,
    prepare_target,
)

Array = jax.Array


def _pad_points(arr: Array, mask: Array, cov: Array, n_shards: int):
    """Pad the point axis to a multiple of the mesh size (pad entries are
    masked out, so they contribute nothing to any reduction)."""
    m = arr.shape[0]
    m_pad = -(-m // n_shards) * n_shards
    if m_pad == m:
        return arr, mask, cov
    pad = m_pad - m
    arr = jnp.concatenate([arr, jnp.zeros((pad, 3), arr.dtype)])
    mask = jnp.concatenate([mask, jnp.zeros((pad,), bool)])
    cov = jnp.concatenate(
        [cov, jnp.broadcast_to(jnp.eye(3, dtype=cov.dtype), (pad, 3, 3))]
    )
    return arr, mask, cov


def gicp_register_sharded(
    mesh: Mesh,
    source_points: Array,
    source_valid: Array,
    target_points: Array,
    target_valid: Array,
    initial_transform: Array,
    config: GICPConfig,
    axis: str = "pt",
    tgt_grid: Optional[V.VoxelGrid] = None,
) -> GICPResult:
    """One GICP solve with the SOURCE CLOUD point-sharded over ``mesh``.

    Prep (voxel downsample, covariance attachment, target grid build) runs
    replicated — it is once-per-solve and hash-table global — then the
    Gauss-Newton ``while_loop`` runs under ``shard_map`` with the source
    planes split on ``axis`` and the packed target table replicated. Every
    device iterates in lock-step on identical (psum-reduced) GN state, so
    the returned result is replicated and deterministic.

    Numerics: identical correspondences and step math as the single-device
    planar solver; the 27 f32 reduction sums associate per-shard first,
    so results can differ from single-device in the last float bits (same
    caveat as any sharded reduction).

    ``tgt_grid``: optional pre-built target (caches across service ticks,
    like :func:`~...gicp.prepare_target`).
    """
    if config.solver != "planar":
        raise ValueError("gicp_register_sharded requires the planar solver")
    n_shards = mesh.shape[axis]
    with jax.default_matmul_precision("float32"):
        if tgt_grid is None:
            tgt_grid = prepare_target(target_points, target_valid, config)
        tgt_table = pack_target_table(tgt_grid)
        src_ds, src_mask, src_cov = prep_source(
            source_points, source_valid, config
        )
        src_ds, src_mask, src_cov = _pad_points(
            src_ds, src_mask, src_cov, n_shards
        )
        max_dist = jnp.where(
            config.kernel_max_dist > 0,
            config.kernel_max_dist,
            3.0 * config.resolution,
        )

        def body(sds, smask, scov, table, init, cfg, mdist):
            return _solve_planar(
                sds, smask, scov, table, cfg.resolution, cfg.table_size,
                init, cfg, mdist, axis_name=axis,
            )

        fn = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(), P(), P(), P()),
            out_specs=P(),
        )
        return fn(
            src_ds, src_mask, src_cov, tgt_table,
            initial_transform.astype(jnp.float32), config, max_dist,
        )


def gicp_register_batched(
    mesh: Mesh,
    source_points: Array,
    source_valid: Array,
    target_points: Array,
    target_valid: Array,
    initial_transforms: Array,
    config: GICPConfig,
    axis: str = "pair",
) -> GICPResult:
    """B independent pair solves, batch-sharded over ``mesh`` (DP).

    Args are batched on a leading pair axis: points (B, N, 3), valids
    (B, N), initial_transforms (B, 4, 4); B must be a multiple of the mesh
    size. Each device runs the full single-device solver (prep + target
    build + GN loop) for its local pairs with NO collectives, so every
    result is bit-identical to the corresponding sequential
    ``gicp_register`` call. Returns a GICPResult with leading dim B.
    """
    b = source_points.shape[0]
    n_shards = mesh.shape[axis]
    if b % n_shards:
        raise ValueError(f"{b} pairs not divisible by {n_shards} devices")

    def body(sp, sv, tp, tv, inits, cfg):
        from pointcloud_depthfusion_tpu.registration.gicp import gicp_register

        # Local pairs, unrolled (usually 1 per device): the whole solve is
        # per-pair local work.
        results = [
            gicp_register(sp[i], sv[i], tp[i], tv[i], inits[i], cfg)
            for i in range(sp.shape[0])
        ]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *results)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    return fn(
        source_points, source_valid, target_points, target_valid,
        initial_transforms.astype(jnp.float32), config,
    )


def register_rig_pairs(
    mesh: Mesh,
    clouds: Array,
    valids: Array,
    config: GICPConfig,
    initial_transforms: Optional[Array] = None,
    cyclic: bool = True,
) -> GICPResult:
    """Register an N-camera rig's adjacent pairs in one data-parallel step.

    ``clouds`` (N, M, 3) / ``valids`` (N, M): camera i's deprojected cloud.
    Solves pair i = (source camera (i+1) mod N → target camera i) — the
    N-camera generalization of the reference's single right→left solve
    (registration_node.cpp:272-461). With ``cyclic=False`` the wrap-around
    pair is still solved (shapes stay mesh-divisible) but callers should
    ignore result N-1. Returns batched GICPResult; ``transform[i]`` maps
    camera i+1 coordinates into camera i's frame.
    """
    n = clouds.shape[0]
    src = jnp.roll(clouds, -1, axis=0)
    sval = jnp.roll(valids, -1, axis=0)
    if initial_transforms is None:
        initial_transforms = jnp.broadcast_to(
            jnp.eye(4, dtype=jnp.float32), (n, 4, 4)
        )
    res = gicp_register_batched(
        mesh, src, sval, clouds, valids, initial_transforms, config
    )
    if not cyclic:
        res = dataclasses.replace(
            res,
            converged=res.converged.at[n - 1].set(False),
        )
    return res
