"""Mesh-sharded GICP on the 8-device virtual CPU mesh.

Point-sharded solve (psum'd normal equations) and batch-sharded pair
solves, both against the plain single-device solver.
"""

import numpy as np
import jax
import jax.numpy as jnp

from pointcloud_depthfusion_tpu.parallel.mesh import make_camera_mesh
from pointcloud_depthfusion_tpu.registration.gicp import (
    GICPConfig,
    gicp_register,
)
from pointcloud_depthfusion_tpu.registration.distributed import (
    gicp_register_batched,
    gicp_register_sharded,
    register_rig_pairs,
)

import oracles


def apply(t, pts):
    return pts @ t[:3, :3].T + t[:3, 3]


def small_transform(angle_y_deg=4.0, tx=0.05):
    a = np.deg2rad(angle_y_deg)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    t[0, 3] = tx
    return t


def _pose_errors(got, want):
    dr = got[:3, :3] @ want[:3, :3].T
    ang = np.rad2deg(np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1)))
    terr = np.linalg.norm(got[:3, 3] - want[:3, 3])
    return ang, terr


def test_point_sharded_solve_matches_single_device():
    """Source cloud sharded over 4 devices: same correspondences, psum'd
    normal equations — converges to the single-device pose."""
    target = oracles.make_bunny_like_cloud(3000)
    t_true = small_transform()
    source = apply(t_true, target).astype(np.float32)
    cfg = GICPConfig.create(resolution=0.05, voxel_size=0.02,
                            kernel_width=0.0, kernel_max_dist=-1.0,
                            max_iterations=64, table_size=1 << 13)
    mesh = make_camera_mesh(4, axis="pt")

    res_sharded = gicp_register_sharded(
        mesh, jnp.asarray(source), jnp.ones(len(source), bool),
        jnp.asarray(target), jnp.ones(len(target), bool),
        jnp.eye(4, dtype=jnp.float32), cfg,
    )
    res_single = gicp_register(
        jnp.asarray(source), jnp.ones(len(source), bool),
        jnp.asarray(target), jnp.ones(len(target), bool),
        jnp.eye(4, dtype=jnp.float32), cfg,
    )
    want = np.linalg.inv(t_true)
    ang_s, terr_s = _pose_errors(np.asarray(res_sharded.transform), want)
    ang_1, terr_1 = _pose_errors(np.asarray(res_single.transform), want)
    assert ang_s < 0.8 and terr_s < 0.012, (ang_s, terr_s)
    assert bool(res_sharded.converged) == bool(res_single.converged)
    # Same math modulo f32 reduction association: the two solves must agree
    # far inside the solver's own convergence epsilons.
    np.testing.assert_allclose(
        np.asarray(res_sharded.transform), np.asarray(res_single.transform),
        atol=5e-4,
    )
    assert abs(ang_s - ang_1) < 0.2 and abs(terr_s - terr_1) < 5e-3


def test_point_sharded_is_actually_sharded():
    """The shard_map really partitions the source: each device's visible
    shard is M/n points (guards against a silently replicated solve)."""
    from pointcloud_depthfusion_tpu.registration.gicp import (
        _solve_planar,
        pack_target_table,
        prep_source,
        prepare_target,
    )
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    target = oracles.make_bunny_like_cloud(1024)
    source = apply(small_transform(), target).astype(np.float32)
    cfg = GICPConfig.create(resolution=0.05, voxel_size=0.02,
                            table_size=1 << 12)
    mesh = make_camera_mesh(4, axis="pt")
    src_ds, src_mask, src_cov = prep_source(
        jnp.asarray(source), jnp.ones(len(source), bool), cfg
    )
    shapes = []

    def body(sds):
        shapes.append(sds.shape)
        return jax.lax.psum(jnp.sum(sds), "pt")

    shard_map(body, mesh=mesh, in_specs=(P("pt"),), out_specs=P())(src_ds)
    assert shapes[0][0] == src_ds.shape[0] // 4


def test_batched_pair_solves_bitwise_match_sequential():
    """DP pair solves over the mesh == sequential single-device solves."""
    rng = np.random.default_rng(3)
    b = 4
    mesh = make_camera_mesh(4, axis="pair")
    # Same STATIC config + shapes as test_register_rig_pairs_adjacent so
    # the two tests share one SPMD executable (the shard_map solve compiles
    # in minutes on a 1-core host); the smaller iteration budget rides the
    # TRACED iteration_cap leaf.
    cfg = GICPConfig.create(resolution=0.05, voxel_size=0.02,
                            kernel_width=0.0, kernel_max_dist=-1.0,
                            max_iterations=24, iteration_cap=16,
                            table_size=1 << 13, neighbor_search="direct7")
    tgts, srcs, trues = [], [], []
    for i in range(b):
        tgt = oracles.make_bunny_like_cloud(1500, seed=10 + i)
        t_true = small_transform(2.0 + i, 0.02 * (i + 1))
        tgts.append(tgt)
        srcs.append(apply(t_true, tgt).astype(np.float32))
        trues.append(t_true)
    sp = jnp.asarray(np.stack(srcs))
    tp = jnp.asarray(np.stack(tgts))
    ones = jnp.ones((b, sp.shape[1]), bool)
    inits = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (b, 4, 4))

    res = gicp_register_batched(mesh, sp, ones, tp, ones, inits, cfg)
    assert res.transform.shape == (b, 4, 4)
    for i in range(b):
        single = gicp_register(sp[i], ones[i], tp[i], ones[i],
                               jnp.eye(4, dtype=jnp.float32), cfg)
        np.testing.assert_allclose(
            np.asarray(res.transform[i]), np.asarray(single.transform),
            atol=1e-6,
        )
        assert int(res.iterations[i]) == int(single.iterations)
        assert int(res.num_correspondences[i]) == int(
            single.num_correspondences
        )


def test_register_rig_pairs_adjacent():
    """Cyclic adjacent-pair rig registration recovers each inter-camera
    offset."""
    mesh = make_camera_mesh(4, axis="pair")
    # direct7 + 2^13 table: with direct1 at a 4096-slot table the 6° wrap
    # pair found a wrong minimum (terr 0.20 — collision-degraded sparse
    # correspondences, ncorr 325/1500); the multi-voxel search converges
    # every pair to <0.7° / 7 mm (measured). Static config matches
    # test_batched_pair_solves_bitwise_match_sequential so both tests
    # share one SPMD executable (minutes of compile on a 1-core host).
    cfg = GICPConfig.create(resolution=0.05, voxel_size=0.02,
                            kernel_width=0.0, kernel_max_dist=-1.0,
                            max_iterations=24, table_size=1 << 13,
                            neighbor_search="direct7")
    base = oracles.make_bunny_like_cloud(1500)
    n = 4
    # 2° / 2 cm steps: the cyclic wrap pair then carries a 6° / 6 cm
    # offset — inside the direct1 single-stage basin (~8° / 10 cm at
    # resolution 0.05; 3° steps put the wrap pair at 9° and it diverged).
    poses = [small_transform(2.0 * i, 0.02 * i) for i in range(n)]
    clouds = np.stack([apply(np.linalg.inv(p), base) for p in poses])
    valids = jnp.ones((n, clouds.shape[1]), bool)

    res = register_rig_pairs(mesh, jnp.asarray(clouds), valids, cfg)
    for i in range(n):
        j = (i + 1) % n
        # x_i = inv(P_i) b, x_j = inv(P_j) b ⇒ x_i = inv(P_i) P_j x_j.
        want = np.linalg.inv(poses[i]) @ poses[j]
        ang, terr = _pose_errors(np.asarray(res.transform[i]), want)
        assert ang < 1.2 and terr < 0.012, (i, ang, terr)
