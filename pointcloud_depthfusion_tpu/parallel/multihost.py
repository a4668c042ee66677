"""Multi-host scale-out: camera rigs spanning accelerator hosts.

The reference spans two machines over DDS/UDP (README.md:14-34: one Jetson
per camera, fusion subscribing over the network). The equivalent here
keeps the SAME sharded program as parallel/mesh.py — cameras sharded over a
mesh, one ``pmin`` merge — but the mesh spans processes: `jax.distributed`
coordinates the hosts, each process contributes its locally-attached
cameras' framesets via ``jax.make_array_from_process_local_data``, and the
collective rides the intra-host interconnect (NVLink) within a host and
the network between hosts (the SURVEY §2.8 mapping).

On a cluster whose environment JAX can detect, this initializes from
it. For development and CI the same code path runs as N CPU
processes with gloo collectives — ``python -m
pointcloud_depthfusion_tpu.parallel.multihost --num-processes 2
--process-id k`` launches one worker (see tests/test_multihost.py, which
verifies the two-process fused image equals the single-process result).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_virtual_devices: Optional[int] = None,
) -> None:
    """Bring up the distributed runtime for a process-spanning mesh.

    On a cluster JAX can auto-detect, call with no arguments.
    For the CPU simulation, pass coordinator/num_processes/process_id and
    optionally ``local_virtual_devices`` to give each process N virtual
    CPU devices; CPU cross-process collectives use gloo.
    """
    if local_virtual_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_virtual_devices}"
            ).strip()
    import jax

    # NOTE: nothing here may touch the backend (jax.devices/default_backend)
    # — jax.distributed.initialize must run first. CPU-simulation mode is
    # decided from the arguments alone.
    if local_virtual_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def global_camera_mesh(axis: str = "cam"):
    """1-D mesh over every device of every participating process."""
    import jax
    from jax.experimental import mesh_utils
    from jax.sharding import Mesh

    return Mesh(mesh_utils.create_device_mesh((jax.device_count(),)), (axis,))


def shard_local_cameras(mesh, axis: str, *host_arrays: np.ndarray):
    """Build global camera-sharded arrays from each process's LOCAL cameras.

    Every process passes arrays whose leading axis covers its local cameras
    (local_device_count entries); the result is the global (num_cameras,
    ...) array sharded over the mesh — the framework's replacement for the
    reference's DDS network hop of full framesets.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return tuple(
        jax.make_array_from_process_local_data(sharding, np.asarray(a))
        for a in host_arrays
    )


def _worker(args) -> None:
    initialize_multihost(
        args.coordinator, args.num_processes, args.process_id,
        local_virtual_devices=args.local_devices,
    )
    import jax

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene
    from pointcloud_depthfusion_tpu.parallel.mesh import rig_fuse_sharded

    mesh = global_camera_mesh()
    n_cams = jax.device_count()
    local = jax.local_device_count()
    first = args.process_id * local

    w, h = args.width, args.height
    intr = Intrinsics.create(w, h, fx=50.0 * w / 64, fy=50.0 * w / 64,
                             ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    depths, colors, poses = [], [], []
    for i in range(first, first + local):
        yaw = np.deg2rad(-15 + 30 * i / max(n_cams - 1, 1))
        rot = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                        [-np.sin(yaw), 0, np.cos(yaw)]])
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = [0.8 * (i / max(n_cams - 1, 1) - 0.5), 0, 0]
        poses.append(m.astype(np.float32))
        fs = scene.render(intr, m)
        depths.append(fs.depth)
        colors.append(fs.color)

    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 filter_fused_color=False)
    depth_g, color_g, scale_g, pose_g = shard_local_cameras(
        mesh, "cam",
        np.stack(depths), np.stack(colors),
        np.full((local,), 0.001, np.float32), np.stack(poses),
    )
    fn = rig_fuse_sharded(mesh, intr, intr, config)
    img = np.asarray(jax.block_until_ready(fn(depth_g, color_g, scale_g, pose_g)))
    coverage = float((img.sum(-1) > 0).mean())
    print(
        f"multihost worker {args.process_id}/{args.num_processes}: fused "
        f"{img.shape} coverage {coverage:.2f}", flush=True,
    )
    if args.out and args.process_id == 0:
        np.save(args.out, img)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="multi-host rig-fusion worker (one process per host)"
    )
    parser.add_argument("--coordinator", default="localhost:12355")
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--local-devices", type=int, default=2,
                        help="virtual CPU devices per process (simulation); "
                        "0 = use real local devices")
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--height", type=int, default=48)
    parser.add_argument("--out", default="",
                        help="process 0 writes the fused image here (.npy)")
    args = parser.parse_args()
    _worker(args)


if __name__ == "__main__":
    main()
