"""Smoke test of the fusion main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-4 below
    python chip_smoke.py --four-cards  # four cards: the camera-sharded path

Phases on one card, each through the entry points a user calls:

1. device: JAX's first device must be a GPU; prints the card's name and
   power limit;
2. dual: the reference mirror (configs/deployment_dual.yaml) at its native
   1280x720 through ``nodes.launch.run_deployment`` — synthetic cameras,
   FusionNodeApp + RegistrationNodeApp, viewer off;
3. parity: ``tpu_check.run_parity(1280, 720)`` against CPU goldens
   computed in a child process that never opens the card;
4. rig: RigFusionNodeApp with 4 x 1280x720 cameras
   (configs/deployment_rig4.yaml) through ``run_deployment``.

``--four-cards`` runs only the multi-card path and what it is compared
with: 8 x 1280x720 cameras, 2 per card, through ``rig_fuse_sharded``
against ``rig_fuse`` on one card (bit-identical), and a point-sharded GICP
solve against the single-device solve (within 5e-4).

Any failure raises and exits non-zero. The last line of standard output is
one JSON object ``{"ok": true, "device": {...}}``, printed only when every
phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1280, 720
DUAL_FRAMES = 36
RIG_FRAMES = 12
MIN_COVERAGE = 0.5  # fused-image share of non-black pixels


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_device(four_cards: bool):
    import jax

    devs = jax.devices()
    require(devs[0].platform == "gpu",
            f"no GPU: JAX's devices are {devs}")
    need = 4 if four_cards else 1
    require(len(devs) >= need, f"need {need} GPUs, have {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {smi}")
    log(f"[device] jax {jax.__version__}: {devs[0].device_kind} "
        f"x{len(devs)}")
    return devs


def _manifest(name: str, frames: int, reg_every: int) -> dict:
    from pointcloud_depthfusion_tpu.nodes.launch import load_manifest

    manifest = load_manifest(os.path.join(ROOT, "configs", name))
    manifest.update(width=WIDTH, height=HEIGHT, frames=frames)
    manifest["registration"] = {"every_n_frames": reg_every}
    manifest.pop("viewer", None)
    return manifest


def _check_deployment(tag: str, summary: dict, frames: int, min_ticks: int,
                      cameras: int) -> None:
    log(f"[{tag}] {json.dumps(summary)}")
    require(summary["cameras"] == cameras, f"{tag}: {summary['cameras']} "
            f"cameras, expected {cameras}")
    require(summary["frames"] == frames,
            f"{tag}: fused {summary['frames']} of {frames} frames")
    require(summary["published"] == frames,
            f"{tag}: published {summary['published']} of {frames} frames")
    require(summary["fused_shape"][0] * summary["fused_shape"][1]
            == WIDTH * HEIGHT, f"{tag}: fused shape {summary['fused_shape']}")
    require(summary["registration_ticks"] >= min_ticks,
            f"{tag}: {summary['registration_ticks']} registration ticks")
    require(summary["fused_coverage"] > MIN_COVERAGE,
            f"{tag}: coverage {summary['fused_coverage']} <= {MIN_COVERAGE}")


def phase_dual() -> None:
    from pointcloud_depthfusion_tpu.nodes.launch import run_deployment

    t0 = time.perf_counter()
    summary = run_deployment(_manifest("deployment_dual.yaml", DUAL_FRAMES,
                                       reg_every=12))
    _check_deployment("dual", summary, DUAL_FRAMES, min_ticks=2, cameras=2)
    log(f"[dual] ok in {time.perf_counter() - t0:.1f} s")


def phase_parity() -> None:
    sys.path.insert(0, ROOT)
    import tpu_check

    t0 = time.perf_counter()
    result = tpu_check.run_parity(WIDTH, HEIGHT)
    for name, check in result["checks"].items():
        log(f"[parity] {name}: {json.dumps(check)}")
    require(result["parity"] == "pass", "parity failed")
    log(f"[parity] ok ({len(result['checks'])} checks) in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_rig() -> None:
    from pointcloud_depthfusion_tpu.nodes.launch import run_deployment

    t0 = time.perf_counter()
    summary = run_deployment(_manifest("deployment_rig4.yaml", RIG_FRAMES,
                                       reg_every=6))
    _check_deployment("rig", summary, RIG_FRAMES, min_ticks=2, cameras=4)
    log(f"[rig] ok in {time.perf_counter() - t0:.1f} s")


def phase_four_cards() -> None:
    """Camera-sharded rig and point-sharded GICP on a 4-card mesh."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import tpu_check
    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig
    from pointcloud_depthfusion_tpu.parallel.mesh import (
        make_camera_mesh,
        rig_fuse,
        rig_fuse_sharded,
    )
    from pointcloud_depthfusion_tpu.registration.distributed import (
        gicp_register_sharded,
    )
    from pointcloud_depthfusion_tpu.registration.gicp import (
        GICPConfig,
        gicp_register,
    )

    t0 = time.perf_counter()
    intr, args = tpu_check._build_rig(8, WIDTH, HEIGHT)
    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 filter_fused_color=False)
    one = rig_fuse(intr, intr, config)(*args)
    mesh = make_camera_mesh(4)
    sharded = rig_fuse_sharded(mesh, intr, intr, config)(*args)
    one, sharded = np.asarray(one), np.asarray(sharded)
    coverage = float((one.sum(-1) > 0).mean())
    diff = float((one != sharded).any(-1).mean())
    log(f"[four-cards] rig 8x{WIDTH}x{HEIGHT} over {mesh.devices.size} "
        f"cards: coverage {coverage:.3f}, pixels differing from one card "
        f"{diff}")
    require(coverage > MIN_COVERAGE, f"sharded rig coverage {coverage}")
    require(np.array_equal(one, sharded),
            "sharded rig differs from the one-card rig")

    src, sv, tgt, tv = tpu_check._build_gicp_inputs()
    cfg = GICPConfig.create(
        resolution=0.1, voxel_size=0.05, kernel_width=0.05,
        kernel_max_dist=0.25, max_iterations=30, table_size=1 << 13,
    )
    eye = jnp.eye(4, dtype=jnp.float32)
    single = jax.jit(gicp_register)(src, sv, tgt, tv, eye, cfg)
    pt_mesh = make_camera_mesh(4, axis="pt")
    shard = gicp_register_sharded(pt_mesh, src, sv, tgt, tv, eye, cfg)
    dt = float(np.abs(np.asarray(shard.transform)
                      - np.asarray(single.transform)).max())
    log(f"[four-cards] point-sharded gicp: max |dT| vs one card {dt:.3e}, "
        f"fitness {float(shard.fitness):.3e} vs {float(single.fitness):.3e}, "
        f"{int(shard.num_correspondences)} correspondences")
    require(dt <= 5e-4, f"sharded GICP off by {dt}")
    log(f"[four-cards] ok in {time.perf_counter() - t0:.1f} s")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded path")
    args = parser.parse_args()

    sys.path.insert(0, ROOT)
    devs = phase_device(args.four_cards)
    import jax

    from pointcloud_depthfusion_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    cache = enable_persistent_cache()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"[cache] {cache}: {n_cached} entries at start")
    lookups = {"cache_hits": 0, "cache_misses": 0}

    def count_lookup(event: str, **_) -> None:
        name = event.rsplit("/", 1)[-1]
        if event.startswith("/jax/compilation_cache/") and name in lookups:
            lookups[name] += 1

    jax.monitoring.register_event_listener(count_lookup)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_dual()
        phase_parity()
        phase_rig()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"[cache] {cache}: {n_cached} entries at end, "
        f"{lookups['cache_hits']} hits, {lookups['cache_misses']} misses")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
