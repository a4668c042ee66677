"""Benchmark: dual-camera fused frame time on one GPU.

Prints one JSON line on stdout:

  {"metric": "fused_ms_per_frame_dual_WxH", "value": ms, "unit": "ms",
   "device": {"platform", "kind", "count", "card", "power_limit"}, ...}

``value`` is the mean device time per fused frame of the bit-exact
image-only fuse (render_mode "tiled", emit_zbuf False — the fused image is
what the reference's fusion node publishes), over ``--iters`` calls that
rotate through ``--frames`` distinct frame pairs, enqueued back to back and
fenced once with ``block_until_ready``. Secondary modes, an optional
N-camera rig and the warm registration solve follow in the same line; the
registration term runs at the reference's 0.5 Hz cadence
(registration_node/config/config_default.yaml:13), so the line carries
its amortization per 30 FPS frame.

Without a GPU the run fails; ``--cpu`` runs it on the host CPU on purpose
(a smoke run: its metric name ends in ``_cpu_smoke``). A failed parity gate
(tpu_check.py) or any exception exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

# 30 Hz capture cadence (camera_node.cpp:146) and 0.5 Hz registration tick
# (registration_node config_default.yaml:13) — the amortization constants.
FRAME_RATE_HZ = 30.0
REGISTRATION_CADENCE_HZ = 0.5


def card_info() -> tuple:
    """(name, power limit) as nvidia-smi reports them, or (None, None)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None, None
    name, _, limit = out.partition(",")
    return name.strip(), limit.strip()


def time_calls(fn, inputs, iters: int) -> float:
    """Mean ms per call over ``iters`` calls enqueued back to back."""
    import jax

    jax.block_until_ready(fn(*inputs[0]))  # compile + first run
    for args in inputs:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*inputs[i % len(inputs)]) for i in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the host CPU (smoke run)")
    parser.add_argument("--no-parity", action="store_true",
                        help="skip the parity gate (tpu_check.py)")
    parser.add_argument("--no-registration", action="store_true",
                        help="skip the warm-registration measurement")
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--frames", type=int, default=4,
                        help="distinct frame pairs to rotate through")
    parser.add_argument("--width", type=int, default=848)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument(
        "--rig", type=int, default=0,
        help="also measure N-camera single-device rig fusion",
    )
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        raise SystemExit(f"bench: no GPU (JAX devices: {jax.devices()})")

    from pointcloud_depthfusion_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    import jax.numpy as jnp
    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import (
        Intrinsics,
        fused_virtual_intrinsics,
    )
    from pointcloud_depthfusion_tpu.core.frameset import Frameset
    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig, fuse
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        right_to_left_transform,
        two_camera_rig,
    )

    w, h = args.width, args.height
    fx = 631.0 * w / 848.0
    intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    t_rl = jnp.asarray(right_to_left_transform(wl, wr), jnp.float32)
    pairs = []
    for k in range(args.frames):
        fl = scene.render(intr, wl, depth_noise_std=0.002, hole_fraction=0.01,
                          seed=2 * k)
        fr = scene.render(intr, wr, depth_noise_std=0.002, hole_fraction=0.01,
                          seed=2 * k + 1)
        pairs.append((Frameset.create(fl.depth, fl.color, intr),
                      Frameset.create(fr.depth, fr.color, intr), t_rl))
    config = FusionConfig.create(vertical_image=True, mirror_image=True)
    fused_intr = fused_virtual_intrinsics(intr, config.vertical_image)

    def fuse_ms(cfg) -> float:
        fn = jax.jit(lambda l, r, t: fuse(l, r, t, cfg, fused_intr).image)
        return time_calls(fn, pairs, args.iters)

    modes = {
        "tiled_image_only": dataclasses.replace(config, emit_zbuf=False),
        "tiled_zbuf": config,
        "indexed": dataclasses.replace(config, render_mode="indexed"),
        "packed": dataclasses.replace(config, render_mode="packed"),
    }
    ms = {}
    for name, cfg in modes.items():
        ms[name] = fuse_ms(cfg)
        print(f"{name}: {ms[name]:.4f} ms/frame", file=sys.stderr)

    if args.rig:
        from pointcloud_depthfusion_tpu.io.synthetic import rig_arc_poses
        from pointcloud_depthfusion_tpu.parallel.mesh import rig_fuse

        n = args.rig
        poses = rig_arc_poses(n, span=0.8, toe_in_deg_per_m=-37.5)
        rig_cfg = dataclasses.replace(
            config, vertical_image=False, filter_fused_color=False
        )
        fn = rig_fuse(intr, intr, rig_cfg)
        rig_in = []
        for k in range(args.frames):
            fs = [scene.render(intr, p, depth_noise_std=0.002,
                               seed=k * n + i) for i, p in enumerate(poses)]
            rig_in.append((
                jnp.asarray(np.stack([f.depth for f in fs])),
                jnp.asarray(np.stack([f.color for f in fs])),
                jnp.full((n,), 0.001, jnp.float32),
                jnp.asarray(np.stack(poses), jnp.float32),
            ))
        ms[f"rig_{n}cam"] = time_calls(fn, rig_in, args.iters)
        print(f"rig {n} cameras: {ms[f'rig_{n}cam']:.4f} ms/frame",
              file=sys.stderr)

    reg_ms = None
    if not args.no_registration:
        from pointcloud_depthfusion_tpu.registration.gicp import (
            GICPConfig,
            gicp_register_prepared,
            prepare_target,
        )
        from tpu_check import _build_gicp_inputs

        src, sv, tgt, tv = _build_gicp_inputs()
        # Same config as the parity gate's GICP check: a converged warm tick
        # exits the while_loop in 2-4 iterations, like the 0.5 Hz tick.
        gcfg = GICPConfig.create(
            resolution=0.1, voxel_size=0.05, kernel_width=0.05,
            kernel_max_dist=0.25, max_iterations=30, table_size=1 << 13,
        )
        grid = prepare_target(tgt, tv, gcfg)
        # Clouds and grid as jit arguments: closed-over arrays would be
        # embedded in the program as constants.
        solve = jax.jit(lambda t, s, v, g: gicp_register_prepared(
            s, v, g, t, gcfg).transform)
        warm = solve(jnp.eye(4, dtype=jnp.float32), src, sv, grid)
        reg_ms = time_calls(solve, [(warm, src, sv, grid)],
                            max(4, args.iters // 20))
        print(f"registration warm solve: {reg_ms:.4f} ms", file=sys.stderr)

    parity = "skipped"
    parity_checks = None
    if not args.no_parity:
        import tpu_check

        pres = tpu_check.run_parity(w, h)
        parity = pres["parity"]
        parity_checks = {
            k: "pass" if v["pass"] else {"FAIL": v} for k, v in
            pres["checks"].items()
        }

    card, power_limit = card_info()
    out = {
        "metric": f"fused_ms_per_frame_dual_{w}x{h}"
                  + ("_cpu_smoke" if args.cpu else ""),
        "value": ms["tiled_image_only"],
        "unit": "ms",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card,
                   "power_limit": power_limit},
        "ms": ms,
        "parity": parity,
        "registration_cadence_hz": REGISTRATION_CADENCE_HZ,
        "registration_ms_warm": reg_ms,
        "amortized_ms_per_frame": (
            reg_ms * REGISTRATION_CADENCE_HZ / FRAME_RATE_HZ
            if reg_ms is not None else None
        ),
    }
    if parity_checks is not None:
        out["parity_checks"] = parity_checks
    print(json.dumps(out), flush=True)
    if parity not in ("pass", "skipped"):
        sys.exit(1)


if __name__ == "__main__":
    main()
