"""Time the fused-frame programs, and the alignment candidates in them.

Each case is the whole program a user runs — the dual fuse, the image-only
dual fuse, the N-camera rig, and the aligned dual fuse once per alignment
method of ops/backend.py — timed on distinct input frames, rotating
through ``--frames`` sets, with ``block_until_ready`` as the fence. Two
numbers per case:

- ``pipelined_ms``: mean time per call over ``--iters`` calls enqueued
  back to back, one fence at the end (device throughput);
- ``fenced_p50_ms``: median over calls each fenced on its own (latency,
  including dispatch).

The alignment candidates must agree bit for bit; the script fails
otherwise. Prints one JSON line per case, and the card's name and power
limit first.

    python tools/kernel_timing.py                     # on the card
    JAX_PLATFORMS=cpu python tools/kernel_timing.py --small
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def _choice(op: str, impl: str):
    """Trace with ``op`` forced to ``impl`` on the current platform."""
    import jax

    from pointcloud_depthfusion_tpu.ops import backend

    table = backend._CHOICES[jax.default_backend()]
    old = table[op]
    table[op] = impl
    try:
        yield
    finally:
        table[op] = old


def _time(fn, inputs, iters):
    import jax

    jax.block_until_ready(fn(*inputs[0]))  # compile + first run
    for i in range(3):
        jax.block_until_ready(fn(*inputs[i % len(inputs)]))
    t0 = time.perf_counter()
    outs = [fn(*inputs[i % len(inputs)]) for i in range(iters)]
    jax.block_until_ready(outs)
    pipelined = (time.perf_counter() - t0) * 1e3 / iters
    fenced = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*inputs[i % len(inputs)]))
        fenced.append((time.perf_counter() - t0) * 1e3)
    return pipelined, float(np.median(fenced))


def _dual_inputs(width, height, n_frames):
    import jax.numpy as jnp

    from pointcloud_depthfusion_tpu.core.camera import Extrinsics, Intrinsics
    from pointcloud_depthfusion_tpu.core.frameset import Frameset
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        right_to_left_transform,
        two_camera_rig,
    )

    fx = 631.0 * width / 848.0
    intr = Intrinsics.create(width, height, fx=fx, fy=fx, ppx=width / 2,
                             ppy=height / 2)
    d_intr = Intrinsics.create(width, height, fx=595.0 * width / 848.0,
                               fy=595.0 * width / 848.0, ppx=width / 2 + 3.1,
                               ppy=height / 2 - 2.2)
    ext = Extrinsics.create(np.eye(3, dtype=np.float32), [0.015, -0.001, 0.002])
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    t_rl = jnp.asarray(right_to_left_transform(wl, wr), jnp.float32)
    frames = []
    for k in range(n_frames):
        fl = scene.render(intr, wl, depth_noise_std=0.002, hole_fraction=0.01,
                          seed=2 * k)
        fr = scene.render(intr, wr, depth_noise_std=0.002, hole_fraction=0.01,
                          seed=2 * k + 1)
        frames.append((
            Frameset.create(fl.depth, fl.color, intr),
            Frameset.create(fr.depth, fr.color, intr),
            Frameset.create(fl.depth, fl.color, intr, depth_intrinsics=d_intr,
                            depth_to_color=ext),
            Frameset.create(fr.depth, fr.color, intr, depth_intrinsics=d_intr,
                            depth_to_color=ext),
        ))
    return intr, t_rl, frames


def _rig_inputs(n_cams, width, height, n_frames):
    import jax.numpy as jnp

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        rig_arc_poses,
    )

    fx = 631.0 * width / 848.0
    intr = Intrinsics.create(width, height, fx=fx, fy=fx, ppx=width / 2,
                             ppy=height / 2)
    poses = rig_arc_poses(n_cams, span=0.8, toe_in_deg_per_m=37.5)
    scene = SyntheticScene()
    sets = []
    for k in range(n_frames):
        fs = [scene.render(intr, p, depth_noise_std=0.002, seed=k * n_cams + i)
              for i, p in enumerate(poses)]
        sets.append((
            jnp.asarray(np.stack([f.depth for f in fs])),
            jnp.asarray(np.stack([f.color for f in fs])),
            jnp.full((n_cams,), 0.001, jnp.float32),
            jnp.asarray(np.stack(poses), jnp.float32),
        ))
    return intr, sets


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--align-impls", default="scatter,binned,binned,scatter",
                   help="alignment candidates, in the order timed")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--frames", type=int, default=4,
                   help="distinct input sets to rotate through")
    p.add_argument("--small", action="store_true",
                   help="tiny shapes for a CPU rehearsal")
    args = p.parse_args()

    import jax

    from pointcloud_depthfusion_tpu.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig, fuse
    from pointcloud_depthfusion_tpu.parallel.mesh import rig_fuse
    from pointcloud_depthfusion_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.small:
        raise SystemExit(f"kernel_timing: no GPU (JAX devices: "
                         f"{jax.devices()}); --small rehearses on the CPU")
    print(f"devices: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    if dev.platform == "gpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
        ).stdout.strip(), flush=True)

    dual_wh = (64, 48) if args.small else (1280, 720)
    rig_shape = (3, 48, 32) if args.small else (8, 848, 480)

    intr, t_rl, frames = _dual_inputs(*dual_wh, args.frames)
    fused_intr = fused_virtual_intrinsics(intr, True)
    base = FusionConfig.create(vertical_image=True, mirror_image=True)

    def report(case, impl, ms, n_entries):
        print(json.dumps({"case": case, "impl": impl,
                          "pipelined_ms": ms[0], "fenced_p50_ms": ms[1],
                          "entries": n_entries}), flush=True)

    def check_equal(case, outs):
        ref_impl, ref = next(iter(outs.items()))
        for impl, out in outs.items():
            for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    raise SystemExit(f"{case}: {impl} differs from {ref_impl}")
        print(f"{case}: {', '.join(outs)} bit-identical", flush=True)

    dual_in = [(f[0], f[1], t_rl) for f in frames]
    n_dual = 2 * dual_wh[0] * dual_wh[1]
    for case, cfg in (("dual", base),
                      ("dual_image_only",
                       dataclasses.replace(base, emit_zbuf=False))):
        fn = jax.jit(lambda l, r, t, cfg=cfg: fuse(l, r, t, cfg,
                                                   fused_intr).image)
        report(case, "plain", _time(fn, dual_in, args.iters), n_dual)

    n_cams, rw, rh = rig_shape
    rig_intr, rig_in = _rig_inputs(n_cams, rw, rh, args.frames)
    rig_cfg = FusionConfig.create(vertical_image=False, mirror_image=False,
                                  filter_fused_color=False)
    fn = rig_fuse(rig_intr, rig_intr, rig_cfg)
    report(f"rig{n_cams}", "plain", _time(fn, rig_in, args.iters),
           n_cams * rw * rh)

    from pointcloud_depthfusion_tpu.ops.align import auto_footprint

    f0 = frames[0][2]
    align_cfg = dataclasses.replace(
        base, align_frames=True, align_footprint=auto_footprint(
            f0.depth_intrinsics, f0.color_intrinsics, f0.depth_to_color),
    )
    align_in = [(f[2], f[3], t_rl) for f in frames]
    outs = {}
    for impl in args.align_impls.split(","):
        with _choice("align", impl):
            fn = jax.jit(lambda l, r, t: fuse(l, r, t, align_cfg,
                                              fused_intr).image)
            outs[impl] = fn(*align_in[0])
            report("dual_aligned", impl, _time(fn, align_in, args.iters),
                   n_dual)
    check_equal("dual_aligned", outs)


if __name__ == "__main__":
    main()
