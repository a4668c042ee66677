"""Parity gate: prove the accelerator's programs compute the right pixels,
not just fast ones.

All unit tests run on the CPU. This script runs each production program
ONCE on the default backend (the GPU) and compares against golden results
computed on the CPU, so a miscompile or a wrong kernel cannot ship a fast,
wrong image. It mirrors the correctness claims of the reference kernels
(kernels.cu:239-274 render, :714-747 align).

Two classes of check:

1. **Same-device bit-exactness** (immune to cross-backend float noise —
   identical inputs, identical projection math, same device):
     * the image-only fuse (emit_zbuf=False) and the pre-packed-colour
       fuse against the full fuse: bit-identical images;
     * binned align against scatter align: bit-identical u16.

2. **Cross-backend golden comparison**: a subprocess pinned to the CPU
   (``JAX_PLATFORMS=cpu``, so it never opens the card) computes the same
   programs; the device results must match within envelopes. Exact-winner
   modes are compared bit-per-pixel with a tiny mismatch budget (0.1% of
   pixels) covering FMA-contraction differences between backends at
   winner near-ties; quantized modes (indexed/packed) get their documented
   precision envelopes; GICP transforms agree to 5e-3.

Usage:
  python tpu_check.py              # full gate on the default backend
  python tpu_check.py --oracle F   # internal: CPU-golden subprocess
Emits one JSON line {"parity": "pass"|"fail", "checks": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# Winner-selection divergence budget for cross-backend comparison of
# bit-exact-on-one-backend modes: CPU and GPU may contract the projection
# chain differently (fma), flipping winners at exact near-ties.
CROSS_BACKEND_PIXEL_BUDGET = 1e-3


def _build_rig(n: int, width: int, height: int):
    """n-camera arc rig inputs (same construction as bench.py --rig)."""
    import jax.numpy as jnp

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene

    scene = SyntheticScene()
    intr = Intrinsics.create(
        width, height, fx=631.0 * width / 848.0, fy=631.0 * width / 848.0,
        ppx=width / 2, ppy=height / 2,
    )
    poses, depths, colors = [], [], []
    for i in range(n):
        yaw = np.deg2rad(-15 + 30 * i / max(n - 1, 1))
        rot = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
             [-np.sin(yaw), 0, np.cos(yaw)]]
        )
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = [0.8 * (i / max(n - 1, 1) - 0.5), 0, 0]
        poses.append(m)
        fs = scene.render(intr, m, seed=i)
        depths.append(fs.depth)
        colors.append(fs.color)
    args = (
        jnp.asarray(np.stack(depths)),
        jnp.asarray(np.stack(colors)),
        jnp.full((n,), 0.001, jnp.float32),
        jnp.asarray(np.stack(poses), jnp.float32),
    )
    return intr, args


def _build_align_inputs(width: int, height: int):
    """D455-like depth/color pair with a real baseline + toe-in."""
    from pointcloud_depthfusion_tpu.core.camera import Extrinsics, Intrinsics
    from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene

    d_intr = Intrinsics.create(
        width, height, fx=595.0 * width / 848.0, fy=595.0 * width / 848.0,
        ppx=width / 2 + 3.1, ppy=height / 2 - 2.2,
    )
    c_intr = Intrinsics.create(
        width, height, fx=631.0 * width / 848.0, fy=633.0 * width / 848.0,
        ppx=width / 2 - 1.4, ppy=height / 2 + 1.8,
    )
    a = 0.01
    rot = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    ext = Extrinsics.create(rot, [0.015, -0.001, 0.002])
    fs = SyntheticScene().render(d_intr, np.eye(4), depth_noise_std=0.002,
                                 hole_fraction=0.02, seed=7)
    return d_intr, c_intr, ext, fs.depth


def _build_gicp_inputs():
    import jax.numpy as jnp

    from pointcloud_depthfusion_tpu.core import geometry as G
    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.synthetic import (
        SyntheticScene,
        two_camera_rig,
    )
    from pointcloud_depthfusion_tpu.ops import filters as F

    w, h = 424, 240
    intr = Intrinsics.create(w, h, fx=315.0, fy=315.0, ppx=w / 2, ppy=h / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.6, toe_in_deg=10.0)
    fl = scene.render(intr, wl, depth_noise_std=0.001)
    fr = scene.render(intr, wr, depth_noise_std=0.001, seed=1)

    def to_cloud(d):
        dd, vv = F.filter_depth(jnp.asarray(d), 0.001, 0.5, 10.0, None)
        pts, vv = G.deproject(dd.astype(jnp.float32) * 0.001, intr, vv)
        return pts.reshape(-1, 3), vv.reshape(-1)

    tgt, tv = to_cloud(fl.depth)
    src, sv = to_cloud(fr.depth)
    return src, sv, tgt, tv


def compute_results(width: int, height: int, rig_cameras: int = 4) -> dict:
    """Run every gated program on the CURRENT backend; return numpy results."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from pointcloud_depthfusion_tpu.ops.align import align_depth_to_color
    from pointcloud_depthfusion_tpu.parallel.mesh import rig_fuse
    from pointcloud_depthfusion_tpu.registration.gicp import (
        GICPConfig,
        gicp_register,
    )

    out: dict[str, np.ndarray] = {}
    backend = jax.default_backend()
    on_cpu = backend == "cpu"

    step, (left, right, t_rl, config) = graft._build_fusion(width, height)
    from pointcloud_depthfusion_tpu.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu.fusion.pipeline import RENDER_MODES, fuse

    fused_intr = fused_virtual_intrinsics(
        left.color_intrinsics, config.vertical_image
    )

    @jax.jit
    def one(left, right, t_rl, cfg):
        res = fuse(left, right, t_rl, cfg, fused_intr)
        return res.image, res.zbuf

    for mode in RENDER_MODES:
        cfg = dataclasses.replace(config, render_mode=mode)
        img, zbuf = one(left, right, t_rl, cfg)
        out[f"fuse_{mode}_img"] = np.asarray(img)
        out[f"fuse_{mode}_zbuf"] = np.asarray(zbuf)
        print(f"[{backend}] fuse {mode} done", file=sys.stderr, flush=True)

    # Image-only fuse (emit_zbuf=False): same-device bit-equality against
    # the full fuse.
    if not on_cpu:
        cfg_img = dataclasses.replace(config, render_mode="tiled",
                                      emit_zbuf=False)
        res_img = jax.jit(
            lambda l, r, t: fuse(l, r, t, cfg_img, fused_intr).image
        )(left, right, t_rl)
        out["fuse_tiled_imgonly"] = np.asarray(res_img)
        print(f"[{backend}] fuse tiled image-only done", file=sys.stderr,
              flush=True)

        # Pre-packed rgb24 plane (Frameset.color_packed): the render
        # consumes the packed plane instead of slicing HWC u8 channels —
        # must be bit-identical on the device, not just on CPU (tests
        # already cover that).
        res_pk = jax.jit(
            lambda l, r, t: fuse(
                l.with_packed_color(), r.with_packed_color(), t,
                cfg_img, fused_intr,
            ).image
        )(left, right, t_rl)
        out["fuse_tiled_packedplane"] = np.asarray(res_pk)
        print(f"[{backend}] fuse tiled packed-plane done", file=sys.stderr,
              flush=True)

    # N-camera rig, bit-exact path (one winner selection over all
    # cameras' entries).
    rig_intr, rig_args = _build_rig(rig_cameras, width, height)
    rig_cfg = dataclasses.replace(
        config, vertical_image=False, filter_fused_color=False,
        render_mode="tiled",
    )
    rig_img = rig_fuse(rig_intr, rig_intr, rig_cfg)(*rig_args)
    out["rig_img"] = np.asarray(rig_img)
    print(f"[{backend}] rig done", file=sys.stderr, flush=True)

    # Depth→color alignment: scatter path everywhere; binned additionally
    # on the device for the bit-equality check.
    d_intr, c_intr, ext, depth = _build_align_inputs(width, height)
    depth_j = jnp.asarray(depth)

    import functools

    # depth passed as a jit ARGUMENT, not a closure: closed-over device
    # arrays embed as program constants (slow compiles, no persistent-
    # cache hits).
    @functools.partial(jax.jit, static_argnames=("method",))
    def align_with(d, method):
        return align_depth_to_color(
            d, 0.001, d_intr, c_intr, ext, max_footprint="auto",
            method=method,
        )

    out["align_scatter"] = np.asarray(align_with(depth_j, "scatter"))
    if not on_cpu:
        out["align_binned"] = np.asarray(align_with(depth_j, "binned"))
    print(f"[{backend}] align done", file=sys.stderr, flush=True)

    src, sv, tgt, tv = _build_gicp_inputs()

    # Warm-style GICP solve (identity guess, capped iterations).
    gcfg = GICPConfig.create(
        resolution=0.1, voxel_size=0.05, kernel_width=0.05,
        kernel_max_dist=0.25, max_iterations=30, table_size=1 << 13,
    )
    # JIT like every production caller (registration/pipeline.py jits the
    # whole tick).
    res = jax.jit(gicp_register)(
        src, sv, tgt, tv, jnp.eye(4, dtype=jnp.float32), gcfg
    )
    out["gicp_transform"] = np.asarray(res.transform)
    out["gicp_fitness"] = np.asarray(res.fitness)
    print(f"[{backend}] gicp done "
          f"(fitness {float(res.fitness):.2e})", file=sys.stderr, flush=True)
    return out


# ---------------------------------------------------------------------------
# comparison


def _frac_mismatch(a: np.ndarray, b: np.ndarray) -> float:
    if a.ndim == 3:  # image: a pixel differs if ANY channel differs
        diff = (a != b).any(axis=-1)
    else:
        diff = a != b
    return float(diff.mean())


def compare(dev: dict, cpu: dict, width: int, height: int) -> dict:
    """All parity checks → {"parity": ..., "checks": {name: {...}}}."""
    # A golden npz recorded at another resolution (possible with an
    # explicit --oracle-cache path) would otherwise fail every
    # array_equal with no diagnostic — reject it up front.
    fh, fw = cpu["fuse_tiled_img"].shape[:2]
    if (fw, fh) not in ((width, height), (height, width)):
        raise ValueError(
            f"golden npz is {fw}x{fh} but the gate runs {width}x{height} "
            "(stale --oracle-cache file?)"
        )
    checks: dict[str, dict] = {}

    def add(name, ok, **info):
        checks[name] = {"pass": bool(ok), **{k: v for k, v in info.items()}}

    # -- same-device bit-exactness -----------------------------------------
    add(
        "tiled_vs_exact",
        np.array_equal(dev["fuse_tiled_img"], dev["fuse_exact_img"])
        and np.array_equal(dev["fuse_tiled_zbuf"], dev["fuse_exact_zbuf"]),
        img_mismatch=_frac_mismatch(dev["fuse_tiled_img"],
                                    dev["fuse_exact_img"]),
    )
    for key, name in (("fuse_tiled_imgonly", "imgonly_vs_full"),
                      ("fuse_tiled_packedplane", "packedplane_vs_hwc")):
        if key in dev:
            add(name, np.array_equal(dev[key], dev["fuse_tiled_img"]),
                img_mismatch=_frac_mismatch(dev[key], dev["fuse_tiled_img"]))
    if "align_binned" in dev:
        add("align_binned_vs_scatter",
            np.array_equal(dev["align_binned"], dev["align_scatter"]),
            mismatch=_frac_mismatch(dev["align_binned"],
                                    dev["align_scatter"]))

    # -- cross-backend golden ----------------------------------------------
    zmax32 = np.float32(np.finfo(np.float32).max)
    for mode in ("tiled", "exact"):
        f = _frac_mismatch(dev[f"fuse_{mode}_img"], cpu[f"fuse_{mode}_img"])
        zt, zc = dev[f"fuse_{mode}_zbuf"], cpu[f"fuse_{mode}_zbuf"]
        # Same coverage + same-winner depth to fma tolerance: the winner's
        # z is recomputed per backend with different contraction (measured
        # last-ulp differences on ~20% of pixels with IDENTICAL images, so
        # bitwise z equality across backends is not a meaningful gate).
        cov_mismatch = float(((zt == zmax32) != (zc == zmax32)).mean())
        z_bad = float(
            (~np.isclose(zt, zc, rtol=2e-6, atol=1e-6)).mean()
        )
        add(f"{mode}_vs_cpu",
            max(f, cov_mismatch, z_bad) <= CROSS_BACKEND_PIXEL_BUDGET,
            img_mismatch=f, coverage_mismatch=cov_mismatch,
            z_over_ulp_envelope=z_bad)

    # indexed: exact values of a winner within one quantization step.
    zmax = np.float32(np.finfo(np.float32).max)
    qstep = (4.0 - 0.25) / 4095.0  # (z_far-z_near)/2^12 at config defaults
    ct, cc = (dev["fuse_indexed_zbuf"] != zmax), (cpu["fuse_indexed_zbuf"] != zmax)
    both = ct & cc
    cov_mismatch = float((ct != cc).mean())
    dz = np.abs(dev["fuse_indexed_zbuf"][both] - cpu["fuse_indexed_zbuf"][both])
    z_bad = float((dz > 2 * qstep).mean()) if both.any() else 0.0
    col_mismatch = _frac_mismatch(dev["fuse_indexed_img"],
                                  cpu["fuse_indexed_img"])
    add("indexed_vs_cpu",
        cov_mismatch <= CROSS_BACKEND_PIXEL_BUDGET
        and z_bad <= CROSS_BACKEND_PIXEL_BUDGET and col_mismatch <= 1e-2,
        coverage_mismatch=cov_mismatch, z_over_envelope=z_bad,
        color_mismatch=col_mismatch)

    # packed: RGB666 + 14-bit-depth envelopes.
    qstep14 = (4.0 - 0.25) / 16383.0
    ct = dev["fuse_packed_zbuf"] != zmax
    cc = cpu["fuse_packed_zbuf"] != zmax
    both = ct & cc
    cov_mismatch = float((ct != cc).mean())
    dz = np.abs(dev["fuse_packed_zbuf"][both] - cpu["fuse_packed_zbuf"][both])
    z_bad = float((dz > 2 * qstep14).mean()) if both.any() else 0.0
    col_mismatch = _frac_mismatch(dev["fuse_packed_img"],
                                  cpu["fuse_packed_img"])
    add("packed_vs_cpu",
        cov_mismatch <= CROSS_BACKEND_PIXEL_BUDGET
        and z_bad <= CROSS_BACKEND_PIXEL_BUDGET and col_mismatch <= 1e-2,
        coverage_mismatch=cov_mismatch, z_over_envelope=z_bad,
        color_mismatch=col_mismatch)

    f = _frac_mismatch(dev["rig_img"], cpu["rig_img"])
    add("rig_vs_cpu", f <= CROSS_BACKEND_PIXEL_BUDGET, img_mismatch=f)

    f = _frac_mismatch(dev["align_scatter"], cpu["align_scatter"])
    add("align_vs_cpu", f <= CROSS_BACKEND_PIXEL_BUDGET, mismatch=f)

    # 5e-3 on 4×4 entries ≈ 0.3° / 5 mm: loose enough for f32 Gauss-Newton
    # iteration-path divergence between backends — on the GPU the voxel
    # build's scatter-adds are float atomics, so its sums (and the solve
    # that starts from them) depend on the order updates land in — and
    # tight enough to catch real breakage (a reduced-precision matmul in
    # the pose math measured 0.6 here).
    dt = float(np.abs(dev["gicp_transform"] - cpu["gicp_transform"]).max())
    add("gicp_vs_cpu", dt <= 5e-3, max_abs_diff=dt,
        fitness_device=float(dev["gicp_fitness"]),
        fitness_cpu=float(cpu["gicp_fitness"]))

    ok = all(c["pass"] for c in checks.values())
    return {"parity": "pass" if ok else "fail", "checks": checks}


# ---------------------------------------------------------------------------
# drivers


def _oracle_main(path: str, width: int, height: int) -> None:
    """Subprocess entry: force CPU, compute goldens, save npz."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    res = compute_results(width, height)
    # Atomic publish: goldens take a while to compute, and a killed
    # run must not leave a truncated npz at the fingerprint-keyed path
    # (it would poison every later gate run until hand-deleted).
    # np.savez appends ".npz" to any filename not already ending in it, so
    # the temp name must keep the suffix or os.replace misses the file.
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **res)
    os.replace(tmp, path)


def _source_fingerprint() -> str:
    """Short hash over the package + gate sources (path, size, mtime).

    Keys the default golden-npz cache so a code change always recomputes
    the CPU goldens; cheaper than hashing contents and still revision-
    sensitive (editors/git touch mtimes on any change)."""
    import hashlib

    root = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha1()
    # __graft_entry__ is part of the gate surface: _build_fusion defines
    # the input frames + config the goldens are computed FROM — leaving it
    # out would let an input change reuse stale goldens.
    targets = [os.path.join(root, "pointcloud_depthfusion_tpu"),
               os.path.abspath(__file__),
               os.path.join(root, "__graft_entry__.py")]
    for target in targets:
        if os.path.isfile(target):
            st = os.stat(target)
            h.update(f"{target}:{st.st_size}:{st.st_mtime_ns}".encode())
            continue
        for dirpath, _, files in sorted(os.walk(target)):
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                p = os.path.join(dirpath, name)
                st = os.stat(p)
                rel = os.path.relpath(p, root)
                h.update(f"{rel}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:12]


def run_parity(width: int = 848, height: int = 480,
               oracle_path: str | None = None) -> dict:
    """Full gate: spawn the CPU-golden subprocess, run on-chip, compare.

    ``oracle_path``: reuse an existing golden npz (skips the subprocess) or,
    when the file does not exist yet, where to save it for reuse.
    """
    from pointcloud_depthfusion_tpu.utils.compile_cache import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    reuse = oracle_path is not None and os.path.exists(oracle_path)
    # Default cache name keyed by a SOURCE FINGERPRINT (not a hand-bumped
    # tag): goldens from an older code revision can neither mask a
    # regression nor fail a good build. Explicit --oracle-cache paths skip
    # the fingerprint (the caller owns staleness).
    path = oracle_path or os.path.join(
        tempfile.gettempdir(),
        f"pdf_parity_goldens_{_source_fingerprint()}_{width}x{height}.npz",
    )
    def compute_goldens():
        print(f"parity: computing CPU goldens → {path}", file=sys.stderr,
              flush=True)
        # JAX_PLATFORMS=cpu: the child never opens the card, which the
        # parent process already holds.
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--oracle", path,
             "--width", str(width), "--height", str(height)],
            check=True, cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )

    if not reuse and not os.path.exists(path):
        compute_goldens()
    try:
        cpu = dict(np.load(path))
    except Exception as exc:  # corrupt/legacy cache file → recompute once
        print(f"parity: golden cache unreadable ({exc}); recomputing",
              file=sys.stderr, flush=True)
        os.remove(path)
        compute_goldens()
        cpu = dict(np.load(path))
    dev = compute_results(width, height)
    return compare(dev, cpu, width, height)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--oracle", help="(internal) write CPU goldens to this npz")
    p.add_argument("--width", type=int, default=848)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--oracle-cache", default=None,
                   help="reuse/create the golden npz at this path")
    args = p.parse_args()
    if args.oracle:
        # No persistent cache here: XLA:CPU AOT reload spams machine-feature
        # warnings, and the oracle is a one-shot subprocess anyway.
        _oracle_main(args.oracle, args.width, args.height)
        return
    result = run_parity(args.width, args.height, args.oracle_cache)
    print(json.dumps(result))
    if result["parity"] != "pass":
        sys.exit(1)


if __name__ == "__main__":
    main()
