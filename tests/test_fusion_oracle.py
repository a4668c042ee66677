"""Strict end-to-end parity: fuse() (exact mode) vs a scalar numpy oracle
of the full reference pipeline.

This is the BASELINE fidelity check: the fused image and z-buffer must
match the oracle bit-for-bit (uint8 colors) / to f32 exactness (depth) —
stronger than the 1e-3 target, because the winner-selection semantics are
reproduced exactly (min f32 depth, deterministic min-packed-RGB ties).
"""

import numpy as np
import jax.numpy as jnp

from pointcloud_depthfusion_tpu.core.camera import (
    Intrinsics,
    fused_virtual_intrinsics,
)
from pointcloud_depthfusion_tpu.core.frameset import Frameset
from pointcloud_depthfusion_tpu.core import geometry as G
from pointcloud_depthfusion_tpu.fusion.pipeline import (
    FusionConfig,
    fuse,
    fused_camera_transform,
)
from pointcloud_depthfusion_tpu.io.synthetic import (
    SyntheticScene,
    right_to_left_transform,
    two_camera_rig,
)

import oracles


def numpy_pipeline(depth_l, color_l, depth_r, color_r, intr, t_rl, fused_intr,
                   min_depth, max_depth, mirror, fused_transform):
    """Scalar reference of the full fusion hot path."""
    fx, fy = float(intr.fx), float(intr.fy)
    ppx, ppy = float(intr.ppx), float(intr.ppy)

    def prep(depth_u16, transform):
        d = oracles.minmax_filter_oracle(depth_u16, 0.001, min_depth, max_depth)
        h, w = d.shape
        pts = []
        cols = []
        valid = []
        for v in range(h):
            for u in range(w):
                z = d[v, u] * 0.001
                pts.append(((u - ppx) / fx * z, (v - ppy) / fy * z, z))
                valid.append(d[v, u] > 0)
        pts = np.asarray(pts, np.float32)
        # transform in f32 like the device path
        r = transform[:3, :3].astype(np.float32)
        t = transform[:3, 3].astype(np.float32)
        pts = (pts @ r.T + t).astype(np.float32)
        return pts, np.asarray(valid)

    t_total_r = (fused_transform @ t_rl).astype(np.float32)
    pts_l, val_l = prep(depth_l, fused_transform.astype(np.float32))
    pts_r, val_r = prep(depth_r, t_total_r)
    pts = np.concatenate([pts_l, pts_r])
    cols = np.concatenate([color_l.reshape(-1, 3), color_r.reshape(-1, 3)])
    val = np.concatenate([val_l, val_r])
    img, zbuf = oracles.project_zbuffer_oracle(
        pts, cols, val,
        float(fused_intr.fx), float(fused_intr.fy),
        float(fused_intr.ppx), float(fused_intr.ppy),
        fused_intr.width, fused_intr.height, mirror=mirror,
    )
    return img, zbuf


def test_fused_output_matches_scalar_oracle():
    W, H = 40, 30
    intr = Intrinsics.create(W, H, fx=33.0, fy=34.0, ppx=W / 2, ppy=H / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    fl = scene.render(intr, wl)
    fr = scene.render(intr, wr)
    t_rl = right_to_left_transform(wl, wr)

    config = FusionConfig.create(
        min_depth=0.5, max_depth=3.0,
        vertical_image=False, mirror_image=True,
        filter_fused_color=False, render_mode="exact",
    )
    fused_intr = fused_virtual_intrinsics(intr, False)
    res = fuse(
        Frameset.create(fl.depth, fl.color, intr),
        Frameset.create(fr.depth, fr.color, intr),
        jnp.asarray(t_rl, jnp.float32),
        config,
        fused_intr,
    )

    fused_t = np.asarray(
        fused_camera_transform(config, jnp.asarray(t_rl, jnp.float32))
    ).astype(np.float64)
    want_img, want_z = numpy_pipeline(
        fl.depth, fl.color, fr.depth, fr.color, intr,
        np.asarray(t_rl), fused_intr, 0.5, 3.0, True, fused_t,
    )

    got_img = np.asarray(res.image)
    got_z = np.asarray(res.zbuf)
    covered_want = want_z < 1e37
    covered_got = got_z < 1e37

    # Coverage must agree except at f32-vs-f64 rounding boundaries.
    assert (covered_want == covered_got).mean() > 0.995
    both = covered_want & covered_got
    # Depth: f32-exact where the same winner was selected; compare to the
    # f32 quantum.
    close = np.isclose(got_z[both], want_z[both], rtol=2e-6, atol=1e-6)
    assert close.mean() > 0.99, close.mean()
    # Colors: bit-exact where depths agree.
    agree = np.zeros_like(both)
    agree[both] = close
    np.testing.assert_array_equal(got_img[agree], want_img[agree])


def test_indexed_mode_within_fidelity_envelope():
    """The indexed (fast) render mode stays inside the BASELINE ≤1e-3
    envelope end-to-end: same coverage as exact, fused z within one
    quantization step (0.92 mm at the default 0.25–4.0 m window), colors
    exact except at sub-step near-ties."""
    import dataclasses

    W, H = 40, 30
    intr = Intrinsics.create(W, H, fx=33.0, fy=34.0, ppx=W / 2, ppy=H / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    fl = scene.render(intr, wl)
    fr = scene.render(intr, wr)
    t_rl = jnp.asarray(right_to_left_transform(wl, wr), jnp.float32)

    config = FusionConfig.create(
        min_depth=0.5, max_depth=3.0,
        vertical_image=False, mirror_image=True,
        filter_fused_color=False, render_mode="exact",
    )
    fused_intr = fused_virtual_intrinsics(intr, False)
    left = Frameset.create(fl.depth, fl.color, intr)
    right = Frameset.create(fr.depth, fr.color, intr)
    res_e = fuse(left, right, t_rl, config, fused_intr)
    res_i = fuse(left, right, t_rl,
                 dataclasses.replace(config, render_mode="indexed"),
                 fused_intr)

    # Window used by the pipeline: [0.5*min_depth, max_depth+1]. At this
    # tiny point count the index field is small, so the step is far below
    # the 1e-3 bound that holds at the full 2^20-point hot path.
    step = 1e-3
    ze, zi = np.asarray(res_e.zbuf), np.asarray(res_i.zbuf)
    cov = ze < 1e37
    np.testing.assert_array_equal(cov, zi < 1e37)
    assert np.max(np.abs(ze[cov] - zi[cov])) <= step
    differs = (np.asarray(res_e.image) != np.asarray(res_i.image)).any(-1)
    assert np.all(np.abs(ze[differs] - zi[differs]) <= step)


def test_tiled_mode_bitwise_equals_exact_end_to_end():
    """The tiled mode is bit-identical to the exact
    mode through the whole fuse() pipeline — winners, tie-breaks, colors,
    and f32 z-buffer."""
    import dataclasses

    W, H = 40, 30
    intr = Intrinsics.create(W, H, fx=33.0, fy=34.0, ppx=W / 2, ppy=H / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.4, toe_in_deg=6.0)
    fl = scene.render(intr, wl)
    fr = scene.render(intr, wr)
    t_rl = jnp.asarray(right_to_left_transform(wl, wr), jnp.float32)

    left = Frameset.create(fl.depth, fl.color, intr)
    right = Frameset.create(fr.depth, fr.color, intr)
    for vertical, mirror, color_filter in (
        (False, True, False), (True, True, True), (False, False, True)
    ):
        config = FusionConfig.create(
            min_depth=0.5, max_depth=3.0,
            vertical_image=vertical, mirror_image=mirror,
            filter_fused_color=color_filter, render_mode="exact",
        )
        fused_intr = fused_virtual_intrinsics(intr, vertical)
        res_e = fuse(left, right, t_rl, config, fused_intr)
        res_t = fuse(left, right, t_rl,
                     dataclasses.replace(config, render_mode="tiled"),
                     fused_intr)
        np.testing.assert_array_equal(
            np.asarray(res_e.image), np.asarray(res_t.image))
        np.testing.assert_array_equal(
            np.asarray(res_e.zbuf), np.asarray(res_t.zbuf))
