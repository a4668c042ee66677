"""End-to-end fusion pipeline tests on the synthetic two-camera rig."""

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
    FusionPipeline,
    fuse,
    fused_camera_transform,
    virtual_camera_transform,
)
from pointcloud_depthfusion_tpu.io.synthetic import (
    SyntheticScene,
    right_to_left_transform,
    two_camera_rig,
)


W, H = 106, 60  # small frames keep CPU tests fast (ratio ~848x480)


def small_intr():
    return Intrinsics.create(W, H, fx=80.0, fy=80.0, ppx=W / 2, ppy=H / 2)


def make_pair(scene=None, **render_kw):
    scene = scene or SyntheticScene()
    intr = small_intr()
    wl, wr = two_camera_rig(baseline=0.5, toe_in_deg=8.0)
    fs_l = scene.render(intr, wl, **render_kw)
    fs_r = scene.render(intr, wr, **render_kw)
    t_rl = right_to_left_transform(wl, wr)
    left = Frameset.create(fs_l.depth, fs_l.color, intr, depth_scale=fs_l.depth_scale)
    right = Frameset.create(fs_r.depth, fs_r.color, intr, depth_scale=fs_r.depth_scale)
    return left, right, t_rl, intr, (wl, wr), scene


def test_fuse_runs_and_covers():
    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 set_camera_pose=False, filter_fused_color=False)
    pipe = FusionPipeline(intr, config, donate=False)
    pipe.set_right_transform(t_rl)
    res = pipe.process(left, right)
    img = np.asarray(res.image)
    assert img.shape == (H, W, 3)
    coverage = (img.sum(-1) > 0).mean()
    assert coverage > 0.5, coverage


def test_fuse_geometry_against_direct_render():
    """Fused z-buffer from the midpoint camera ≈ direct scene render."""
    left, right, t_rl, intr, (wl, wr), scene = make_pair()
    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 filter_fused_color=False)
    pipe = FusionPipeline(intr, config, donate=False)
    pipe.set_right_transform(t_rl)
    res = pipe.process(left, right)

    # Virtual camera = slerp midpoint of identity and t_rl, in the left
    # camera frame → world pose = wl @ inv(mid).
    mid = np.asarray(fused_camera_transform(pipe.config, jnp.asarray(t_rl, jnp.float32)))
    virt_world = wl @ np.linalg.inv(mid)
    direct = scene.render(intr, virt_world)

    zb = np.asarray(res.zbuf)
    covered = zb < 1e37
    want_depth = direct.depth.astype(np.float64) * direct.depth_scale
    both = covered & (want_depth > 0)
    assert both.mean() > 0.4
    err = np.abs(zb[both] - want_depth[both])
    # Most pixels should agree with the direct render to ~1 cm; occlusion
    # boundaries and splat rounding produce a small tail.
    assert np.quantile(err, 0.8) < 0.012, np.quantile(err, [0.5, 0.8, 0.95])


def test_fuse_color_consistency():
    """Fused color at agreeing pixels matches the direct render closely."""
    left, right, t_rl, intr, (wl, wr), scene = make_pair()
    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 filter_fused_color=False)
    pipe = FusionPipeline(intr, config, donate=False)
    pipe.set_right_transform(t_rl)
    res = pipe.process(left, right)

    mid = np.asarray(fused_camera_transform(pipe.config, jnp.asarray(t_rl, jnp.float32)))
    virt_world = wl @ np.linalg.inv(mid)
    direct = scene.render(intr, virt_world)

    zb = np.asarray(res.zbuf)
    want_depth = direct.depth.astype(np.float64) * direct.depth_scale
    img = np.asarray(res.image).astype(int)
    want = direct.color.astype(int)
    both = (zb < 1e37) & (want_depth > 0) & (np.abs(zb - want_depth) < 0.005)
    # Where geometry agrees, color should agree except at checker edges.
    chan_err = np.abs(img - want).max(-1)[both]
    assert np.quantile(chan_err, 0.75) <= 30, np.quantile(chan_err, [0.5, 0.75, 0.9])


def test_vertical_and_mirror_shapes():
    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(vertical_image=True, mirror_image=True)
    pipe = FusionPipeline(intr, config, donate=False)
    pipe.set_right_transform(t_rl)
    res = pipe.process(left, right)
    assert np.asarray(res.image).shape == (W, H, 3)  # transposed
    assert pipe.fused_intrinsics.width == H and pipe.fused_intrinsics.height == W


def test_mirror_flips_image():
    left, right, t_rl, intr, _, _ = make_pair()
    base = FusionConfig.create(vertical_image=False, mirror_image=False,
                               filter_fused_color=False)
    mirrored = FusionConfig.create(vertical_image=False, mirror_image=True,
                                   filter_fused_color=False)
    p1 = FusionPipeline(intr, base, donate=False)
    p2 = FusionPipeline(intr, mirrored, donate=False)
    p1.set_right_transform(t_rl)
    p2.set_right_transform(t_rl)
    a = np.asarray(p1.process(left, right).image)
    b = np.asarray(p2.process(left, right).image)
    np.testing.assert_array_equal(a, b[:, ::-1])


def test_set_camera_pose_transform():
    config = FusionConfig.create(
        set_camera_pose=True,
        camera_translation=(0.25, 0.0, 0.0),
        camera_rotation_deg=(0.0, 0.0, 0.0),
        vertical_image=False,
    )
    t = np.asarray(virtual_camera_transform(config))
    # M = R^-1 T(-t) Rz90; with R=I it is T(-t) @ Rz90.
    want_rz = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    np.testing.assert_allclose(t[:3, :3], want_rz, atol=1e-6)
    np.testing.assert_allclose(t[:3, 3], [-0.25, 0, 0], atol=1e-6)


def test_depth_window_filters_points():
    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(min_depth=0.5, max_depth=1.0,
                                 vertical_image=False, mirror_image=False,
                                 filter_fused_color=False)
    pipe = FusionPipeline(intr, config, donate=False)
    pipe.set_right_transform(t_rl)
    res = pipe.process(left, right)
    zb = np.asarray(res.zbuf)
    # plane at ~2.2-2.5 m excluded; only near sphere parts remain
    assert (zb < 1e37).mean() < 0.4


def test_donate_mode_streams():
    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 filter_fused_color=False)
    pipe = FusionPipeline(intr, config, donate=True)
    pipe.set_right_transform(t_rl)
    # fresh framesets per call, like the feeder produces
    import numpy as np
    d = np.asarray(left.depth); c = np.asarray(left.color)
    dr = np.asarray(right.depth); cr = np.asarray(right.color)
    imgs = []
    for _ in range(3):
        l = Frameset.create(d, c, intr)
        r = Frameset.create(dr, cr, intr)
        imgs.append(np.asarray(pipe.process(l, r).image))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[1], imgs[2])


def test_process_profiled_matches_fused_and_times_stages(tmp_path):
    """Split-program profiling mode: per-stage laps are real (nonzero) and
    the output matches the fused program (same winners except float-rounding
    near-ties from the reference-structured two-step transform)."""
    import numpy as np

    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionPipeline
    from pointcloud_depthfusion_tpu.utils.profiling import FUSION_STAGE_FIELDS

    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(
        vertical_image=False, mirror_image=True, render_mode="indexed",
    )
    pipe = FusionPipeline(intr, config)
    pipe.set_right_transform(t_rl)
    res_fused = pipe.process(left, right)
    res_prof, laps, host_img = pipe.process_profiled(left, right)

    for field in ("filter", "deproject", "transform_right", "fuse",
                  "transform", "project", "filter_image"):
        assert field in FUSION_STAGE_FIELDS
        assert laps[field] > 0.0, (field, laps)
    a = np.asarray(res_fused.image).astype(int)
    b = np.asarray(res_prof.image).astype(int)
    same = (a == b).all(-1).mean()
    assert same > 0.99, same
    np.testing.assert_array_equal(host_img, np.asarray(res_prof.image))


def test_fusion_node_stage_log_has_real_numbers(tmp_path):
    """StageLog rows carry nonzero
    filter/deproject/project/copy fields."""
    import numpy as np

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.io.feeder import SyntheticSource
    from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene, two_camera_rig
    from pointcloud_depthfusion_tpu.nodes.camera_node import CameraNode
    from pointcloud_depthfusion_tpu.nodes.fusion_node import FusionNodeApp

    W, H = 64, 48
    intr = Intrinsics.create(W, H, fx=50.0, fy=50.0, ppx=W / 2, ppy=H / 2)
    scene = SyntheticScene()
    wl, wr = two_camera_rig()
    cam_l = CameraNode("l", SyntheticSource(scene, intr, wl, seed=1))
    cam_r = CameraNode("r", SyntheticSource(scene, intr, wr, seed=2))
    path = str(tmp_path / "fusion_profiling.txt")
    app = FusionNodeApp(
        cam_l, cam_r,
        config=FusionConfig.create(vertical_image=False, mirror_image=False),
        profiling_path=path,
    )
    app.run(max_frames=3)
    lines = open(path).read().strip().split("\n")
    header = lines[0].split(",")
    rows = [dict(zip(header, map(float, ln.split(",")))) for ln in lines[1:]]
    assert len(rows) == 3
    for row in rows:
        for field in ("loop", "filter", "deproject", "project",
                      "copy_from_gpu", "filter_image"):
            assert row[field] > 0.0, (field, row)
        assert row["loop"] >= row["project"]


def test_process_profiled_with_align_frames():
    """The profiling mode's filter stage includes depth→color alignment
    when align_frames is on (same output family as fuse with align)."""
    import numpy as np

    from pointcloud_depthfusion_tpu.fusion.pipeline import FusionPipeline

    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(
        vertical_image=False, mirror_image=False, align_frames=True,
        filter_fused_color=False, render_mode="indexed",
    )
    pipe = FusionPipeline(intr, config)
    pipe.set_right_transform(t_rl)
    res_fused = pipe.process(left, right)
    res_prof, laps, _ = pipe.process_profiled(left, right)
    a = np.asarray(res_fused.image).astype(int)
    b = np.asarray(res_prof.image).astype(int)
    assert (a == b).all(-1).mean() > 0.99
    assert laps["filter"] > 0.0


def test_packed_color_plane_matches_hwc_tiled():
    """Frameset.color_packed (host- or device-packed) must leave the tiled
    fused image and z-buffer BIT-identical — it is exactly the rgb24 the
    render would pack from the HWC planes."""
    import dataclasses
    import jax

    from pointcloud_depthfusion_tpu.core.camera import fused_virtual_intrinsics
    from pointcloud_depthfusion_tpu.core.frameset import pack_rgb24_host
    from pointcloud_depthfusion_tpu.fusion.pipeline import fuse

    left, right, t_rl, intr, _, _ = make_pair()
    config = FusionConfig.create(vertical_image=False, mirror_image=False,
                                 filter_fused_color=False, render_mode="tiled")
    fi = fused_virtual_intrinsics(intr, config.vertical_image)
    t = jnp.asarray(t_rl, jnp.float32)

    @jax.jit
    def run(l, r, t, cfg):
        return fuse(l, r, t, cfg, fi)

    base = run(left, right, t, config)

    # Device-side pack.
    res_dev = run(left.with_packed_color(), right.with_packed_color(), t, config)
    np.testing.assert_array_equal(np.asarray(base.image), np.asarray(res_dev.image))
    np.testing.assert_array_equal(np.asarray(base.zbuf), np.asarray(res_dev.zbuf))

    # Host-side pack (the feeder path) + image-only resolve.
    lp = dataclasses.replace(
        left, color_packed=jnp.asarray(pack_rgb24_host(np.asarray(left.color))))
    rp = dataclasses.replace(
        right, color_packed=jnp.asarray(pack_rgb24_host(np.asarray(right.color))))
    cfg_img = dataclasses.replace(config, emit_zbuf=False)
    a = run(left, right, t, cfg_img)
    b = run(lp, rp, t, cfg_img)
    assert b.zbuf is None
    np.testing.assert_array_equal(np.asarray(a.image), np.asarray(b.image))

    # indexed, exact and packed (RGB666) modes consume the packed plane
    # too — bit-identical (the RGB666 key bits derive from the same rgb24).
    for mode in ("indexed", "exact", "packed"):
        cfg_m = dataclasses.replace(config, render_mode=mode)
        am = run(left, right, t, cfg_m)
        bm = run(lp, rp, t, cfg_m)
        np.testing.assert_array_equal(np.asarray(am.image), np.asarray(bm.image))
        np.testing.assert_array_equal(np.asarray(am.zbuf), np.asarray(bm.zbuf))


def test_pack_color_wraps_wide_input_like_stored_color():
    """Frameset.create(pack_color=True) with non-u8 color must produce a
    packed plane consistent with the STORED (u8-wrapped) color — packing
    before the wrap produced bits above 0xFFFFFF that corrupt the RGB666
    derivation and the min-RGB tie-break."""
    from pointcloud_depthfusion_tpu.core.frameset import (
        Frameset,
        pack_rgb24_host,
    )

    h, w = 6, 8
    wide = (np.arange(h * w * 3, dtype=np.int32).reshape(h, w, 3) * 7 + 250)
    depth = np.full((h, w), 1000, np.uint16)
    fs = Frameset.create(depth, wide, small_intr(), pack_color=True)
    np.testing.assert_array_equal(
        np.asarray(fs.color_packed),
        pack_rgb24_host(np.asarray(fs.color)),
    )
    assert int(np.asarray(fs.color_packed).max()) <= 0xFFFFFF


def test_feeder_pack_color_flag():
    """DeviceFeeder(pack_color=True) uploads framesets carrying the packed
    plane, equal to the host pack of the color image."""
    from pointcloud_depthfusion_tpu.core.frameset import pack_rgb24_host
    from pointcloud_depthfusion_tpu.io.feeder import DeviceFeeder, SyntheticSource

    scene = SyntheticScene()
    wl, wr = two_camera_rig(baseline=0.5, toe_in_deg=8.0)
    src_l = SyntheticSource(scene, small_intr(), wl, fps=1000.0, seed=1)
    src_r = SyntheticSource(scene, small_intr(), wr, fps=1000.0, seed=2)
    with DeviceFeeder(src_l, src_r, pack_color=True) as feeder:
        pair = next(iter(feeder))
        assert pair.left.color_packed is not None
        np.testing.assert_array_equal(
            np.asarray(pair.left.color_packed),
            pack_rgb24_host(np.asarray(pair.left.color)),
        )


def test_fuse_rejects_unknown_render_mode():
    """A manifest naming a removed mode (the hand-tiled "pallas" prep)
    fails loudly instead of rendering with another mode."""
    import dataclasses

    import pytest

    left, right, t_rl, intr, _, _ = make_pair()
    config = dataclasses.replace(
        FusionConfig.create(vertical_image=False, mirror_image=False),
        render_mode="pallas",
    )
    with pytest.raises(ValueError, match="unknown render_mode 'pallas'"):
        fuse(left, right, jnp.asarray(t_rl, jnp.float32), config, intr)


def test_fuse_emit_zbuf_false_bit_identical_image():
    """fuse(emit_zbuf=False) produces the identical image and zbuf=None."""
    import dataclasses

    left, right, t_rl, intr, _, _ = make_pair()
    t_rl = jnp.asarray(t_rl, jnp.float32)
    cfg = FusionConfig.create(render_mode="tiled")
    fi = fused_virtual_intrinsics(intr, cfg.vertical_image)
    full = fuse(left, right, t_rl, cfg, fi)
    fast = fuse(left, right, t_rl,
                dataclasses.replace(cfg, emit_zbuf=False), fi)
    np.testing.assert_array_equal(np.asarray(fast.image),
                                  np.asarray(full.image))
    assert fast.zbuf is None and full.zbuf is not None
