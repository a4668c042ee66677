"""Z-buffer projection tests against the sequential oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from pointcloud_depthfusion_tpu.core.camera import Intrinsics
from pointcloud_depthfusion_tpu.ops import render as R

import oracles


def make_intr(w=40, h=30):
    return Intrinsics.create(w, h, fx=35.0, fy=36.0, ppx=w / 2, ppy=h / 2)


def random_cloud(rng, n, intr, spread=1.0):
    # points that mostly land inside the image
    z = rng.uniform(0.5, 3.0, n)
    px = rng.uniform(-5, intr.width + 5, n)
    py = rng.uniform(-5, intr.height + 5, n)
    x = (px - float(intr.ppx)) / float(intr.fx) * z
    y = (py - float(intr.ppy)) / float(intr.fy) * z
    pts = np.stack([x, y, z], -1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    valid = rng.random(n) > 0.1
    return pts, cols, valid


def test_project_matches_oracle(rng):
    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 5000, intr)
    img, zbuf = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    want_img, want_z = oracles.project_zbuffer_oracle(
        pts, cols, valid,
        float(intr.fx), float(intr.fy), float(intr.ppx), float(intr.ppy),
        intr.width, intr.height,
    )
    np.testing.assert_array_equal(np.asarray(img), want_img)
    covered = want_z < 1e37
    np.testing.assert_allclose(
        np.asarray(zbuf)[covered], want_z[covered], rtol=1e-6
    )


def test_project_mirror(rng):
    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 3000, intr)
    img_m, _ = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr, mirror=True
    )
    want_img, _ = oracles.project_zbuffer_oracle(
        pts, cols, valid,
        float(intr.fx), float(intr.fy), float(intr.ppx), float(intr.ppy),
        intr.width, intr.height, mirror=True,
    )
    np.testing.assert_array_equal(np.asarray(img_m), want_img)


def test_depth_tie_break_deterministic():
    intr = make_intr()
    # two points, identical pixel and depth, different colors: packed-min wins
    pts = np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32)
    cols = np.array([[200, 0, 0], [100, 0, 0]], np.uint8)
    valid = np.array([True, True])
    img, _ = R.project_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr)
    px, py = int(intr.ppx), int(intr.ppy)
    np.testing.assert_array_equal(np.asarray(img)[py, px], [100, 0, 0])


def test_occlusion():
    intr = make_intr()
    pts = np.array([[0, 0, 2.0], [0, 0, 1.0]], np.float32)  # nearer second
    cols = np.array([[1, 2, 3], [9, 8, 7]], np.uint8)
    img, zbuf = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(np.array([True, True])), intr
    )
    px, py = int(intr.ppx), int(intr.ppy)
    np.testing.assert_array_equal(np.asarray(img)[py, px], [9, 8, 7])
    assert abs(float(zbuf[py, px]) - 1.0) < 1e-6


def test_empty_pixels_black_and_fltmax(rng):
    intr = make_intr()
    img, zbuf = R.project_zbuffer(
        jnp.zeros((10, 3)), jnp.zeros((10, 3), jnp.uint8),
        jnp.zeros(10, bool), intr,
    )
    assert np.asarray(img).sum() == 0
    assert np.all(np.asarray(zbuf) > 1e37)


def test_planar_exact_matches_aos(rng):
    """Sort-based planar exact render == scatter-based AoS render, bit for
    bit (same winners, same tie-break)."""
    from pointcloud_depthfusion_tpu.ops.render import project_zbuffer_planar

    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 5000, intr)
    img_a, zb_a = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    img_p, zb_p = project_zbuffer_planar(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]),
        jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]), jnp.asarray(cols[:, 2]),
        jnp.asarray(valid), intr,
    )
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_p))
    np.testing.assert_array_equal(np.asarray(zb_a), np.asarray(zb_p))


def test_indexed_fidelity_vs_exact(rng):
    """Indexed mode: zbuf within one quantization step of exact; color
    differences only at near-tie pixels (exact winner within one step)."""
    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 5000, intr)
    z_near, z_far = 0.4, 3.5
    img_e, zb_e = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    img_i, zb_i = R.project_zbuffer_indexed(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr,
        z_near=z_near, z_far=z_far,
    )
    idx_bits = R._index_bits_for(5000)
    step = (z_far - z_near) / (2 ** (32 - idx_bits) - 1)
    e, i = np.asarray(zb_e), np.asarray(zb_i)
    cov_e, cov_i = e < 1e37, i < 1e37
    np.testing.assert_array_equal(cov_e, cov_i)  # identical coverage
    assert np.all(np.abs(e[cov_e] - i[cov_e]) <= step + 1e-7)
    # color: exact winner unless a competing point sits within one z step
    differs = (np.asarray(img_e) != np.asarray(img_i)).any(-1)
    assert np.all(np.abs(e[differs] - i[differs]) <= step + 1e-7)


def test_indexed_realistic_scale_12bit_z(rng):
    assert R._index_bits_for((1 << 19) + 7) == 20  # pins the 12-bit-z premise
    """At hot-path point counts (>2^19) the key leaves 12 z bits; the
    fidelity bound (one step ≈ (far-near)/4095) must still hold."""
    intr = make_intr(64, 48)
    n = (1 << 19) + 7  # forces idx_bits=20 like the dual-848×480 path
    pts, cols, valid = random_cloud(rng, n, intr)
    z_near, z_far = 0.25, 4.0
    step = (z_far - z_near) / ((1 << 12) - 1)
    assert step <= 1e-3  # the BASELINE fidelity envelope at default window
    img_e, zb_e = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    img_i, zb_i = R.project_zbuffer_indexed(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr,
        z_near=z_near, z_far=z_far,
    )
    e, i = np.asarray(zb_e), np.asarray(zb_i)
    cov = e < 1e37
    np.testing.assert_array_equal(cov, i < 1e37)
    assert np.max(np.abs(e[cov] - i[cov])) <= step + 1e-7
    differs = (np.asarray(img_e) != np.asarray(img_i)).any(-1)
    assert np.all(np.abs(e[differs] - i[differs]) <= step + 1e-7)


def test_indexed_tie_break_lowest_index():
    intr = make_intr()
    pts = np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32)
    cols = np.array([[200, 5, 0], [100, 0, 7]], np.uint8)
    valid = np.array([True, True])
    img, zbuf = R.project_zbuffer_indexed(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    px, py = int(intr.ppx), int(intr.ppy)
    np.testing.assert_array_equal(np.asarray(img)[py, px], [200, 5, 0])
    assert abs(float(zbuf[py, px]) - 1.0) < 1e-7  # exact winner depth


def test_indexed_empty(rng):
    intr = make_intr()
    img, zbuf = R.project_zbuffer_indexed(
        jnp.zeros((10, 3)), jnp.zeros((10, 3), jnp.uint8), jnp.zeros(10, bool),
        intr,
    )
    assert np.asarray(img).sum() == 0
    assert np.all(np.asarray(zbuf) > 1e37)


def test_packed_variant_close_to_exact(rng):
    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 4000, intr)
    img, _ = R.project_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr)
    img_p, _ = R.project_zbuffer_packed(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr,
        z_near=0.4, z_far=3.5,
    )
    a = np.asarray(img).astype(int)
    b = np.asarray(img_p).astype(int)
    covered = (a.sum(-1) > 0) & (b.sum(-1) > 0)
    # RGB666 quantization: per-channel error <= 3 (expand (c6<<2)|(c6>>4));
    # the 0.99 quantile tolerates the few pixels where 14-bit z-bin ties
    # pick a different winner than the exact render.
    diff = np.abs(a - b)[covered]
    assert np.quantile(diff, 0.99) <= 3


def test_tiled_matches_exact_bitwise(rng):
    """Planar render == (N, 3) render, bit for bit (same winners, same
    min-RGB tie-break, exact f32 z)."""
    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 5000, intr)
    for mirror in (False, True):
        img_m, zb_m = R.project_zbuffer(
            jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr,
            mirror=mirror,
        )
        img_t, zb_t = R.project_zbuffer_planar(
            jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]),
            jnp.asarray(pts[:, 2]),
            jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]),
            jnp.asarray(cols[:, 2]),
            jnp.asarray(valid), intr, mirror=mirror,
        )
        np.testing.assert_array_equal(np.asarray(img_m), np.asarray(img_t))
        np.testing.assert_array_equal(np.asarray(zb_m), np.asarray(zb_t))


def test_tiled_duplicate_depths_and_empty(rng):
    """Tie-break determinism + empty image through the planar path, with an
    odd pixel count."""
    intr = make_intr(w=37, h=23)
    pts, cols, valid = random_cloud(rng, 3000, intr)
    pts[1000:2000] = pts[:1000]  # duplicate positions, different colors
    img_a, zb_a = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    img_t, zb_t = R.project_zbuffer_planar(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]),
        jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]), jnp.asarray(cols[:, 2]),
        jnp.asarray(valid), intr,
    )
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_t))
    np.testing.assert_array_equal(np.asarray(zb_a), np.asarray(zb_t))

    none_valid = jnp.zeros((3000,), bool)
    img_e, zb_e = R.project_zbuffer_planar(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]),
        jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]), jnp.asarray(cols[:, 2]),
        none_valid, intr,
    )
    assert np.all(np.asarray(img_e) == 0)
    assert np.all(np.asarray(zb_e) == np.finfo(np.float32).max)


def test_tiled_extreme_skew_all_points_one_pixel(rng):
    """Pathological skew: every point projects to the same pixel."""
    intr = make_intr(w=16, h=16)
    n = 4000
    z = rng.uniform(0.5, 3.0, n).astype(np.float32)
    # all points on the ray through pixel (8, 8)
    x = (8.0 - float(intr.ppx)) / float(intr.fx) * z
    y = (8.0 - float(intr.ppy)) / float(intr.fy) * z
    pts = np.stack([x, y, z], -1).astype(np.float32)
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    valid = np.ones(n, bool)
    img_a, zb_a = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    img_t, zb_t = R.project_zbuffer_planar(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]),
        jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]), jnp.asarray(cols[:, 2]),
        jnp.asarray(valid), intr,
    )
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_t))
    np.testing.assert_array_equal(np.asarray(zb_a), np.asarray(zb_t))
    assert (np.asarray(zb_t) < 1e37).sum() == 1  # exactly one covered pixel


def test_tiled_tiny_image_single_tile(rng):
    """Tiny image (48 pixels)."""
    intr = make_intr(w=8, h=6)
    pts, cols, valid = random_cloud(rng, 500, intr)
    img_a, zb_a = R.project_zbuffer(
        jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), intr
    )
    img_t, zb_t = R.project_zbuffer_planar(
        jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]), jnp.asarray(pts[:, 2]),
        jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]), jnp.asarray(cols[:, 2]),
        jnp.asarray(valid), intr,
    )
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_t))
    np.testing.assert_array_equal(np.asarray(zb_a), np.asarray(zb_t))


def test_indexed_tiny_cloud_far_clip_no_wrap():
    """Tiny clouds leave >=25 depth bits; f32(2^zq_bits - 1) rounds UP to
    2^zq_bits, and without an integer re-clamp a beyond-z_far point's key
    wrapped past the shift and STOLE the pixel from the true near winner."""
    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.ops.render import (
        indexed_winner_planar,
    )

    intr = Intrinsics.create(8, 8, fx=4.0, fy=4.0, ppx=4.0, ppy=4.0)
    # Both points project to the center pixel; the second is far beyond
    # z_far and must lose.
    x = jnp.asarray([[0.0, 0.0]], jnp.float32)
    y = jnp.asarray([[0.0, 0.0]], jnp.float32)
    z = jnp.asarray([[1.0, 40.0]], jnp.float32)
    valid = jnp.ones((1, 2), bool)
    covered, widx = indexed_winner_planar(
        x, y, z, valid, intr, z_near=0.25, z_far=4.5
    )
    px = 4 * 8 + 4
    assert bool(covered[px])
    assert int(widx[px]) == 0  # the near point, not the wrapped far one


def test_packed_white_point_at_far_plane_not_dropped():
    """A valid near-white point at/beyond the far quantization plane must
    still cover its pixel: zq is clipped one step below the max so the
    packed key can never equal the 0xFFFFFFFF uncovered sentinel."""
    import jax.numpy as jnp

    from pointcloud_depthfusion_tpu.core.camera import Intrinsics
    from pointcloud_depthfusion_tpu.ops.render import project_zbuffer_packed

    intr = Intrinsics.create(8, 8, fx=8.0, fy=8.0, ppx=4.0, ppy=4.0)
    pts = np.array([[0.0, 0.0, 6.0]], np.float32)  # z > z_far=4.5
    cols = np.array([[255, 255, 255]], np.uint8)   # rgb666 = 0x3FFFF
    img, zbuf = project_zbuffer_packed(
        jnp.asarray(pts), jnp.asarray(cols), jnp.ones((1,), bool), intr,
        z_near=0.25, z_far=4.5,
    )
    img = np.asarray(img)
    assert img[4, 4].tolist() == [255, 255, 255], img[4, 4]
    assert np.asarray(zbuf)[4, 4] < 1e30  # covered, not FLT_MAX


def _winner_case(case, rng):
    """(pix, zbits, rgb, n_px) entry sets for the winner-selection cases."""
    n_px = 97
    n = 1031  # not a multiple of any block or chunk size
    pix = rng.integers(0, n_px, n)
    zbits = rng.integers(0x3E800000, 0x40A00000, n)  # f32 bits of 0.25..5 m
    rgb = rng.integers(0, 1 << 24, n)
    if case == "ties":
        zbits = np.full(n, 0x3F800000)  # every entry at 1.0 m
    elif case == "empty":
        pix = np.full(n, R._DROP)
    elif case == "one_pixel":
        pix = np.full(n, 5)
    elif case == "tiny_image":
        n_px = 3
        pix = rng.integers(0, n_px, n)
    elif case == "invalid_ids":
        bad = rng.random(n) < 0.3
        pix = np.where(bad, rng.integers(n_px, 1 << 31, n), pix)
    elif case == "rig_offsets":
        # 3 cameras x 4x5 images through winner_entries with per-camera
        # pixel offsets into one flat output of 3 slices.
        h, w, cams = 4, 5, 3
        idx = rng.integers(0, h * w + 1, (cams, h, w))  # h*w = dump slot
        ok = (idx < h * w) & (rng.random((cams, h, w)) < 0.9)
        zc = rng.uniform(0.3, 4.0, (cams, h, w)).astype(np.float32)
        zc[:, 0, :2] = 1.5  # cross-camera depth ties
        rgb24 = rng.integers(0, 1 << 24, (cams, h, w))
        offsets = (np.arange(cams) * h * w)[:, None, None]
        pix, zbits, rgb = R.winner_entries(
            jnp.asarray(idx, jnp.int32), jnp.asarray(zc), jnp.asarray(ok),
            jnp.asarray(rgb24, jnp.int32), jnp.asarray(offsets, jnp.int32),
        )
        return np.asarray(pix), np.asarray(zbits), np.asarray(rgb), cams * h * w
    return (pix.astype(np.int32), zbits.astype(np.int32), rgb.astype(np.int32),
            n_px)


@pytest.mark.parametrize("case", ["random", "ties", "empty", "one_pixel",
                                  "tiny_image", "invalid_ids", "rig_offsets"])
def test_resolve_winners_matches_oracle(case, rng):
    """Winner selection against the sequential oracle: min depth, depth
    ties to the least packed RGB, dropped entries land nowhere."""
    pix, zbits, rgb, n_px = _winner_case(case, rng)
    minz, mrgb = R.resolve_winners(jnp.asarray(pix), jnp.asarray(zbits),
                                   jnp.asarray(rgb), n_px)
    want_z, want_rgb = oracles.winner_oracle(pix, zbits, rgb, n_px)
    np.testing.assert_array_equal(np.asarray(minz), want_z)
    np.testing.assert_array_equal(np.asarray(mrgb), want_rgb)
    if case == "empty":
        assert np.all(np.asarray(mrgb) == R.NO_WINNER)


def test_winner_entries_masks_invalid_points():
    """Invalid points become dropped entries with no-winner keys; valid
    ones carry the f32 depth bits and the packed colour."""
    idx = jnp.asarray([[3, 7]], jnp.int32)
    zc = jnp.asarray([[1.0, 2.0]], jnp.float32)
    ok = jnp.asarray([[True, False]])
    rgb24 = jnp.asarray([[0x123456, 0x654321]], jnp.int32)
    pix, zbits, rgb = (np.asarray(a) for a in R.winner_entries(idx, zc, ok,
                                                               rgb24, 10))
    assert pix.tolist() == [13, R._DROP]
    assert zbits.tolist() == [0x3F800000, R.NO_WINNER]
    assert rgb.tolist() == [0x123456, R.NO_WINNER]


@pytest.mark.parametrize("variant", ["image_only", "planes", "rgb24"])
def test_planar_render_wrapper_variants(variant, rng):
    """need_zbuf=False, return_planes and a pre-packed rgb24 plane change
    only the form of the output, never a pixel."""
    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 3000, intr)
    planes = [jnp.asarray(pts[:, i]) for i in range(3)]
    chans = [jnp.asarray(cols[:, i]) for i in range(3)]
    img, zbuf = R.project_zbuffer_planar(*planes, *chans, jnp.asarray(valid),
                                         intr)
    if variant == "image_only":
        img2, zb2 = R.project_zbuffer_planar(
            *planes, *chans, jnp.asarray(valid), intr, need_zbuf=False)
        assert zb2 is None
    elif variant == "planes":
        (rp, gp, bp), zb2 = R.project_zbuffer_planar(
            *planes, *chans, jnp.asarray(valid), intr, return_planes=True)
        assert rp.shape == (intr.height, intr.width)
        img2 = jnp.stack([rp, gp, bp], -1)
        np.testing.assert_array_equal(np.asarray(zb2), np.asarray(zbuf))
    else:
        rgb24 = R.pack_rgb(jnp.asarray(cols))
        img2, zb2 = R.project_zbuffer_planar(
            *planes, None, None, None, jnp.asarray(valid), intr, rgb24=rgb24)
        np.testing.assert_array_equal(np.asarray(zb2), np.asarray(zbuf))
    assert img2.shape == (intr.height, intr.width, 3)
    np.testing.assert_array_equal(np.asarray(img2), np.asarray(img))


@pytest.mark.gpu
def test_render_on_gpu_matches_oracle(gpu_device, rng):
    """The render as compiled for the card against the sequential oracle."""
    import jax

    intr = make_intr()
    pts, cols, valid = random_cloud(rng, 5000, intr)
    args = [jax.device_put(jnp.asarray(a), gpu_device)
            for a in (pts, cols, valid)]
    img, _ = R.project_zbuffer(*args, intr)
    want_img, _ = oracles.project_zbuffer_oracle(
        pts, cols, valid,
        float(intr.fx), float(intr.fy), float(intr.ppx), float(intr.ppy),
        intr.width, intr.height,
    )
    np.testing.assert_array_equal(np.asarray(img), want_img)
