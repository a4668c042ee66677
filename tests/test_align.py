"""Depth→color alignment tests against the scalar oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from pointcloud_depthfusion_tpu.core.camera import Extrinsics, Intrinsics
from pointcloud_depthfusion_tpu.ops.align import align_depth_to_color

import oracles


def setup_cams():
    d_intr = Intrinsics.create(32, 24, fx=28.0, fy=28.5, ppx=16.0, ppy=12.0)
    c_intr = Intrinsics.create(40, 30, fx=35.0, fy=35.5, ppx=20.0, ppy=15.0)
    # small rotation + baseline
    a = 0.02
    rot = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    ext = Extrinsics.create(rot, [0.015, -0.001, 0.002])
    return d_intr, c_intr, ext, rot


def test_align_matches_oracle(rng):
    d_intr, c_intr, ext, rot = setup_cams()
    depth = rng.integers(400, 3000, (24, 32)).astype(np.uint16)
    depth[rng.random((24, 32)) < 0.2] = 0
    got = align_depth_to_color(
        jnp.asarray(depth), 0.001, d_intr, c_intr, ext
    )
    want = oracles.align_depth_to_color_oracle(
        depth, 0.001,
        28.0, 28.5, 16.0, 12.0,
        35.0, 35.5, 20.0, 15.0,
        np.asarray(rot, np.float64), np.array([0.015, -0.001, 0.002]),
        40, 30,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_align_identity_extrinsics_same_intrinsics(rng):
    intr = Intrinsics.create(32, 24, fx=28.0, fy=28.0, ppx=16.0, ppy=12.0)
    depth = rng.integers(400, 3000, (24, 32)).astype(np.uint16)
    got = np.asarray(
        align_depth_to_color(
            jnp.asarray(depth), 0.001, intr, intr, Extrinsics.identity()
        )
    )
    # with identity mapping, each pixel's footprint covers itself; interior
    # pixels should keep (a min over neighbors including) their own value
    assert got.shape == depth.shape
    nonzero = got > 0
    assert nonzero.mean() > 0.9
    # A pixel covered by its own (valid) footprint can only decrease; edge
    # pixels whose own box fell outside the image are covered by neighbors
    # and may exceed their input value, so check the interior only.
    interior = np.zeros_like(nonzero)
    interior[:-1, :-1] = True
    sel = nonzero & interior
    assert (got[sel] <= depth[sel]).all()


def test_align_zero_depth_is_zero():
    d_intr, c_intr, ext, _ = setup_cams()
    out = align_depth_to_color(
        jnp.zeros((24, 32), jnp.uint16), 0.001, d_intr, c_intr, ext
    )
    assert np.asarray(out).sum() == 0


def test_align_sorted_and_binned_bit_identical(rng):
    """The class-binned stencil must match the scatter path bit-for-bit."""
    d_intr, c_intr, ext, rot = setup_cams()
    depth = rng.integers(400, 3000, (24, 32)).astype(np.uint16)
    depth[rng.random((24, 32)) < 0.2] = 0
    a = align_depth_to_color(
        jnp.asarray(depth), 0.001, d_intr, c_intr, ext, method="scatter"
    )
    for method in ("binned",):
        b = align_depth_to_color(
            jnp.asarray(depth), 0.001, d_intr, c_intr, ext, method=method
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_auto_footprint_matches_oracle(rng):
    """The intrinsics-derived static footprint bound must still cover the
    reference's full dynamic splat box (oracle has no cap)."""
    from pointcloud_depthfusion_tpu.ops.align import auto_footprint

    d_intr, c_intr, ext, rot = setup_cams()
    assert auto_footprint(d_intr, c_intr) == 3  # ratio ~1.25 -> 3
    depth = rng.integers(400, 3000, (24, 32)).astype(np.uint16)
    depth[rng.random((24, 32)) < 0.2] = 0
    got = align_depth_to_color(
        jnp.asarray(depth), 0.001, d_intr, c_intr, ext, max_footprint="auto"
    )
    want = oracles.align_depth_to_color_oracle(
        depth, 0.001,
        d_intr.fx, d_intr.fy, d_intr.ppx, d_intr.ppy,
        c_intr.fx, c_intr.fy, c_intr.ppx, c_intr.ppy,
        rot, np.array([0.015, -0.001, 0.002], np.float32),
        c_intr.width, c_intr.height,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_saturated_depth_maps_to_zero_all_methods():
    """0xFFFF depth collides with the reference's buffer sentinel
    (kernels.cu:284) and must come out 0 in EVERY resolve method."""
    d_intr, c_intr, ext, rot = setup_cams()
    depth = np.full((24, 32), 0xFFFF, np.uint16)
    a = align_depth_to_color(
        jnp.asarray(depth), 0.001, d_intr, c_intr, ext, method="scatter"
    )
    assert int(np.asarray(a).sum()) == 0
    for method in ("binned",):
        b = align_depth_to_color(
            jnp.asarray(depth), 0.001, d_intr, c_intr, ext, method=method
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_auto_footprint_extrinsics_inflation():
    """A color camera behind the depth origin magnifies splat boxes; the
    auto bound must grow with the translation magnitude."""
    from pointcloud_depthfusion_tpu.ops.align import auto_footprint

    d = Intrinsics.create(640, 480, fx=400.0, fy=400.0, ppx=320.0, ppy=240.0)
    c = Intrinsics.create(640, 480, fx=560.0, fy=560.0, ppx=320.0, ppy=240.0)
    near = Extrinsics.create(np.eye(3), [0.015, 0.0, 0.0])
    far = Extrinsics.create(np.eye(3), [0.0, 0.0, -0.08])
    b_near = auto_footprint(d, c, near)
    b_far = auto_footprint(d, c, far, min_depth=0.2)
    assert b_near == 3
    assert b_far > b_near  # 0.2/(0.2-0.08) = 1.67x perspective inflation


@pytest.mark.parametrize("method", ["sorted", "bogus"])
def test_align_rejects_unknown_method(method, rng):
    """Only the two plain methods exist; anything else (including the
    removed sort-based one) is an error, not a silent fallback."""
    d_intr, c_intr, ext, _ = setup_cams()
    depth = rng.integers(400, 3000, (24, 32)).astype(np.uint16)
    with pytest.raises(ValueError, match="unknown align method"):
        align_depth_to_color(jnp.asarray(depth), 0.001, d_intr, c_intr, ext,
                             method=method)
