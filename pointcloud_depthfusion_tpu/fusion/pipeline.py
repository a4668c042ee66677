"""The end-to-end fusion pipeline: two framesets → one fused RGB image.

This is the whole reference fusion hot path (FusionNode::processSyncedFrames,
fusion_node.cpp:700-811) expressed as ONE jitted XLA computation:

    H2D → [align] → filter → deproject ×2 → transform right → merge →
    virtual-camera transform → z-buffer project → color filter → D2H

The reference stages this across hand-managed CUDA buffers on two streams;
here every intermediate is an SSA value inside one program, so XLA fuses the
elementwise chain (filter→deproject→transform) into a handful of kernels and
overlaps the scatter passes. Dense (H, W) tensors + masks replace the
compacted point lists, and `append` (pointcloud.cpp:117-129) becomes a
concatenation of the two statically-shaped clouds.

Deliberate behavior decisions vs the reference (SURVEY.md §7 "quirks"):
  * the `align_frames` path aligns LEFT and RIGHT each with their own
    frames — the reference re-aligns the left frame twice and never aligns
    the right (copy-paste bug, fusion_node.cpp:729-733). Fixed here.
  * z-buffer ties resolve deterministically (ops/render.py) instead of
    racing.
  * intrinsics int-truncation (cameraInfo2Intrinsics) is applied at config
    load time via ``legacy_int_truncation`` (core/camera.py), not here.
"""

from __future__ import annotations

import dataclasses

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_depthfusion_tpu.core import geometry as G
from pointcloud_depthfusion_tpu.core.camera import (
    Intrinsics,
    fused_virtual_intrinsics,
)
from pointcloud_depthfusion_tpu.core.frameset import Frameset
from pointcloud_depthfusion_tpu.ops import filters as F
from pointcloud_depthfusion_tpu.ops import render as R
from pointcloud_depthfusion_tpu.ops.align import align_depth_to_color

Array = jax.Array

RENDER_MODES = ("tiled", "exact", "indexed", "packed")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Fusion parameters (config_default.yaml of fusion_node).

    Traced leaves: depth window and virtual-camera pose; static fields:
    everything that changes program structure.
    """

    min_depth: Array  # meters
    max_depth: Array
    camera_translation: Array  # (3,) meters, when set_camera_pose
    camera_rotation_deg: Array  # (3,) degrees, when set_camera_pose
    vertical_image: bool = dataclasses.field(
        default=True, metadata=dict(static=True)
    )
    mirror_image: bool = dataclasses.field(default=True, metadata=dict(static=True))
    use_median_filter: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    align_frames: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # Static splat-box cap for align_frames (entry count — and the sorted
    # align's sort cost — scales with its square). "auto" derives the tight
    # pinhole bound from the intrinsics when they are concrete at trace
    # time (ops/align.auto_footprint) and keeps 4 when they are traced;
    # nodes that know their intrinsics host-side can pin an int.
    align_footprint: object = dataclasses.field(
        default="auto", metadata=dict(static=True)
    )
    set_camera_pose: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    filter_fused_color: bool = dataclasses.field(
        default=True, metadata=dict(static=True)
    )
    roi_left: Optional[Tuple[int, int, int, int]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    roi_right: Optional[Tuple[int, int, int, int]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # "tiled" and "exact" (the same render under two names, so manifests
    # keep working): BIT-EXACT — exact f32 depth, RGB888, deterministic
    # min-RGB tie-break (ops/render.resolve_winners). The default.
    # "indexed": single-scatter (zq12|point-index) winner selection + exact
    # RGB888/f32-depth winner gathers — ≤1e-3 output fidelity (winner
    # within one 0.92 mm quantization step).
    # "packed": single-scatter (zq14|RGB666) render — lossy color (see
    # ops/render.py for envelopes).
    render_mode: str = dataclasses.field(
        default="tiled", metadata=dict(static=True)
    )
    # Emit the fused z-buffer alongside the image (FusionResult.zbuf).
    # The reference's fusion node publishes only the fused COLOR image —
    # its z-buffer is internal to the CUDA kernel (kernels.cu:239-274) —
    # but the buffer is kept ON by default for API/parity completeness.
    # Streaming consumers that only publish the image may set False;
    # FusionResult.zbuf is then None.
    emit_zbuf: bool = dataclasses.field(default=True, metadata=dict(static=True))

    @staticmethod
    def create(
        min_depth: float = 0.5,
        max_depth: float = 3.0,
        camera_translation=(0.0, 0.0, 0.0),
        camera_rotation_deg=(0.0, 0.0, 0.0),
        **static_fields,
    ) -> "FusionConfig":
        return FusionConfig(
            min_depth=jnp.asarray(min_depth, jnp.float32),
            max_depth=jnp.asarray(max_depth, jnp.float32),
            camera_translation=jnp.asarray(camera_translation, jnp.float32),
            camera_rotation_deg=jnp.asarray(camera_rotation_deg, jnp.float32),
            **static_fields,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusionResult:
    """Outputs of one fused frame."""

    image: Array  # (Hf, Wf, 3) uint8
    zbuf: Array  # (Hf, Wf) float32, FLT_MAX where empty
    valid_left: Array  # (H, W) bool
    valid_right: Array
    timestamp: Array  # left frame's stamp (fusion_node.cpp:801)


def virtual_camera_transform(config: FusionConfig) -> Array:
    """The explicit virtual-camera pose (fusion_node.cpp:168-180).

    Eigen construction order: identity, prerotate(Rz 90°),
    pretranslate(-t), prerotate(R(x,y,z)^{-1})  ⇒  M = R⁻¹ · T(-t) · Rz90.
    """
    rz90 = G.rotz(G.deg2rad(90.0))
    rot = G.euler_to_matrix(G.deg2rad(config.camera_rotation_deg))
    m = rz90
    m = m.at[:3, 3].add(-config.camera_translation)  # pretranslate
    r_inv4 = jnp.eye(4, dtype=m.dtype).at[:3, :3].set(rot.T)
    return G.mm(r_inv4, m)


def fused_camera_transform(config: FusionConfig, right_transform: Array) -> Array:
    """Virtual-camera transform for this frame.

    Either the slerp midpoint between the (identity) left pose and the
    registration transform (fusion_node.cpp:766-771) or the configured pose;
    vertical output prerotates +90° about Z (fusion_node.cpp:775-778).
    """
    if config.set_camera_pose:
        t = virtual_camera_transform(config)
    else:
        left = jnp.eye(4, dtype=right_transform.dtype)
        t = G.interpolate_transform(left, right_transform)
    if config.vertical_image:
        # f32-precision compose: a reduced-precision (TF32) matmul would
        # corrupt the pose matrix (see core/geometry._F32).
        t = G.mm(G.rotz(G.deg2rad(90.0)), t)
    return t


def _prepare_camera(
    fs: Frameset,
    roi,
    config: FusionConfig,
) -> Tuple[Array, Array, Array, Array, Array]:
    """Per-camera stage: [align] → filter → deproject (planar SoA).

    Returns (x, y, z, color (H,W,3) u8, valid (H,W)) — coordinate planes
    keep the minor dimension = image width (see
    geometry.deproject_planar).
    """
    depth = fs.depth
    if config.align_frames:
        depth = align_depth_to_color(
            depth,
            fs.depth_scale,
            fs.depth_intrinsics,
            fs.color_intrinsics,
            fs.depth_to_color,
            max_footprint=config.align_footprint,
        )
    depth, valid = F.filter_depth(
        depth, fs.depth_scale, config.min_depth, config.max_depth, roi
    )
    depth_m = depth.astype(jnp.float32) * fs.depth_scale
    x, y, z, valid = G.deproject_planar(depth_m, fs.color_intrinsics, valid)
    return x, y, z, fs.color, valid


def fuse(
    left: Frameset,
    right: Frameset,
    right_transform: Array,
    config: FusionConfig,
    fused_intrinsics: Intrinsics,
) -> FusionResult:
    """Fuse one synchronized frameset pair into a virtual-camera RGB image.

    Args:
      right_transform: 4×4 right→left registration transform (from
        the registration service, fusion_node.cpp:610-613).
      fused_intrinsics: virtual-camera intrinsics
        (core.camera.fused_virtual_intrinsics).
    """
    if config.render_mode not in RENDER_MODES:
        raise ValueError(
            f"unknown render_mode {config.render_mode!r} (expected one of "
            f"{'/'.join(RENDER_MODES)})"
        )

    xl, yl, zl, col_l, val_l = _prepare_camera(left, config.roi_left, config)
    xr, yr, zr, col_r, val_r = _prepare_camera(right, config.roi_right, config)

    # Move the right cloud into the left camera frame, then both into the
    # virtual-camera frame; composing the matrices first saves one full
    # 9-mul pass over the right cloud.
    fused_t = fused_camera_transform(config, right_transform)
    right_total = G.mm(fused_t, right_transform.astype(fused_t.dtype))
    xl, yl, zl = G.transform_planar(xl, yl, zl, fused_t)
    xr, yr, zr = G.transform_planar(xr, yr, zr, right_total)

    # Merge (reference: Pointcloud::append D2D memcpy; here a free stack).
    x = jnp.stack([xl, xr])
    y = jnp.stack([yl, yr])
    z = jnp.stack([zl, zr])
    val = jnp.stack([val_l, val_r])
    col = jnp.stack([col_l, col_r])  # (2, H, W, 3)
    r = col[..., 0]
    g = col[..., 1]
    b = col[..., 2]

    # Every mode stays channel-planar through the color filter and stacks
    # to HWC exactly once. Pre-packed color (Frameset.color_packed) skips
    # the per-frame HWC u8 channel-plane relayout in every exact-color
    # mode; the then-unused r/g/b slices above are dead-code-eliminated by
    # XLA. Bit-identical either way (the packed plane is exactly the rgb24
    # the renders pack).
    rgb24 = None
    if left.color_packed is not None and right.color_packed is not None:
        rgb24 = jnp.stack([left.color_packed, right.color_packed])
    w_f, h_f = fused_intrinsics.width, fused_intrinsics.height
    if config.render_mode == "packed":
        # Quantization range: the virtual camera sits between the two
        # physical ones, so transformed depths stay within ~[min/2, max+1].
        planes, zbuf = R.project_zbuffer_packed_planar(
            x, y, z, r, g, b, val, fused_intrinsics,
            mirror=config.mirror_image,
            z_near=0.5 * config.min_depth, z_far=config.max_depth + 1.0,
            return_planes=True, rgb24=rgb24,
        )
    elif config.render_mode == "indexed":
        covered, widx = R.indexed_winner_planar(
            x, y, z, val, fused_intrinsics, mirror=config.mirror_image,
            z_near=0.5 * config.min_depth, z_far=config.max_depth + 1.0,
        )
        rp, gp, bp, zb = R.indexed_winner_gather(covered, widx, z, r, g, b,
                                                 rgb24=rgb24)
        planes = (rp.reshape(h_f, w_f), gp.reshape(h_f, w_f),
                  bp.reshape(h_f, w_f))
        zbuf = zb.reshape(h_f, w_f)
    else:  # tiled / exact
        planes, zbuf = R.project_zbuffer_planar(
            x, y, z, r, g, b, val, fused_intrinsics,
            mirror=config.mirror_image, return_planes=True,
            need_zbuf=config.emit_zbuf, rgb24=rgb24,
        )
    # ONE shared fused-image tail for every mode: a tail change (like the
    # half-up Gauss rounding fix) lands exactly once.
    rp, gp, bp = planes
    if config.filter_fused_color:
        image = F.filter_color_planar(rp, gp, bp, config.use_median_filter)
    else:
        image = jnp.stack([rp, gp, bp], axis=-1)

    return FusionResult(
        image=image,
        zbuf=zbuf,
        valid_left=val_l,
        valid_right=val_r,
        timestamp=left.timestamp,
    )


_donation_filter_installed = False


def _suppress_expected_donation_warning() -> None:
    """Install ONCE a message-scoped ignore for XLA's "Some donated buffers
    were not usable" warning.

    Design tension, resolved deliberately: a blanket process-wide filter
    would hide genuine donation misuse in unrelated user code, but wrapping
    every dispatch in ``warnings.catch_warnings()`` mutates process-global
    state per frame and is documented as not thread-safe (a warning raised
    by another thread while the context is active gets swallowed; the
    warn-once registry is reset on every entry/exit). The narrow middle:
    one idempotent filter keyed on the exact message text of the ONE
    warning a donating FusionPipeline is known to trigger by design (see
    the constructor comment) — every other warning, including differently-
    worded donation diagnostics, stays visible.
    """
    global _donation_filter_installed
    if _donation_filter_installed:
        return
    import warnings  # noqa: PLC0415

    warnings.filterwarnings(
        "ignore", message="Some donated buffers were not usable"
    )
    _donation_filter_installed = True


class FusionPipeline:
    """Stateful convenience wrapper: holds config + intrinsics, jits `fuse`.

    Plays the role of the reference FusionNode's steady-state machinery
    (minus transport): construct with both cameras' calibration (the
    service-handshake data, fusion_node.cpp:92-148), then call
    :meth:`process` per synchronized frame pair.
    """

    def __init__(
        self,
        color_intrinsics_left: Intrinsics,
        config: FusionConfig,
        donate: bool = False,
    ):
        """``donate=True`` donates the per-frame depth/color device buffers
        to the fused program (the streaming feeder produces fresh buffers
        every frame, so donation recycles them). Only the image buffers are
        donated — calibration leaves are shared between the two framesets
        and must not be (XLA rejects `f(donate(a), a)`). Leave False when
        re-processing the same Frameset objects.
        """
        self.config = config
        self.fused_intrinsics = fused_virtual_intrinsics(
            color_intrinsics_left, config.vertical_image
        )
        fused_intr = self.fused_intrinsics

        def fuse_buffers(ld, lc, rd, rc, left_rest, right_rest, t, cfg):
            left = dataclasses.replace(left_rest, depth=ld, color=lc)
            right = dataclasses.replace(right_rest, depth=rd, color=rc)
            return fuse(left, right, t, cfg, fused_intr)

        self._fuse_impl = jax.jit(
            fuse_buffers,
            donate_argnums=(0, 1, 2, 3) if donate else (),
        )
        # The donation warning is EXPECTED for this program:
        # - on CPU, jnp.asarray is zero-copy over host numpy buffers,
        #   so XLA cannot take ownership at all;
        # - on an accelerator, donation only ALIASES when an output matches a
        #   donated input's shape+dtype — the vertical-image fuse maps
        #   (H, W, 3) u8 color to a (W, H, 3) image, so inputs degrade
        #   to early-free (still the point: the per-frame input
        #   buffers are released as soon as the program consumes them
        #   instead of surviving until the host drops the Frameset).
        # Suppressed ONCE here, scoped by the exact message text — NOT
        # per call: warnings.catch_warnings() mutates process-global state
        # and is documented as not thread-safe, so wrapping every
        # process() dispatch (30+ Hz, concurrent with camera/readback
        # threads) could swallow a genuine warning raised by another
        # thread mid-frame and resets the warn-once registry each call.
        if donate:
            _suppress_expected_donation_warning()
        self._donate = donate
        self.right_transform = jnp.eye(4, dtype=jnp.float32)
        # Reused placeholder for the stripped "rest" pytrees in process().
        self._zero = jnp.zeros((), jnp.uint8)

    def set_right_transform(self, transform) -> None:
        """Registration-transform update (transformCallback equivalent)."""
        self.right_transform = jnp.asarray(transform, jnp.float32)

    # -- split-program profiling mode ---------------------------------------

    def _stage_jits(self) -> dict:
        """Per-stage jitted programs for the profiling mode.

        The reference measures 14 stages with cudaDeviceSynchronize fences
        (getTiming, fusion_node.cpp:620-631). A single fused XLA program has
        no internal boundaries, so the profiling mode compiles the pipeline
        as these sub-programs instead — same math, materialized stage
        boundaries — and fences each with block_until_ready. It follows the
        reference's stage structure (transform right→left, then transform
        the MERGED cloud into the virtual camera) rather than the fused
        path's composed-matrix shortcut, so per-pixel results can differ in
        the last float bit at winner near-ties.
        """
        if getattr(self, "_stages", None):
            return self._stages
        cfg = self.config
        fi = self.fused_intrinsics

        def make_filter(roi):
            @jax.jit
            def s_filter(depth, scale, min_d, max_d, intr_d, intr_c, d2c):
                if cfg.align_frames:
                    depth = align_depth_to_color(
                        depth, scale, intr_d, intr_c, d2c,
                        max_footprint=cfg.align_footprint,
                    )
                return F.filter_depth(depth, scale, min_d, max_d, roi)

            return s_filter

        @jax.jit
        def s_deproject(depth_u16, scale, intr, valid):
            depth_m = depth_u16.astype(jnp.float32) * scale
            return G.deproject_planar(depth_m, intr, valid)

        @jax.jit
        def s_transform(x, y, z, t):
            return G.transform_planar(x, y, z, t)

        @jax.jit
        def s_fuse(xl, yl, zl, vl, cl, xr, yr, zr, vr, cr):
            return (
                jnp.stack([xl, xr]), jnp.stack([yl, yr]), jnp.stack([zl, zr]),
                jnp.stack([vl, vr]), jnp.stack([cl, cr]),
            )

        @jax.jit
        def s_project(x, y, z, col, val, min_depth, max_depth):
            r = col[..., 0]
            g = col[..., 1]
            b = col[..., 2]
            z_near = 0.5 * min_depth
            z_far = max_depth + 1.0
            h_f, w_f = fi.height, fi.width
            if cfg.render_mode == "packed":
                (rp, gp, bp), zbuf = R.project_zbuffer_packed_planar(
                    x, y, z, r, g, b, val, fi, mirror=cfg.mirror_image,
                    z_near=z_near, z_far=z_far, return_planes=True,
                )
            elif cfg.render_mode == "indexed":
                covered, widx = R.indexed_winner_planar(
                    x, y, z, val, fi, mirror=cfg.mirror_image,
                    z_near=z_near, z_far=z_far,
                )
                # (split profiling path takes r/g/b buffers; no packed
                # plane rides through the per-stage donation signature)
                rp, gp, bp, zb = R.indexed_winner_gather(
                    covered, widx, z, r, g, b
                )
                rp, gp, bp = (p.reshape(h_f, w_f) for p in (rp, gp, bp))
                zbuf = zb.reshape(h_f, w_f)
            else:  # tiled / exact
                (rp, gp, bp), zbuf = R.project_zbuffer_planar(
                    x, y, z, r, g, b, val, fi, mirror=cfg.mirror_image,
                    return_planes=True,
                )
            return rp, gp, bp, zbuf

        @jax.jit
        def s_filter_image(rp, gp, bp):
            if cfg.filter_fused_color:
                return F.filter_color_planar(rp, gp, bp, cfg.use_median_filter)
            return jnp.stack([rp, gp, bp], axis=-1)

        @jax.jit
        def s_virtual(right_transform):
            # Jitted: eager slerp/quaternion math here is ~30 host
            # dispatches per frame, whose dispatch overhead would be
            # billed to the 'transform' stage lap.
            return fused_camera_transform(cfg, right_transform)

        self._stages = dict(
            virtual=s_virtual,
            filter_left=make_filter(cfg.roi_left),
            filter_right=make_filter(cfg.roi_right),
            deproject=s_deproject,
            transform=s_transform,
            fuse=s_fuse,
            project=s_project,
            filter_image=s_filter_image,
        )
        return self._stages

    def process_profiled(self, left: Frameset, right: Frameset):
        """Run one frame through the SPLIT pipeline with per-stage fences.

        Returns (FusionResult, laps dict, host_image ndarray) — the host
        copy rides along because the copy_from_gpu lap already fenced it.
        laps carries real milliseconds for the reference schema's device
        stages: filter,
        deproject, transform_right, fuse, transform, project, filter_image,
        copy_from_gpu. (Host-side stages — callback/publish/latency/diff —
        are the caller's to fill, like the reference.) ~15-25% slower than
        :meth:`process` because stage boundaries materialize intermediates;
        use only when profiling, like the reference's enable_profiling.
        """
        from pointcloud_depthfusion_tpu.utils.profiling import StageTimer  # noqa: PLC0415

        s = self._stage_jits()
        cfg = self.config
        timer = StageTimer()
        dl, vl = s["filter_left"](
            left.depth, left.depth_scale, cfg.min_depth, cfg.max_depth,
            left.depth_intrinsics, left.color_intrinsics, left.depth_to_color,
        )
        dr, vr = s["filter_right"](
            right.depth, right.depth_scale, cfg.min_depth, cfg.max_depth,
            right.depth_intrinsics, right.color_intrinsics, right.depth_to_color,
        )
        timer.lap("filter", dl, dr)
        xl, yl, zl, vl = s["deproject"](dl, left.depth_scale, left.color_intrinsics, vl)
        xr, yr, zr, vr = s["deproject"](dr, right.depth_scale, right.color_intrinsics, vr)
        timer.lap("deproject", xl, xr)
        xr, yr, zr = s["transform"](xr, yr, zr, self.right_transform)
        timer.lap("transform_right", xr)
        x, y, z, val, col = s["fuse"](
            xl, yl, zl, vl, left.color, xr, yr, zr, vr, right.color
        )
        timer.lap("fuse", x)
        fused_t = s["virtual"](self.right_transform)
        x, y, z = s["transform"](x, y, z, fused_t)
        timer.lap("transform", x)
        rp, gp, bp, zbuf = s["project"](
            x, y, z, col, val, cfg.min_depth, cfg.max_depth
        )
        timer.lap("project", rp, gp, bp)
        image = s["filter_image"](rp, gp, bp)
        timer.lap("filter_image", image)
        host_image = np.asarray(image)
        timer.lap("copy_from_gpu")
        result = FusionResult(
            image=image,
            zbuf=zbuf,
            valid_left=vl,
            valid_right=vr,
            timestamp=left.timestamp,
        )
        return result, timer.laps, host_image

    def process(self, left: Frameset, right: Frameset) -> FusionResult:
        # Strip the image buffers out of the "rest" pytrees so the donated
        # arrays appear exactly once in the argument list. The placeholder
        # scalar is allocated ONCE and reused: a fresh jnp.zeros per frame
        # is its own device dispatch on the per-frame path.
        zero = self._zero
        left_rest = dataclasses.replace(left, depth=zero, color=zero)
        right_rest = dataclasses.replace(right, depth=zero, color=zero)
        return self._fuse_impl(
            left.depth, left.color, right.depth, right.color,
            left_rest, right_rest, self.right_transform, self.config,
        )
