"""Multi-chip scale-out: camera-parallel rig fusion over a device mesh.

The reference scales by process replication over two Jetsons with DDS/UDP
fan-in (SURVEY.md §2.8). Here CAMERAS are sharded over mesh devices: each
device filters/deprojects/renders its own camera's frameset into a local
z-buffer, and the fused image is a z-buffer MERGE — an all-reduce **min**
over the camera axis:

    pmin(zbuf)  →  local winner mask  →  pmin(packed RGB of winners)

Two small collectives (H·W floats + H·W int32) replace the reference's
full-frameset network hop, and ties resolve deterministically exactly like
the single-chip path (ops/render.py).

Also provided: batch (data-parallel) fusion via vmap for many frame-pairs
per step, composable with the camera axis.
"""

from __future__ import annotations


from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pointcloud_depthfusion_tpu.core import geometry as G
from pointcloud_depthfusion_tpu.core.camera import Intrinsics
from pointcloud_depthfusion_tpu.fusion.pipeline import FusionConfig
from pointcloud_depthfusion_tpu.ops import filters as F
from pointcloud_depthfusion_tpu.ops import render as R

Array = jax.Array


def make_camera_mesh(n_cameras: Optional[int] = None, axis: str = "cam") -> Mesh:
    """1-D device mesh over the camera axis."""
    from jax.experimental import mesh_utils  # noqa: PLC0415

    devs = jax.devices()
    n = n_cameras or len(devs)
    return Mesh(mesh_utils.create_device_mesh((n,), devs[:n]), (axis,))


class _RigCalibration:
    """Shared-or-per-camera source calibration for the rig bodies.

    The reference rig is per-camera calibrated — each camera's handshake
    delivers its own intrinsics (fusion_node.cpp:92-148) — so the N-camera
    paths accept either ONE shared :class:`Intrinsics` (homogeneous rig,
    the cheap broadcast case) or a sequence of N (heterogeneous rig).
    Per-camera values become (C,) traced leaves that broadcast against the
    hand-batched (N, H, W) prep as (N, 1, 1) windows; static fields
    (width/height/distortion model) must agree across cameras — they fix
    array shapes and program structure.

    Optional per-camera ``rois`` ([x, y, w, h] or None per camera) apply
    the reference's ROI'd validity mask (kernels.cu:379-384) per camera,
    like the dual path's roi_left/roi_right.
    """

    def __init__(self, intrinsics, rois=None):
        if isinstance(intrinsics, Intrinsics):
            self.ref = intrinsics
            self.seq = None
        else:
            seq = tuple(intrinsics)
            if not seq:
                raise ValueError("need at least one camera's intrinsics")
            self.ref = seq[0]
            for it in seq[1:]:
                if (it.width, it.height, it.model) != (
                    self.ref.width, self.ref.height, self.ref.model
                ):
                    raise ValueError(
                        "per-camera intrinsics must share width/height/"
                        "distortion model (they are static shape/program "
                        "parameters); traced leaves (fx/fy/ppx/ppy/coeffs) "
                        "may differ freely"
                    )
            self.seq = seq
            f = jnp.float32
            self.ppx = jnp.stack([it.ppx for it in seq]).astype(f)  # (C,)
            self.ppy = jnp.stack([it.ppy for it in seq]).astype(f)
            self.fx = jnp.stack([it.fx for it in seq]).astype(f)
            self.fy = jnp.stack([it.fy for it in seq]).astype(f)
            # (5, C): coeffs[k] indexes the polynomial term, matching the
            # shared case's coeffs[k] scalar (geometry.py:50-61).
            self.coeffs = jnp.stack(
                [it.coeffs for it in seq], axis=1
            ).astype(f)
        # ROIs stay STATIC [x, y, w, h] tuples; masks are built from iota
        # compares INSIDE the traced bodies (F.roi_mask_traced), never as
        # precomputed device arrays the jitted rig functions close over —
        # closed-over arrays embed as program constants (slow compiles, no
        # persistent-cache hits; an 8-camera 720p rig would bake ~7.4 MB of
        # bool masks into every rig executable).
        if rois is not None:
            self.rois = tuple(
                None if r is None else tuple(int(v) for v in r)
                for r in rois
            )
            if self.seq is not None and len(self.rois) != len(self.seq):
                raise ValueError(
                    f"{len(self.rois)} rois for {len(self.seq)} per-camera "
                    "intrinsics — the per-camera axes must agree"
                )
        else:
            self.rois = None

    @property
    def per_camera(self) -> bool:
        return self.seq is not None or self.rois is not None

    @property
    def n_cameras(self) -> Optional[int]:
        """Number of per-camera calibration entries (None when shared)."""
        if self.seq is not None:
            return len(self.seq)
        if self.rois is not None:
            return len(self.rois)
        return None

    def _mask_stack(self):
        """(C, H, W) bool ROI masks, built in-trace (iota compares — XLA
        keeps iota fused into consumers rather than folding it into a
        multi-MB literal)."""
        return jnp.stack([
            F.roi_mask_traced(self.ref.height, self.ref.width, r)
            for r in self.rois
        ])

    def _take(self, arr, n_local: int, cam_offset):
        """(..., C) → (..., n_local): slice at a traced device offset
        (sharded path) or tile to a multiple (batched path)."""
        c = arr.shape[-1]
        if cam_offset is not None:
            return jax.lax.dynamic_slice_in_dim(arr, cam_offset, n_local, -1)
        if c == n_local:
            return arr
        if n_local % c:
            raise ValueError(
                f"{n_local} local cameras is not a multiple of the "
                f"{c} calibrated cameras"
            )
        reps = (1,) * (arr.ndim - 1) + (n_local // c,)
        return jnp.tile(arr, reps)

    def windows(self, n_local: int, cam_offset=None):
        """Broadcastable (ppx, ppy, fx, fy, coeffs) against (N, H, W)."""
        if self.seq is None:
            i = self.ref
            return i.ppx, i.ppy, i.fx, i.fy, i.coeffs
        e = lambda a: self._take(a, n_local, cam_offset)[..., :, None, None]
        return (
            e(self.ppx), e(self.ppy), e(self.fx), e(self.fy), e(self.coeffs)
        )

    def valid_roi(self, valid, cam_offset=None):
        """AND the per-camera ROI masks into an (N, H, W) validity mask."""
        if self.rois is None:
            return valid
        masks = self._take(
            jnp.moveaxis(self._mask_stack(), 0, -1), valid.shape[0],
            cam_offset,
        )
        return valid & jnp.moveaxis(masks, -1, 0)

    def at(self, i: int, cam_offset=None) -> Intrinsics:
        """Camera i's Intrinsics (i local; cam_offset shifts into the
        global camera axis on sharded paths)."""
        if self.seq is None:
            return self.ref
        if cam_offset is None:
            return self.seq[i]
        import dataclasses as _dc

        g = lambda a: jax.lax.dynamic_index_in_dim(
            a, cam_offset + i, axis=-1, keepdims=False
        )
        return _dc.replace(
            self.ref, ppx=g(self.ppx), ppy=g(self.ppy), fx=g(self.fx),
            fy=g(self.fy), coeffs=g(self.coeffs),
        )

    def roi_at(self, i: int, cam_offset=None):
        if self.rois is None:
            return None
        if cam_offset is None:
            return F.roi_mask_traced(
                self.ref.height, self.ref.width, self.rois[i]
            )
        return jax.lax.dynamic_index_in_dim(
            self._mask_stack(), cam_offset + i, axis=0, keepdims=False
        )


def _rgb24_of(color, ref_ndim: int):
    """rgb24 i32 from either an (…,3) u8 HWC image or a pre-packed
    (…) i32 plane (Frameset.color_packed semantics): rank tells which.
    The HWC branch delegates to the ONE canonical device packer
    (ops.render.pack_rgb) so the bit layout lives in exactly one place."""
    if color.ndim == ref_ndim:
        return color.astype(jnp.int32)
    return R.pack_rgb(color)


def _packed_rig_body(
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    z_near: float,
    z_far: float,
):
    """Shared per-device rig projection body: all local cameras fold into
    one flat packed-key scatter; returns the local packed buffer plus an
    unpack helper.

    ``intrinsics``: one shared Intrinsics or a per-camera sequence
    (heterogeneous rig — the reference's per-camera handshake calibration,
    fusion_node.cpp:92-148)."""
    calib = (
        intrinsics if isinstance(intrinsics, _RigCalibration)
        else _RigCalibration(intrinsics)
    )
    n_px = fused_intrinsics.width * fused_intrinsics.height
    z_bits = 14
    z_levels = jnp.float32((1 << z_bits) - 1)
    sentinel = jnp.uint32(0xFFFFFFFF)

    def project_one(depth1, color1, scale1, t1, intr1=None, roi1=None):
        d, valid = F.filter_depth(
            depth1, scale1, config.min_depth, config.max_depth
        )
        if roi1 is not None:
            valid = valid & roi1
        x, y, z, valid = G.deproject_planar(
            d.astype(jnp.float32) * scale1,
            intr1 if intr1 is not None else calib.ref, valid
        )
        x, y, z = G.transform_planar(x, y, z, t1)
        idx, zc, ok = R.compute_pixel_indices_planar(
            x, y, z, valid, fused_intrinsics, config.mirror_image
        )
        # Clip to z_levels-1: zq=16383 with near-white RGB666 would make
        # the packed key equal the 0xFFFFFFFF uncovered sentinel and the
        # point would silently vanish (see ops/render._packed_zq_hi).
        zq = jnp.clip(
            (zc - z_near) / (z_far - z_near) * z_levels, 0.0, z_levels - 1.0
        ).astype(jnp.uint32)
        # RGB666 from the canonical rgb24 (identical bits whether the
        # source was HWC u8 or a pre-packed plane).
        p24 = _rgb24_of(color1, depth1.ndim).astype(jnp.uint32)
        rgb666 = (
            (((p24 >> 18) & 0x3F) << 12)
            | (((p24 >> 10) & 0x3F) << 6)
            | ((p24 >> 2) & 0x3F)
        )
        key = jnp.where(ok, (zq << 18) | rgb666, sentinel)
        return idx, key

    def local_buffer(depth, color, depth_scale, cam_to_virtual,
                     cam_offset=None):
        # The local-camera loop is unrolled: camera count per device is
        # small and static.
        n_local = depth.shape[0]
        idxs, keys = [], []
        for i in range(n_local):
            a, k = project_one(
                depth[i], color[i], depth_scale[i], cam_to_virtual[i],
                intr1=calib.at(i, cam_offset),
                roi1=calib.roi_at(i, cam_offset),
            )
            idxs.append(a.reshape(-1))
            keys.append(k.reshape(-1))
        idx = jnp.concatenate(idxs)
        key = jnp.concatenate(keys)
        buf = jnp.full((n_px + 1,), sentinel, jnp.uint32)
        buf = buf.at[idx].min(key, mode="drop")
        return buf[:n_px]

    def unpack(merged):
        h_f, w_f = fused_intrinsics.height, fused_intrinsics.width
        rp, gp, bp = (
            p.reshape(h_f, w_f) for p in _decode_rgb666_planes(merged)
        )
        return _finish_planes(rp, gp, bp, config)

    return project_one, local_buffer, unpack


def _decode_rgb666(merged):
    """Expand a flat packed (zq14|RGB666) buffer to (n, 3) u8 colors
    (0 where the sentinel says uncovered). One decode shared by every
    packed-mode path — the bit layout lives in exactly two places (the
    packer in _packed_rig_body.project_one and here)."""
    rp, gp, bp = _decode_rgb666_planes(merged)
    return jnp.stack([rp, gp, bp], -1)


def _decode_rgb666_planes(merged):
    """:func:`_decode_rgb666` as three flat u8 channel planes (the layout
    the fused-color filter wants — see _finish_planes). Delegates to the
    ONE packed-layout decode (ops.render._decode_packed_planes) so the rig
    fold can never drift from the packed render paths; the z field is
    discarded (the rig merge consumes packed keys directly)."""
    rp, gp, bp, _ = R._decode_packed_planes(merged, 0.0, 1.0)
    return rp, gp, bp


def _finish_planes(rp, gp, bp, config: FusionConfig):
    """Fused-image tail shared by every rig path: the reference's fusion
    node filters the fused color before publishing (median|gauss 3×3,
    fusion_node.cpp:789 → kernels.cu:594-653), so the N-camera paths honor
    ``config.filter_fused_color`` exactly like the dual ``fuse()`` does.
    Channel-planar in, (H, W, 3) u8 out."""
    if config.filter_fused_color:
        return F.filter_color_planar(rp, gp, bp, config.use_median_filter)
    return jnp.stack([rp, gp, bp], axis=-1)


def _rig_render_mode(config: FusionConfig) -> str:
    """Resolve the rig render mode: 'exact' aliases to 'tiled' (the same
    bit-exact render); unsupported modes raise instead of silently
    degrading to the lossy packed fold."""
    mode = config.render_mode
    if mode == "exact":
        return "tiled"
    if mode not in ("tiled", "packed"):
        raise ValueError(
            f"rig fusion supports render_mode 'tiled'/'exact' (bit-exact) "
            f"or 'packed' (lossy RGB666), not {mode!r}"
        )
    return mode


def _tiled_rig_body(
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
):
    """Per-device rig body for the bit-exact render: every local camera
    contributes (pixel, z-bits, RGB888) entries, and ONE winner selection
    over all of them (ops/render.resolve_winners) replaces per-camera
    renders.
    """
    calib = (
        intrinsics if isinstance(intrinsics, _RigCalibration)
        else _RigCalibration(intrinsics)
    )
    n_px = fused_intrinsics.width * fused_intrinsics.height

    def entries_all(depth, color, depth_scale, cam_to_virtual,
                    pix_offsets=None, cam_offset=None):
        """Hand-batched (N,H,W) prep: one elementwise chain for ALL local
        cameras instead of N unrolled copies.

        The shared (H, W) pixel grid broadcasts against per-camera scalars
        ((N,1,1) windows, transform components). Bit-identical to the
        per-camera chain (same f32 ops).

        ``pix_offsets``: optional (N,) i32 per-camera pixel offset — the
        batched rig routes each stream into its own slice of one flat
        output buffer this way.

        ``cam_offset``: traced index of this shard's first camera on the
        global calibration axis (sharded heterogeneous rigs); None selects
        tile-to-batch resolution instead.
        """
        from pointcloud_depthfusion_tpu.core.camera import Distortion
        from pointcloud_depthfusion_tpu.core.geometry import (
            _undistort_inverse_brown_conrady,
            pixel_grid,
        )

        f = jnp.float32
        n_local, h, w = depth.shape
        scale = depth_scale.astype(f)[:, None, None]
        # filter_depth_minmax semantics: truncating-cast u16 thresholds
        # (kernels.cu:357-359), per camera.
        lo = (config.min_depth / depth_scale.astype(f)).astype(jnp.uint16)[
            :, None, None
        ]
        hi = (config.max_depth / depth_scale.astype(f)).astype(jnp.uint16)[
            :, None, None
        ]
        keep = (depth >= lo) & (depth <= hi)
        valid = keep & (depth > 0)
        valid = calib.valid_roi(valid, cam_offset)
        dm = jnp.where(keep, depth, 0).astype(f) * scale
        u, v = pixel_grid(h, w, f)  # shared across cameras (unbatched iota)
        # Per-camera calibration broadcasts as (N, 1, 1) windows against the
        # shared pixel grid (shared rigs keep plain scalars — free).
        c_ppx, c_ppy, c_fx, c_fy, c_coeffs = calib.windows(n_local, cam_offset)
        nx = (u - c_ppx) / c_fx
        ny = (v - c_ppy) / c_fy
        if calib.ref.model == Distortion.INVERSE_BROWN_CONRADY:
            nx, ny = _undistort_inverse_brown_conrady(nx, ny, c_coeffs)
        x, y, z = dm * nx, dm * ny, dm
        t = cam_to_virtual.astype(f)

        def tc(i, j):
            return t[:, i, j][:, None, None]

        xo = tc(0, 0) * x + tc(0, 1) * y + tc(0, 2) * z + tc(0, 3)
        yo = tc(1, 0) * x + tc(1, 1) * y + tc(1, 2) * z + tc(1, 3)
        zo = tc(2, 0) * x + tc(2, 1) * y + tc(2, 2) * z + tc(2, 3)
        idx, zc, ok = R.compute_pixel_indices_planar(
            xo, yo, zo, valid, fused_intrinsics, config.mirror_image
        )
        offset = 0
        if pix_offsets is not None:
            offset = pix_offsets.astype(jnp.int32)[:, None, None]
        return R.winner_entries(
            idx, zc, ok, _rgb24_of(color, depth.ndim), offset
        )

    def local_minbufs(depth, color, depth_scale, cam_to_virtual,
                      cam_offset=None):
        entries = entries_all(depth, color, depth_scale, cam_to_virtual,
                              cam_offset=cam_offset)
        return R.resolve_winners(*entries, n_px)

    def unpack(mrgb):
        # Coverage is the RGB sentinel: valid packed RGB is 24-bit.
        covered = mrgb != jnp.int32(R.NO_WINNER)
        h_f, w_f = fused_intrinsics.height, fused_intrinsics.width
        rp, gp, bp = R.decode_winner_planes(covered, mrgb)
        return _finish_planes(
            rp.reshape(h_f, w_f), gp.reshape(h_f, w_f),
            bp.reshape(h_f, w_f), config,
        )

    return entries_all, local_minbufs, unpack


def rig_fuse(
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    z_near: float = 0.25,
    z_far: float = 4.5,
    rois=None,
):
    """Single-device N-camera rig fusion (no mesh/collectives).

    Same math as :func:`rig_fuse_sharded` on one device, but compiled as a
    plain jit, without the SPMD partitioner. Use this for one-device rigs;
    the sharded variant when the camera axis actually spans devices.

    ``color`` accepts (N, H, W, 3) u8 HWC frames OR pre-packed (N, H, W)
    i32 rgb24 planes (Frameset.color_packed semantics — skips the
    per-camera HWC channel relayout in the prep; bit-identical). The
    sharded and batched variants accept the same.

    ``intrinsics``: one shared Intrinsics (homogeneous rig) or a
    per-camera sequence — the reference rig is per-camera calibrated via
    each camera's parameter handshake (fusion_node.cpp:92-148); width/
    height/distortion model must agree (static shapes), fx/fy/ppx/ppy/
    coeffs may differ per camera. ``rois``: optional per-camera
    [x, y, w, h] validity ROIs (None entries = full frame). Depth is
    expected pre-aligned to color, as the reference's camera nodes deliver
    (rs2::align runs at capture, realsense.cpp:373-376).

    ``render_mode`` "tiled" (or "exact", the same render) selects the
    bit-exact render (one winner selection over ALL cameras' entries);
    "packed" the lossy (zq14|RGB666) single-scatter fold; other modes raise.

    ``config.filter_fused_color``/``use_median_filter`` apply the
    reference's fused-image color filter (fusion_node.cpp:789) exactly
    like the dual ``fuse()`` path.
    """
    calib = _RigCalibration(intrinsics, rois)

    def _check_count(fn):
        """Per-camera calibration must match the camera axis EXACTLY on the
        single-device path: _RigCalibration._take's tile fallback exists
        for the batched path (n_local = B·C), and without this check a
        4-camera rig handed 2 per-camera intrinsics would silently
        deproject cameras 2-3 with cameras 0-1's fx/ppx/coeffs/ROI."""
        n_cal = calib.n_cameras
        if n_cal is None:
            return fn

        def checked(depth, color, depth_scale, cam_to_virtual):
            if depth.shape[0] != n_cal:
                raise ValueError(
                    f"rig got {depth.shape[0]} cameras but {n_cal} "
                    "per-camera calibration entries — they must match "
                    "exactly (use batched_rig_fuse for B rigs sharing one "
                    "calibration)"
                )
            return fn(depth, color, depth_scale, cam_to_virtual)

        return checked

    if _rig_render_mode(config) == "tiled":
        _, local_minbufs, unpack_t = _tiled_rig_body(
            calib, fused_intrinsics, config
        )

        @jax.jit
        def fn_tiled(depth, color, depth_scale, cam_to_virtual):
            _, mrgb = local_minbufs(
                depth, color, depth_scale, cam_to_virtual
            )
            return unpack_t(mrgb)

        return _check_count(fn_tiled)

    _, local_buffer, unpack = _packed_rig_body(
        calib, fused_intrinsics, config, z_near, z_far
    )

    @jax.jit
    def fn(depth, color, depth_scale, cam_to_virtual):
        return unpack(local_buffer(depth, color, depth_scale, cam_to_virtual))

    return _check_count(fn)


def rig_fuse_sharded(
    mesh: Mesh,
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    axis: str = "cam",
    z_near: float = 0.25,
    z_far: float = 4.5,
    rois=None,
):
    """Build the jitted camera-sharded rig fusion step.

    Returns ``fn(depth (N,H,W) u16, color (N,H,W,3) u8, depth_scale (N,),
    cam_to_virtual (N,4,4)) -> fused image (Hf, Wf, 3) u8`` with the camera
    axis sharded over ``mesh``; the result is replicated.

    Design: each device folds ALL its local cameras into one flat packed-key
    scatter (vmapping the scatter per camera lowers catastrophically —
    measured 20× slower), then a single ``pmin`` of the packed uint32 buffer
    merges depth AND color across devices in one collective.

    ``config.render_mode == "tiled"`` upgrades the per-device render to the
    bit-exact winner selection and the merge to TWO pmin collectives
    (exact f32 z-bits, then the RGB888 of z-winners — the deterministic
    min-RGB tie-break across devices, same semantics as single-chip).

    ``intrinsics``/``rois`` accept per-camera sequences like
    :func:`rig_fuse`; each shard reads its own cameras' calibration by
    mesh position (``axis_index``-offset slices of the replicated
    calibration leaves).
    """
    calib = _RigCalibration(intrinsics, rois)

    def _check_camera_axis(fn):
        """Per-camera calibration MUST cover the whole camera axis: the
        traced axis_index offsets index the GLOBAL calibration leaves, and
        an out-of-range dynamic_slice CLAMPS — shards past the end would
        silently deproject with the last camera's fx/ppx/ROI."""
        n_cal = calib.n_cameras
        if n_cal is None:
            return fn

        def checked(depth, color, depth_scale, cam_to_virtual):
            if depth.shape[0] != n_cal:
                raise ValueError(
                    f"sharded rig got {depth.shape[0]} cameras but "
                    f"{n_cal} per-camera calibration entries — they must "
                    "match exactly (axis_index offsets index the global "
                    "calibration axis)"
                )
            return fn(depth, color, depth_scale, cam_to_virtual)

        return checked

    def _cam_offset(n_local):
        # First global camera of this shard: shard i holds cameras
        # [i·C_local, (i+1)·C_local). Only needed for per-camera leaves.
        if not calib.per_camera:
            return None
        return jax.lax.axis_index(axis) * n_local

    if _rig_render_mode(config) == "tiled":
        if not config.emit_zbuf:
            # The camera-sharded merge is TWO pmin collectives over
            # per-device (min-z, rgb-of-winner) buffers — the z output is
            # what lets a device's winner lose to a closer camera on another
            # device. (A single-pmin packed z|rgb merge would need 31 z bits
            # + 24 rgb bits > 32, and i64 collectives are out with
            # jax_enable_x64 off.) Refuse rather than silently ignore a
            # request for no z-buffer.
            raise ValueError(
                "rig_fuse_sharded(tiled) cannot honor emit_zbuf=False: the "
                "cross-device merge pmins per-device min-z buffers. Use "
                "emit_zbuf=True for sharded rigs."
            )
        _, local_minbufs, unpack_t = _tiled_rig_body(
            calib, fused_intrinsics, config
        )

        def per_device_tiled(depth, color, depth_scale, cam_to_virtual):
            minz, mrgb = local_minbufs(
                depth, color, depth_scale, cam_to_virtual,
                cam_offset=_cam_offset(depth.shape[0]),
            )
            # Exact two-collective merge: global min z-bits, then min RGB
            # among the devices holding that winner depth.
            gz = jax.lax.pmin(minz, axis)
            cand = jnp.where(minz == gz, mrgb, R.NO_WINNER)
            grgb = jax.lax.pmin(cand, axis)
            return unpack_t(grgb)

        fn_t = shard_map(
            per_device_tiled,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=P(),
        )
        return _check_camera_axis(jax.jit(fn_t))

    _, local_buffer, unpack = _packed_rig_body(
        calib, fused_intrinsics, config, z_near, z_far
    )

    def per_device(depth, color, depth_scale, cam_to_virtual):
        # Local shard shapes: (C, H, W), (C, H, W, 3), (C,), (C, 4, 4).
        local = local_buffer(depth, color, depth_scale, cam_to_virtual,
                             cam_offset=_cam_offset(depth.shape[0]))
        # One collective merges depth + color (key order = z-major).
        merged = jax.lax.pmin(local, axis)
        return unpack(merged)

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),  # replicated fused image
    )
    return _check_camera_axis(jax.jit(fn))


def batched_rig_fuse(
    intrinsics,
    fused_intrinsics: Intrinsics,
    config: FusionConfig,
    batch: int,
    cameras: int,
    z_near: float = 0.25,
    z_far: float = 4.5,
    rois=None,
):
    """Throughput mode: fuse B independent rigs (streams) in one program.

    ``intrinsics``/``rois``: shared, or per-camera sequences of length
    ``cameras`` (every stream fuses the same physical rig — the traced
    calibration leaves tile across the batch).

    Every stream scatters into its own slice of ONE flat (B·H·W,) buffer
    by offsetting pixel indices with ``b·H·W`` — a single scatter for the
    whole batch, same trick as the camera fold.

    Returns ``fn(depth (B,C,H,W) u16, color (B,C,H,W,3) u8,
    depth_scale (B,C), cam_to_virtual (B,C,4,4)) -> (B, Hf, Wf, 3) u8``.

    ``config.render_mode == "tiled"``: the same buffer-slice trick feeds the
    bit-exact render — ONE winner selection over all B·C cameras' entries
    against a (B·H·W)-pixel output.
    """
    calib = _RigCalibration(intrinsics, rois)
    if calib.n_cameras is not None and calib.n_cameras != cameras:
        raise ValueError(
            f"batched rig got {calib.n_cameras} per-camera calibration "
            f"entries for cameras={cameras} — every stream fuses the same "
            "physical rig, so the calibration must cover exactly one rig"
        )
    n_px = fused_intrinsics.width * fused_intrinsics.height
    h_f, w_f = fused_intrinsics.height, fused_intrinsics.width
    stream_offsets = jnp.repeat(
        jnp.arange(batch, dtype=jnp.int32) * n_px, cameras
    )  # (B·C,)

    if _rig_render_mode(config) == "tiled":
        entries_all, _, _ = _tiled_rig_body(
            calib, fused_intrinsics, config
        )
        total_px = batch * n_px

        @jax.jit
        def fn_tiled(depth, color, depth_scale, cam_to_virtual):
            # ONE hand-batched prep chain over all B·C streams (the same
            # entries_all the rig path uses), each stream routed into its
            # own slice of the flat (B·n_px) output via pix_offsets.
            h, w = depth.shape[-2:]
            color_flat = (
                color.reshape(batch * cameras, h, w)
                if color.ndim == depth.ndim  # pre-packed rgb24 planes
                else color.reshape(batch * cameras, h, w, 3)
            )
            p, z, rr = entries_all(
                depth.reshape(batch * cameras, h, w),
                color_flat,
                depth_scale.reshape(-1),
                cam_to_virtual.reshape(batch * cameras, 4, 4),
                pix_offsets=stream_offsets,
            )
            _, mrgb = R.resolve_winners(p, z, rr, total_px)
            covered = mrgb != jnp.int32(R.NO_WINNER)
            rp, gp, bp = R.decode_winner_planes(covered, mrgb)
            return _finish_batch_planes(rp, gp, bp, config, batch, h_f, w_f)

        return fn_tiled

    project_one, _, _ = _packed_rig_body(
        calib, fused_intrinsics, config, z_near, z_far
    )
    sentinel = jnp.uint32(0xFFFFFFFF)

    @jax.jit
    def fn(depth, color, depth_scale, cam_to_virtual):
        idxs, keys = [], []
        for b in range(batch):
            for ci in range(cameras):
                idx, key = project_one(
                    depth[b, ci], color[b, ci], depth_scale[b, ci],
                    cam_to_virtual[b, ci],
                    intr1=calib.at(ci), roi1=calib.roi_at(ci),
                )
                # Offset each stream into its own buffer slice; invalid
                # entries (key == sentinel) go to the shared dump slot.
                ok = key != sentinel
                flat = jnp.where(
                    ok.reshape(-1), idx.reshape(-1) + b * n_px, batch * n_px
                )
                idxs.append(flat)
                keys.append(key.reshape(-1))
        idx = jnp.concatenate(idxs)
        key = jnp.concatenate(keys)
        buf = jnp.full((batch * n_px + 1,), sentinel, jnp.uint32)
        buf = buf.at[idx].min(key, mode="drop")
        merged = buf[: batch * n_px]
        rp, gp, bp = _decode_rgb666_planes(merged)
        return _finish_batch_planes(rp, gp, bp, config, batch, h_f, w_f)

    return fn


def _finish_batch_planes(rp, gp, bp, config: FusionConfig, batch, h_f, w_f):
    """Per-stream fused-image tail for the batched rig: each stream's image
    filters independently (a 3×3 filter over a stacked (B·H, W) plane would
    bleed across stream boundaries). B is small and static — the unrolled
    loop stays one executable."""
    rp = rp.reshape(batch, h_f, w_f)
    gp = gp.reshape(batch, h_f, w_f)
    bp = bp.reshape(batch, h_f, w_f)
    if not config.filter_fused_color:
        return jnp.stack([rp, gp, bp], axis=-1)
    return jnp.stack(
        [
            _finish_planes(rp[i], gp[i], bp[i], config)
            for i in range(batch)
        ]
    )
