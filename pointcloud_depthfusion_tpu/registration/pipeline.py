"""Registration service: continuous right→left transform estimation.

Host-side orchestration equivalent of RegistrationNode
(registration_node/src/registration_node.cpp): consumes synchronized
depth-frame pairs at a low cadence, runs the VGICP solver with warm starts,
gates implausible results, anneals resolution during the initial phase, and
persists the calibration transform.

The per-tick device work (filter → deproject → solve) is one jitted program;
the gating/annealing state machine stays in Python (it runs at 0.5 Hz and
mutates configuration).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_depthfusion_tpu.core import geometry as G
from pointcloud_depthfusion_tpu.core.camera import Intrinsics
from pointcloud_depthfusion_tpu.ops import filters as F
from pointcloud_depthfusion_tpu.registration.gicp import (
    GICPConfig,
    GICPResult,
    gicp_register,
    gicp_register_prepared,
    prepare_target,
)

Array = jax.Array


@dataclasses.dataclass
class RegistrationSettings:
    """registration_node/config/config_default.yaml equivalents."""

    min_depth: float = 0.5
    max_depth: float = 3.0
    depth_scale_left: float = 0.001
    depth_scale_right: float = 0.001
    roi_left: Optional[Tuple[int, int, int, int]] = None
    roi_right: Optional[Tuple[int, int, int, int]] = None

    # Solver (config_default.yaml:15-29)
    resolution: float = 0.01
    voxelsize: float = 0.01
    kernel_width: float = 0.005
    kernel_max_dist: float = 0.025
    max_iterations: int = 64  # scan length per tick; 1000 in the reference
    rotation_epsilon: float = 2e-3
    translation_epsilon: float = 1e-4
    fitness_epsilon: float = 1e-12
    table_size: int = 1 << 15
    # Correspondence model: "direct1" (one voxel per point, the classic
    # default) or "direct7"/"direct27" (fast_gicp-style multi-voxel
    # neighbor accumulation — wider convergence basin at ~N× lookup cost
    # per iteration; see GICPConfig.neighbor_search).
    neighbor_search: str = "direct1"

    # Sparse-outlier pre-filter (PCL StatisticalOutlierRemoval equivalent;
    # declared-but-unused in the reference hot path, registration.cpp:
    # 156-163). Off by default, matching the reference. The resolution is
    # the locality scale standing in for PCL's mean_k neighbor count.
    outlier_removal: bool = False
    outlier_resolution: float = 0.05
    outlier_stddev_mul: float = 1.0

    # Gating / annealing (registration_node.cpp:363-407, :485-530)
    discard_transform: bool = True
    # The Euler-angle half of the discard gate encodes the reference's
    # STEREO-PAIR mounting prior: two near-parallel cameras, so a solved
    # right→left rotation with |euler_y| ≥ 2° is implausible
    # (registration_node.cpp:363-393). A converging N-camera rig violates
    # that prior BY CONSTRUCTION (adjacent toe-in is the whole point), so
    # the rig tier disables the angle gate while keeping the
    # fitness-regression gate + decay (the half that generalizes).
    angle_gate: bool = True
    reset_initial_guess: bool = True
    adjust_resolution: bool = True
    initial_resolution: float = 0.1
    resolution_step: float = 0.05
    voxel_resolution_factor: float = 0.1
    cam_upside_down: bool = False

    # Persistence (registration_node.cpp:96-105, :742-833)
    transform_path: Optional[str] = None
    load_transform: bool = False
    save_transform: bool = False

    # Debug cloud publication (registration_node.cpp:410-427: the
    # /registration/target_points + /registration/aligned_points taps)
    publish_clouds: bool = False

    # Target-grid caching: rebuild the target distribution grid every N
    # ticks instead of every tick (the scene is mostly static at the 0.5 Hz
    # cadence; re-voxelizing both clouds dominated the warm solve). 1 =
    # rebuild always (reference behavior, registration.cpp:67-71). The grid
    # is also rebuilt whenever resolution/voxel size change (annealing).
    target_grid_cache_ticks: int = 4
    # Stride-decimate the depth image before deprojection (1 = off). The
    # registration clouds only feed a >= 5 mm ApproximateVoxelGrid
    # (config_default.yaml:23: voxelsize 0.01, annealing floor 0.005): a
    # D455 pixel subtends ~1.6 mm at 1 m, so every voxel still pools >= 9
    # points after 2x decimation while the 12 scatter-adds of the grid
    # build — the dominant cost of every solve — shrink 4x. The reference
    # deprojects full frames and pays the full PCL voxel pass per solve
    # (registration_node.cpp:312-333, registration.cpp:67-71).
    cloud_decimation: int = 2


@dataclasses.dataclass
class RegistrationTelemetry:
    """Per-tick profiling row (registration profiling CSV schema:
    euclidean_fitness, icp_duration, points_target, points_source)."""

    fitness: float
    icp_ms: float
    target_points: int
    source_points: int
    discarded: bool
    guess_reset: bool
    target_grid_rebuilt: bool = True
    iterations: int = 0  # Gauss-Newton iterations until convergence/cap


class RegistrationPipeline:
    """Continuous right→left extrinsic calibration."""

    def __init__(
        self,
        intrinsics_left: Intrinsics,
        intrinsics_right: Intrinsics,
        settings: Optional[RegistrationSettings] = None,
    ):
        self.settings = settings or RegistrationSettings()
        self.intr_left = intrinsics_left
        self.intr_right = intrinsics_right

        s = self.settings
        # cam_upside_down → initial guess 180° about Z
        # (registration_node.cpp:153-160).
        start = np.eye(4, dtype=np.float32)
        if s.cam_upside_down:
            # Host-side numpy, deliberately NOT G.euler_to_matrix: no eager
            # device dispatches at construction time, and a 180° Z rotation
            # is exact in numpy.
            start[:3, :3] = np.asarray(
                [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                np.float32,
            )
        self.start_transform = start
        self.initial_transform = start.copy()
        self.last_transform = start.copy()
        self.best_fitness = np.inf
        # "Initial phase" = the coarse→fine annealing window; with
        # adjust_resolution off there is no annealing, so every tick is a
        # steady-state (warm-criteria) tick from the start.
        self.initial_phase = bool(s.adjust_resolution)
        self.current_resolution = s.initial_resolution if s.adjust_resolution else s.resolution
        self.current_voxelsize = (
            max(s.voxelsize, s.voxel_resolution_factor * self.current_resolution)
            if s.adjust_resolution
            else s.voxelsize
        )
        self.telemetry: list[RegistrationTelemetry] = []
        self.debug_clouds: Optional[dict] = None

        if s.load_transform and s.transform_path:
            loaded = load_transform_file(s.transform_path)
            if loaded is not None:
                self.initial_transform = loaded
                self.last_transform = loaded.copy()

        self._solve_cache: dict = {}
        # Cached target grid: (cache key, device VoxelGrid, ticks since build)
        self._tgt_grid_key = None
        self._tgt_grid = None
        self._tgt_grid_age = 0
        # True once a tick completed without a guess reset (the next solve
        # warm-starts from a converged transform).
        self._warm_start = False
        self._left_count = 0  # target point count from the last grid build

    # -- device programs ---------------------------------------------------

    def _cloud_fn(self, which: str):
        # Cache jitted programs per (side, settings-they-close-over) in an
        # instance dict: an lru_cache on the bound method would pin `self`
        # (and every jitted program) for process lifetime AND freeze the
        # depth-window/ROI settings captured at first call.
        intr = self.intr_left if which == "left" else self.intr_right
        roi = self.settings.roi_left if which == "left" else self.settings.roi_right
        s = self.settings
        k = max(1, int(s.cloud_decimation))
        key = (which, s.min_depth, s.max_depth, roi, k,
               s.outlier_removal, s.outlier_resolution, s.outlier_stddev_mul,
               s.table_size)
        cached = self._solve_cache.get(key)
        if cached is not None:
            return cached

        # Strided pixel (r, c) is original pixel (r·k, c·k); dividing
        # fx/fy/ppx/ppy by k makes deprojection of the strided plane exact.
        intr_k = dataclasses.replace(
            intr,
            fx=intr.fx / k, fy=intr.fy / k, ppx=intr.ppx / k, ppy=intr.ppy / k,
            width=-(-intr.width // k), height=-(-intr.height // k),
        )

        @jax.jit
        def to_cloud(depth_u16, depth_scale):
            d, valid = F.filter_depth(
                depth_u16, depth_scale, s.min_depth, s.max_depth, roi
            )
            d = d[::k, ::k]
            valid = valid[::k, ::k]
            pts, valid = G.deproject(
                d.astype(jnp.float32) * depth_scale, intr_k, valid
            )
            pts = pts.reshape(-1, 3)
            valid = valid.reshape(-1)
            if s.outlier_removal:
                from pointcloud_depthfusion_tpu.ops.voxel import (  # noqa: PLC0415
                    statistical_outlier_removal,
                )

                valid = statistical_outlier_removal(
                    pts, valid, s.outlier_resolution,
                    s.outlier_stddev_mul, s.table_size,
                )
            # valid-point count rides along as a fused scalar: an eager
            # jnp.sum for telemetry costs a full extra dispatch + D2H
            # round-trip per tick.
            return pts, valid, jnp.sum(valid)

        self._solve_cache[key] = to_cloud
        return to_cloud

    def _jitted(self, fn):
        """One jax.jit wrapper per raw function, cached on the instance.

        The whole tick (voxelize → moments → while_loop solve) runs as one
        XLA program per call instead of dozens of eager dispatches.
        """
        key = ("jit", fn)
        wrapped = self._solve_cache.get(key)
        if wrapped is None:
            wrapped = jax.jit(fn)
            self._solve_cache[key] = wrapped
        return wrapped

    def _make_config(self) -> GICPConfig:
        s = self.settings
        # Kernel parameters follow the active resolution — the reference's
        # setResolution rule (kernel_width = res/2, max_dist = 2.5·res,
        # registration_node.cpp:859-865). Keeping a fine kernel_width during
        # coarse annealing zeroes the long-range correspondence weights and
        # stalls the solver (measured: stuck at 0.34 m error).
        kernel_width = self.current_resolution / 2.0
        kernel_max_dist = 2.5 * self.current_resolution
        # Damping follows the active annealing scale (heavier Gauss-Newton
        # damping while voxels are coarse, like default_multiscale_configs;
        # 0.25·res hits the 0.01 floor at the 0.04 m default resolution and
        # 0.025 at the 0.1 m annealing start).
        damping = float(np.clip(0.25 * self.current_resolution, 0.01, 0.1))
        # Warm (post-annealing, warm-started) ticks enable the relative
        # fitness-plateau exit: in f32 the step norms jitter just above the
        # strict absolute epsilons and warm solves would burn the full
        # iteration budget (48 capped iterations vs 3 with the plateau).
        # Cold solves (first tick, after a guess reset,
        # or during annealing) keep it off: they can stall for a few
        # iterations before improving (measured 0.39 m premature stop).
        warm = not self.initial_phase and self._warm_start
        fitness_rel_eps = 5e-3 if warm else 0.0
        # Cold-anneal budget: a coarse annealing tick only has to land in
        # the next (finer) tick's basin, so its step epsilons scale with the
        # active resolution (res/100 translation, 1e-2 rad rotation) and its
        # iteration budget is hard-capped — both TRACED knobs, so every tick
        # (annealing and steady-state) shares ONE compiled solver. Measured:
        # identical final transform on the golden pair, cold anneal ≪ the
        # old 162-iteration total.
        annealing = self.initial_phase and (
            self.current_resolution > s.resolution
        )
        if annealing:
            rotation_eps = max(s.rotation_epsilon, 1e-2)
            translation_eps = max(
                s.translation_epsilon, self.current_resolution / 100.0
            )
            iteration_cap = min(s.max_iterations, 16)
        else:
            rotation_eps = s.rotation_epsilon
            translation_eps = s.translation_epsilon
            iteration_cap = s.max_iterations
        return GICPConfig.create(
            fitness_rel_eps=fitness_rel_eps,
            resolution=self.current_resolution,
            voxel_size=self.current_voxelsize,
            rotation_eps=rotation_eps,
            translation_eps=translation_eps,
            fitness_eps=s.fitness_epsilon,
            kernel_width=kernel_width,
            kernel_max_dist=kernel_max_dist,
            max_iterations=s.max_iterations,
            iteration_cap=iteration_cap,
            table_size=s.table_size,
            damping=damping,
            neighbor_search=s.neighbor_search,
        )

    # -- the per-tick entry point -----------------------------------------

    def tick(
        self,
        depth_left_u16,
        depth_right_u16,
        depth_scale_left: Optional[float] = None,
        depth_scale_right: Optional[float] = None,
    ) -> np.ndarray:
        """One registration tick: returns the current right→left 4×4.

        Left is the target, right the source (the published transform maps
        right-camera points into the left frame,
        registration_node.cpp:532-545).

        ``depth_scale_left``/``depth_scale_right``: the frames' actual
        m/LSB scales, overriding the settings defaults — callers holding
        HostFramesets MUST pass the per-frame scales (a sensor at 1e-4
        m/unit deprojects 10× wrong under the 0.001 default, silently:
        the solve is then fitness-gated forever or converges to garbage).
        Traced jit arguments, so varying scales never recompile.
        """
        import time

        s = self.settings
        t0 = time.perf_counter()
        scale_l = (
            s.depth_scale_left if depth_scale_left is None
            else float(depth_scale_left)
        )
        scale_r = (
            s.depth_scale_right if depth_scale_right is None
            else float(depth_scale_right)
        )

        depth_left_u16 = np.asarray(depth_left_u16)
        depth_right_u16 = np.asarray(depth_right_u16)
        for name, d, intr in (
            ("left", depth_left_u16, self.intr_left),
            ("right", depth_right_u16, self.intr_right),
        ):
            if d.shape != (intr.height, intr.width):
                raise ValueError(
                    f"{name} depth {d.shape} does not match the registered "
                    f"intrinsics ({intr.height}, {intr.width}) — decimated "
                    "depth streams cannot feed the registration service"
                )

        right_cloud, right_valid, right_count = self._cloud_fn("right")(
            jnp.asarray(depth_right_u16, jnp.uint16),
            jnp.asarray(scale_r, jnp.float32),
        )

        config = self._make_config()

        # Target grid: rebuild on resolution/voxel change or every
        # `target_grid_cache_ticks` ticks; reuse otherwise (the scene is
        # static between 0.5 Hz ticks — rebuilding dominated the warm solve).
        grid_key = (
            float(self.current_resolution),
            float(self.current_voxelsize),
            s.table_size,
            float(scale_l),  # a scale change invalidates the cached grid
        )
        rebuild = (
            self._tgt_grid is None
            or self._tgt_grid_key != grid_key
            or self._tgt_grid_age >= max(1, s.target_grid_cache_ticks)
        )
        # The left (target) cloud program — including its ~0.8 MB depth
        # upload — only runs when the grid is rebuilt or the debug cloud
        # tap needs it; cache-hit ticks reuse the cached point count.
        if rebuild or s.publish_clouds:
            left_cloud, left_valid, left_count = self._cloud_fn("left")(
                jnp.asarray(depth_left_u16, jnp.uint16),
                jnp.asarray(scale_l, jnp.float32),
            )
            self._left_count = int(left_count)
        else:
            left_cloud = left_valid = None
        left_count = self._left_count
        if rebuild:
            self._tgt_grid = self._jitted(prepare_target)(
                left_cloud, left_valid, config
            )
            self._tgt_grid_key = grid_key
            self._tgt_grid_age = 0
        self._tgt_grid_age += 1

        result: GICPResult = self._jitted(gicp_register_prepared)(
            right_cloud,
            right_valid,
            self._tgt_grid,
            jnp.asarray(self.initial_transform, jnp.float32),
            config,
        )
        # ONE batched device→host fetch for everything this tick reads:
        # each separate np.asarray/float()/int() is its own D2H round-trip
        # (the same cost the cloud program fuses its point count to
        # avoid).
        final, fitness, iterations, right_count = jax.device_get(
            (result.transform, result.fitness, result.iterations, right_count)
        )
        final = np.asarray(final, np.float64)
        fitness = float(fitness)
        icp_ms = (time.perf_counter() - t0) * 1e3

        discarded = False
        guess_reset = False

        # --- transform gating (registration_node.cpp:363-393) -----------
        if s.discard_transform:
            angles_fit = (
                not s.angle_gate
                or transform_angles_fit(final, s.cam_upside_down)
            )
            if fitness < self.best_fitness and angles_fit:
                self.best_fitness = fitness
            else:
                final = self.initial_transform.astype(np.float64)
                self.best_fitness *= 1.5  # decay escape hatch
                discarded = True

        # --- guess reset (registration_node.cpp:396-407) -----------------
        if s.reset_initial_guess:
            if fitness > self.current_resolution * 10.0:
                final = self.start_transform.astype(np.float64)
                guess_reset = True

        self.last_transform = final.astype(np.float32)
        self.initial_transform = final.astype(np.float32)  # warm start
        self._warm_start = not guess_reset

        # Debug cloud taps: target + aligned source, compacted to valid
        # points on host (registration_node.cpp:410-427 equivalents).
        if s.publish_clouds:
            tgt = np.asarray(left_cloud)[np.asarray(left_valid)]
            src = np.asarray(right_cloud)[np.asarray(right_valid)]
            aligned = src @ final[:3, :3].T.astype(src.dtype) + final[:3, 3].astype(
                src.dtype
            )
            self.debug_clouds = dict(target=tgt, aligned=aligned)

        # --- resolution annealing (registration_node.cpp:485-530) --------
        if s.adjust_resolution and self.initial_phase:
            if self.current_resolution - s.resolution_step > s.resolution:
                self.current_resolution -= s.resolution_step
            else:
                self.current_resolution = s.resolution
            if (
                self.current_resolution * s.voxel_resolution_factor
                > s.voxelsize
            ):
                self.current_voxelsize = (
                    s.voxel_resolution_factor * self.current_resolution
                )
            else:
                self.current_voxelsize = s.voxelsize
            if (
                self.current_resolution <= s.resolution
                and self.current_voxelsize <= s.voxelsize
            ):
                self.initial_phase = False

        self.telemetry.append(
            RegistrationTelemetry(
                fitness=fitness,
                icp_ms=icp_ms,
                target_points=int(left_count),
                source_points=int(right_count),
                discarded=discarded,
                guess_reset=guess_reset,
                target_grid_rebuilt=rebuild,
                iterations=int(iterations),
            )
        )
        return self.last_transform

    def seed(self, transform: np.ndarray) -> None:
        """Adopt a trusted external transform as the current calibration.

        The next tick WARM-starts from it with the cold annealing phase
        skipped — the reference's load_transform workflow
        (registration_node.cpp:742-833), where a persisted transform is
        refined by subsequent solves, never re-derived from scratch. The
        fitness gate / guess-reset machinery still applies, so a stale
        seed degrades to a normal cold solve instead of sticking."""
        t = np.asarray(transform, np.float32).reshape(4, 4)
        self.initial_transform = t.copy()
        self.last_transform = t.copy()
        self._warm_start = True
        self.initial_phase = False
        self.current_resolution = self.settings.resolution
        self.current_voxelsize = self.settings.voxelsize

    def close(self) -> None:
        s = self.settings
        if s.save_transform and s.transform_path:
            save_transform_file(s.transform_path, self.last_transform)

    def write_profiling_csv(self, path: str) -> None:
        """CSV with the reference schema (registration_node.cpp:429-460)."""
        with open(path, "w") as fh:
            fh.write(
                "euclidean_fitness,icp_duration,points_target,points_source,"
                "target_grid_rebuilt\n"
            )
            for row in self.telemetry:
                fh.write(
                    f"{row.fitness},{row.icp_ms},{row.target_points},"
                    f"{row.source_points},{int(row.target_grid_rebuilt)}\n"
                )


# --------------------------------------------------------------------------
# Transform persistence (whitespace-separated 4×4 text, like
# registration_node.cpp:742-833)
# --------------------------------------------------------------------------


def transform_angles_fit(final: np.ndarray, cam_upside_down: bool) -> bool:
    """Gate a solved right→left transform by its Euler angles
    (registration_node.cpp:363-393).

    Host-side euler extraction (registration.cpp:179-185 extractEulerAngles
    semantics) — ``final`` is a 4×4 numpy matrix; a device op here would be
    a pointless dispatch + D2H round-trip per tick.

    Deviation from the reference, documented: for an upside-down mount the
    expected rotation is ~180° about the optical (z) axis, which this euler
    convention reports as euler_z ≈ ±180. The reference widens the Y limit
    to 178 (registration_node.cpp:368), but euler_y = -asin(r20) is bounded
    to ±90 so that widening is dead, and |euler_z| ≈ 180 still fails the
    2° z-limit — upstream, cam_upside_down discards EVERY solve. We apply
    the evident intent instead: accept z rotations within 2° of 180.
    """
    x_lim, y_lim, z_lim = 30.0, 2.0, 2.0
    r_m = final[:3, :3]
    euler = np.rad2deg(
        np.asarray(
            [
                np.arctan2(r_m[2, 1], r_m[2, 2]),
                -np.arcsin(np.clip(r_m[2, 0], -1.0, 1.0)),
                np.arctan2(r_m[1, 0], r_m[0, 0]),
            ]
        )
    )
    z_dev = 180.0 - abs(euler[2]) if cam_upside_down else abs(euler[2])
    return (
        abs(euler[0]) < x_lim and abs(euler[1]) < y_lim and z_dev < z_lim
    )


def save_transform_file(path: str, transform: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, np.asarray(transform, np.float64).reshape(4, 4))


def load_transform_file(path: str) -> Optional[np.ndarray]:
    """Load a 4×4; identity fallback on failure matches the reference."""
    try:
        m = np.loadtxt(path).reshape(4, 4).astype(np.float32)
        if not np.all(np.isfinite(m)):
            return None
        return m
    except Exception:
        return None
