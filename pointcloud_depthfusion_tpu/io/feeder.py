"""Host-side streaming fabric: sources, temporal pairing, async device feed.

This is the replacement for the reference's ROS2/DDS transport
(SURVEY.md §2.8): typed topics become Python callbacks/queues, the
ApproximateTime message filter becomes :class:`ApproximateTimePairer`, and
the double-buffered capture loop (camera_node.cpp:315-333) becomes
:class:`DeviceFeeder`, a background thread that uploads the next host frame
pair while the device computes on the current one.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Deque, Iterator, List, Optional, Tuple

import jax
import numpy as np

from pointcloud_depthfusion_tpu.core.camera import Intrinsics
from pointcloud_depthfusion_tpu.core.frameset import (
    Frameset,
    HostFrameset,
    pack_rgb24_host,
)
from pointcloud_depthfusion_tpu.io.synthetic import SyntheticScene


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------


class FramesetSource:
    """A stream of HostFramesets (the capture-device abstraction).

    Implementations: SyntheticSource (parametric scene), RecordedSource
    (npz dataset, io/recorded.py). A real-sensor backend would slot in here;
    live USB capture runs on camera hosts (io/realsense_host.py).
    """

    def next_frame(self) -> Optional[HostFrameset]:
        raise NotImplementedError

    @property
    def intrinsics(self) -> Intrinsics:
        raise NotImplementedError


class SyntheticSource(FramesetSource):
    """Deterministic synthetic stream with optional per-frame camera motion
    and timestamp jitter (models real sensors' non-ideal cadence)."""

    def __init__(
        self,
        scene: SyntheticScene,
        intr: Intrinsics,
        world_from_cam: np.ndarray,
        fps: float = 30.0,
        depth_noise_std: float = 0.002,
        hole_fraction: float = 0.01,
        timestamp_jitter_s: float = 0.0,
        motion: Optional[Callable[[int], np.ndarray]] = None,
        seed: int = 0,
        start_time: float = 0.0,
    ):
        self.scene = scene
        self._intr = intr
        self.pose = np.asarray(world_from_cam)
        self.fps = fps
        self.depth_noise_std = depth_noise_std
        self.hole_fraction = hole_fraction
        self.jitter = timestamp_jitter_s
        self.motion = motion
        self.rng = np.random.default_rng(seed)
        self.frame_idx = 0
        self.start_time = start_time

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    def sensor_options(self) -> dict:
        """Source-level options reflected into the parameter tree by
        CameraNode.attach_config (the synthetic sensor's analogue of rs2
        sensor options like laser power / exposure)."""
        return {
            "depth": {
                "depth_noise_std": self.depth_noise_std,
                "hole_fraction": self.hole_fraction,
            },
            "color": {
                "jitter": self.jitter,  # timestamp jitter (s)
            },
        }

    def next_frame(self) -> HostFrameset:
        t = self.start_time + self.frame_idx / self.fps
        if self.jitter > 0:
            t += float(self.rng.normal(0, self.jitter))
        pose = self.motion(self.frame_idx) if self.motion else self.pose
        fs = self.scene.render(
            self._intr,
            pose,
            timestamp=t,
            depth_noise_std=self.depth_noise_std,
            hole_fraction=self.hole_fraction,
            seed=int(self.rng.integers(0, 2**31)),
        )
        self.frame_idx += 1
        return fs


class NativeSyntheticSource(SyntheticSource):
    """SyntheticSource backed by the C++ OpenMP renderer (runtime/): ~17×
    the numpy renderer's throughput (15 ms vs 260 ms at 848×480), bit-exact
    on noise-free frames. Noise/hole patterns use a different (xorshift) RNG
    than numpy — statistically equivalent, not bit-identical."""

    def next_frame(self) -> HostFrameset:
        from pointcloud_depthfusion_tpu.runtime import (  # noqa: PLC0415
            is_available,
            render_scene_native,
        )

        if not is_available():  # pragma: no cover - env without toolchain
            return super().next_frame()
        t = self.start_time + self.frame_idx / self.fps
        if self.jitter > 0:
            t += float(self.rng.normal(0, self.jitter))
        pose = self.motion(self.frame_idx) if self.motion else self.pose
        scene = self.scene
        spheres = np.asarray(
            [
                [s.center[0], s.center[1], s.center[2], s.radius, *s.base_color]
                for s in scene.spheres
            ]
        )
        depth, color = render_scene_native(
            self._intr.width,
            self._intr.height,
            float(self._intr.fx),
            float(self._intr.fy),
            float(self._intr.ppx),
            float(self._intr.ppy),
            np.asarray(pose),
            scene.plane_z,
            spheres,
            scene.checker_period,
            scene.max_depth,
            0.001,
            noise_std=self.depth_noise_std,
            hole_fraction=self.hole_fraction,
            seed=int(self.rng.integers(0, 2**62)),
        )
        self.frame_idx += 1
        return HostFrameset(depth=depth, color=color, timestamp=t, depth_scale=0.001)


# ---------------------------------------------------------------------------
# ApproximateTime pairing
# ---------------------------------------------------------------------------


class ApproximateTimePairer:
    """Pair two timestamped streams, emitting the closest-stamp pairs.

    Semantics follow message_filters ApproximateTime as configured by the
    reference (queue 10, max interval 17 ms, fusion_node.cpp:221-228):
    bounded per-stream queues drop the oldest entry; a pair is emitted when
    the best available match is within ``max_interval_s``, consuming both
    entries and everything older.
    """

    def __init__(self, max_interval_s: float = 0.017, queue_size: int = 10):
        self.max_interval_s = max_interval_s
        self.queue_size = queue_size
        self.queues: Tuple[Deque[HostFrameset], Deque[HostFrameset]] = (
            collections.deque(),
            collections.deque(),
        )
        self.dropped = 0
        self.emitted = 0

    def push(self, stream: int, frame: HostFrameset) -> List[Tuple[HostFrameset, HostFrameset]]:
        """Add a frame; returns zero or more matched pairs."""
        q = self.queues[stream]
        q.append(frame)
        if len(q) > self.queue_size:
            q.popleft()
            self.dropped += 1
        return self._drain()

    def _drain(self) -> List[Tuple[HostFrameset, HostFrameset]]:
        out = []
        qa, qb = self.queues
        while qa and qb:
            # Globally closest pair across both queues (an exhaustive
            # O(|qa|·|qb|) scan per emission — at the configured queue size
            # of 10 that is ≤100 stamp comparisons, far below the cost of
            # one frame; message_filters' incremental pivot algorithm would
            # only matter at much larger queues/rates).
            best = None
            best_dt = None
            for i, fa in enumerate(qa):
                for j, fb in enumerate(qb):
                    dt = abs(fa.timestamp - fb.timestamp)
                    if best_dt is None or dt < best_dt:
                        best_dt = dt
                        best = (i, j)
            if best is None or best_dt is None or best_dt > self.max_interval_s:
                # If queues are saturated with unmatchable data, drop the
                # oldest overall to make progress.
                if len(qa) >= self.queue_size or len(qb) >= self.queue_size:
                    (qa if qa[0].timestamp <= qb[0].timestamp else qb).popleft()
                    self.dropped += 1
                    continue
                break
            i, j = best
            fa, fb = qa[i], qb[j]
            for _ in range(i + 1):
                qa.popleft()
            for _ in range(j + 1):
                qb.popleft()
            self.dropped += i + j
            self.emitted += 1
            out.append((fa, fb))
        return out


class ApproximateTimeSyncN:
    """N-way ApproximateTime synchronization (message_filters semantics
    generalized past two streams — the reference only ever pairs two, but an
    N-camera rig needs the same gate across all N frameset topics).

    A set is emitted when one frame per stream can be chosen with total
    stamp SPREAD (max−min) ≤ ``max_interval_s``; emission consumes the
    chosen frames and everything older in each queue. Selection: pivot on
    the latest queue head, pick each stream's closest frame to the pivot —
    the same greedy that message_filters' ApproximateTime policy uses.
    """

    def __init__(self, n_streams: int, max_interval_s: float = 0.017,
                 queue_size: int = 10):
        if n_streams < 2:
            raise ValueError(f"need >= 2 streams, got {n_streams}")
        self.n_streams = n_streams
        self.max_interval_s = max_interval_s
        self.queue_size = queue_size
        self.queues: List[Deque[HostFrameset]] = [
            collections.deque() for _ in range(n_streams)
        ]
        self.dropped = 0
        self.emitted = 0

    def push(
        self, stream: int, frame: HostFrameset
    ) -> List[Tuple[HostFrameset, ...]]:
        q = self.queues[stream]
        q.append(frame)
        if len(q) > self.queue_size:
            q.popleft()
            self.dropped += 1
        return self._drain()

    def _drain(self) -> List[Tuple[HostFrameset, ...]]:
        out = []
        while all(self.queues):
            # Pivot: the latest of the queue heads (every stream has data
            # at or after the earlier heads, so no later-arriving frame can
            # beat a choice anchored here).
            pivot = max(q[0].timestamp for q in self.queues)
            picks = []
            for q in self.queues:
                k = min(
                    range(len(q)),
                    key=lambda i: abs(q[i].timestamp - pivot),
                )
                picks.append(k)
            stamps = [
                q[k].timestamp for q, k in zip(self.queues, picks)
            ]
            # Only emit when every pick is FINAL: a pick that is its
            # queue's newest element AND earlier than the pivot could be
            # beaten by the stream's next (monotonically later) frame —
            # wait for it instead of emitting a worse set.
            final = all(
                k < len(q) - 1 or q[k].timestamp >= pivot
                for q, k in zip(self.queues, picks)
            )
            if not final and not any(
                len(q) >= self.queue_size for q in self.queues
            ):
                break
            if max(stamps) - min(stamps) <= self.max_interval_s:
                frames = tuple(q[k] for q, k in zip(self.queues, picks))
                for q, k in zip(self.queues, picks):
                    for _ in range(k + 1):
                        q.popleft()
                    self.dropped += k
                self.emitted += 1
                out.append(frames)
                continue
            # Unmatchable at current fill: drop the globally oldest head to
            # make progress if any queue is saturated, else wait for data.
            if any(len(q) >= self.queue_size for q in self.queues):
                oldest = min(self.queues, key=lambda q: q[0].timestamp)
                oldest.popleft()
                self.dropped += 1
                continue
            break
        return out

    def flush(self) -> List[Tuple[HostFrameset, ...]]:
        """End-of-stream drain: emit remaining within-interval sets with
        the final-pick gate relaxed.

        The gate withholds a set whose picks could be beaten by a stream's
        NEXT frame — at end of stream there is no next frame, so a
        complete, matchable final set would otherwise be silently dropped
        (the 2-stream pairer has no such gate and emits it; the N-way sync
        must match at stream end). Unmatchable heads are discarded to make
        progress, like the saturated-queue path."""
        out = []
        while all(self.queues):
            pivot = max(q[0].timestamp for q in self.queues)
            picks = [
                min(range(len(q)),
                    key=lambda i: abs(q[i].timestamp - pivot))
                for q in self.queues
            ]
            stamps = [q[k].timestamp for q, k in zip(self.queues, picks)]
            if max(stamps) - min(stamps) <= self.max_interval_s:
                out.append(tuple(q[k] for q, k in zip(self.queues, picks)))
                for q, k in zip(self.queues, picks):
                    for _ in range(k + 1):
                        q.popleft()
                    self.dropped += k
                self.emitted += 1
                continue
            oldest = min(self.queues, key=lambda q: q[0].timestamp)
            oldest.popleft()
            self.dropped += 1
        return out


# ---------------------------------------------------------------------------
# Async device feeder (double buffering)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DevicePair:
    left: Frameset
    right: Frameset
    host_left: HostFrameset
    host_right: HostFrameset
    upload_ms: float = 0.0  # H2D time for this pair (the copy_to_gpu stage)
    # Wall clock at enqueue — the QoS-lifespan reference point (a message's
    # age starts when it is published, fusion_node.cpp:183-187).
    enqueue_time: float = 0.0


class _AsyncFeederBase:
    """Shared delivery machinery for background device feeders: bounded
    queue hand-off, end-of-stream sentinel, error propagation, QoS
    lifespan expiry, stop-safe blocking get. Subclasses implement
    ``_run`` (the producer thread) and call :meth:`_deliver` /
    :meth:`_deliver_sentinel`."""

    def _init_delivery(self, depth: int, lifespan_s: Optional[float]) -> None:
        self.lifespan_s = lifespan_s
        self.dropped_stale = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._ended = False
        self.error: Optional[BaseException] = None

    def _run(self) -> None:  # pragma: no cover - subclass responsibility
        raise NotImplementedError

    def _deliver(self, item) -> bool:
        """Bounded put: returns False if stop() preempted the hand-off."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _deliver_sentinel(self, drop_pending: bool = False) -> None:
        """Enqueue the end-of-stream None. The sentinel MUST reach the
        consumer or a later get() with no timeout blocks forever; on the
        error path (``drop_pending``) a pending item is sacrificed to make
        room (we are aborting anyway)."""
        while not self._stop.is_set():
            try:
                self._q.put(None, timeout=0.5)
                return
            except queue.Full:
                if drop_pending:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def get(self, timeout: Optional[float] = None):
        """Next synchronized device-resident item (None = clean end of
        stream). A producer-side failure re-raises HERE - a silently empty
        stream would hide errors like the decimated-depth rejection."""
        if not self._started:
            self.start()
        if self._ended:
            # The producer enqueues ONE sentinel and exits; keep answering
            # None instead of blocking a second end-of-stream get() forever.
            if self.error is not None:
                raise RuntimeError("frameset producer failed") from self.error
            return None
        deadline = (
            None if timeout is None else time.perf_counter() + timeout
        )
        while True:
            # Poll in short slices so an out-of-band stop() (e.g. the
            # viewer-close shutdown hook) unblocks a waiting consumer -
            # stop() drains the queue, so the producer's None sentinel can
            # be lost and a bare blocking get() would hang forever.
            if self._stop.is_set():
                self._ended = True
                return None
            slice_s = 0.2
            if deadline is not None:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise queue.Empty
                slice_s = min(slice_s, remaining)
            try:
                item = self._q.get(timeout=slice_s)
            except queue.Empty:
                continue
            if item is None:
                self._ended = True
                if self.error is not None:
                    raise RuntimeError(
                        "frameset producer failed"
                    ) from self.error
                return None
            if (
                self.lifespan_s is not None
                and time.perf_counter() - item.enqueue_time > self.lifespan_s
            ):
                # QoS lifespan expiry: skip the stale item; the producer is
                # still running, so a fresh one follows.
                self.dropped_stale += 1
                continue
            return item

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # stop() can be invoked FROM the producer thread (a frameset
        # subscriber raising through capture() - e.g. the viewer-close
        # shutdown hook); joining the current thread would raise.
        if self._started and self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __iter__(self):
        while True:
            item = self.get()
            if item is None:
                return
            yield item


class DeviceFeeder(_AsyncFeederBase):
    """Background thread: capture → pair → device_put, one pair ahead.

    The capture/upload of frame N+1 overlaps the device compute of frame N —
    the async analogue of the reference's double-buffered std::async fan-out
    (camera_node.cpp:315-343). ``get()`` blocks for the next ready pair.
    """

    def __init__(
        self,
        source_left: FramesetSource,
        source_right: FramesetSource,
        pairer: Optional[ApproximateTimePairer] = None,
        depth: int = 2,
        device: Optional[jax.Device] = None,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
        upload: bool = True,
    ):
        """``lifespan_s``: drop pairs that sat in the queue longer than this
        before the consumer asked for them — the QoS 1 s message-lifespan
        semantics of the reference's fused-frame subscriptions
        (fusion_node.cpp:183-187). A stalled consumer then resumes on fresh
        data instead of processing arbitrarily stale frames. None disables
        (pull-paced pipelines where the consumer sets the cadence).

        ``pack_color``: also upload ``Frameset.color_packed`` — the rgb24
        plane packed host-side in this feeder thread (overlapped with
        device compute). Saves the tiled render's per-frame HWC channel
        relayout at the cost of +4 B/px upload.

        ``upload=False``: deliver host-only pairs (``pair.left``/``right``
        are None). The capture/pairing/QoS machinery runs unchanged but the
        per-frame H2D transfer is skipped — the measurement mode behind
        tools/stream_bench.py --device-resident, which substitutes a
        pre-uploaded device ring so the streaming MACHINERY can be timed
        apart from host→device transfers. Not a production path."""
        self.source_left = source_left
        self.source_right = source_right
        self.pairer = pairer or ApproximateTimePairer()
        self.device = device
        self.pack_color = pack_color
        self.upload = upload
        self._init_delivery(depth, lifespan_s)

    def _upload(self, host: HostFrameset, intr: Intrinsics) -> Frameset:
        if host.depth.shape != host.color.shape[:2]:
            raise ValueError(
                f"depth {host.depth.shape} / color {host.color.shape[:2]} "
                "size mismatch — the fusion path needs color-aligned depth. "
                "Disable the camera node's decimation filter for composed "
                "fusion (the reference also runs it disabled, "
                "realsense.cpp:393)."
            )
        fs = Frameset.create(
            host.depth,
            host.color,
            intr,
            depth_scale=host.depth_scale,
            timestamp=host.timestamp,
            pack_color=self.pack_color,
        )
        if self.device is not None:
            fs = jax.device_put(fs, self.device)
        return fs

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                fl = self.source_left.next_frame()
                fr = self.source_right.next_frame()
                if fl is None or fr is None:
                    self._deliver_sentinel()
                    return
                pairs = []
                pairs += self.pairer.push(0, fl)
                pairs += self.pairer.push(1, fr)
                for hl, hr in pairs:
                    t_up = time.perf_counter()
                    if not self.upload:
                        pair = DevicePair(left=None, right=None,
                                          host_left=hl, host_right=hr)
                        pair.enqueue_time = time.perf_counter()
                        if not self._deliver(pair):
                            return
                        continue
                    pair = DevicePair(
                        left=self._upload(hl, self.source_left.intrinsics),
                        right=self._upload(hr, self.source_right.intrinsics),
                        host_left=hl,
                        host_right=hr,
                    )
                    # Fence before stamping: device_put only ENQUEUES the
                    # H2D copy, so an unfenced stamp reports dispatch time
                    # while the real transfer silently lands in the
                    # consumer's first compute stage. Fencing here keeps upload_ms
                    # honest and still overlaps with the consumer — this is
                    # the producer thread, one pair ahead.
                    jax.block_until_ready((pair.left, pair.right))
                    pair.upload_ms = (time.perf_counter() - t_up) * 1e3
                    pair.enqueue_time = time.perf_counter()
                    if not self._deliver(pair):
                        return
        except Exception as exc:  # propagate end-of-stream instead of hanging get()
            self.error = exc
            self._deliver_sentinel(drop_pending=True)



# ---------------------------------------------------------------------------
# N-camera rig feeder (camera-sharded upload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RigBatch:
    """One synchronized N-camera frame set, stacked on a leading camera
    axis — the input shape of parallel.mesh.rig_fuse / rig_fuse_sharded."""

    depth: jax.Array  # (N, H, W) uint16
    color: jax.Array  # (N, H, W, 3) uint8, or (N, H, W) int32 when packed
    depth_scale: jax.Array  # (N,) float32
    timestamps: List[float]  # host f64 capture stamps, per camera
    host_frames: Tuple[HostFrameset, ...]
    upload_ms: float = 0.0
    enqueue_time: float = 0.0


class RigFeeder(_AsyncFeederBase):
    """Background thread feeding an N-camera rig: capture all cameras →
    N-way ApproximateTime sync → ONE stacked (camera-axis) upload.

    The multi-camera generalization of :class:`DeviceFeeder` — and the
    ingestion side of the camera-sharded mesh path: given ``mesh``, the
    stacked arrays are uploaded with ``NamedSharding(mesh, P(axis))``, so
    each device receives exactly its cameras' frames at transfer time and
    ``rig_fuse_sharded`` consumes them with no device-side reshard. Without
    a mesh the batch lands on ``device`` (or the default) whole — the
    single-chip ``rig_fuse`` shape.

    ``pack_color=True`` uploads the rig color as pre-packed (N, H, W) i32
    rgb24 planes instead of HWC u8 (both accepted by the rig paths,
    bit-identical; the packed form skips the per-camera channel relayout
    on device at +1 B/px upload vs HWC).
    """

    def __init__(
        self,
        sources: List[FramesetSource],
        mesh=None,
        axis: str = "cam",
        sync: Optional[ApproximateTimeSyncN] = None,
        depth: int = 2,
        device: Optional[jax.Device] = None,
        lifespan_s: Optional[float] = None,
        pack_color: bool = False,
        upload: bool = True,
    ):
        """``upload=False``: deliver host-only batches (device fields are
        None) — same machinery-isolation measurement mode as
        DeviceFeeder(upload=False); see that docstring."""
        if len(sources) < 2:
            raise ValueError(f"rig needs >= 2 cameras, got {len(sources)}")
        if mesh is not None and len(sources) % mesh.shape[axis] != 0:
            raise ValueError(
                f"{len(sources)} cameras not divisible by the "
                f"{mesh.shape[axis]}-device '{axis}' mesh axis"
            )
        self.sources = sources
        self.mesh = mesh
        self.axis = axis
        self.sync = sync or ApproximateTimeSyncN(len(sources))
        self.device = device
        self.pack_color = pack_color
        self.upload = upload
        self._init_delivery(depth, lifespan_s)

    def _put(self, arr: np.ndarray) -> jax.Array:
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec  # noqa: PLC0415

            return jax.device_put(
                arr, NamedSharding(self.mesh, PartitionSpec(self.axis))
            )
        if self.device is not None:
            return jax.device_put(arr, self.device)
        return jax.device_put(arr)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                sets = []
                ended = False
                for i, src in enumerate(self.sources):
                    f = src.next_frame()
                    if f is None:
                        ended = True
                        break
                    sets += self.sync.push(i, f)
                # Sets completed THIS round (e.g. one previously withheld
                # by the final-pick gate) must still reach the consumer
                # even when a finite source just ended — and at stream end
                # the sync gate is RELAXED (flush): a final matchable set
                # whose picks were each waiting on a next frame that will
                # never arrive is emitted, not silently dropped.
                if ended:
                    sets += self.sync.flush()
                for frames in sets:
                    for f in frames:
                        # Same invariant DeviceFeeder._upload enforces: a
                        # decimated (non-color-aligned) depth stream must
                        # fail HERE with the explanation, not later as an
                        # opaque XLA reshape error inside the rig trace.
                        if f.depth.shape != f.color.shape[:2]:
                            raise ValueError(
                                f"depth {f.depth.shape} / color "
                                f"{f.color.shape[:2]} size mismatch — the "
                                "fusion path needs color-aligned depth. "
                                "Disable the camera node's decimation "
                                "filter for composed fusion (the reference "
                                "also runs it disabled, realsense.cpp:393)."
                            )
                    t_up = time.perf_counter()
                    if not self.upload:
                        batch = RigBatch(
                            depth=None, color=None, depth_scale=None,
                            timestamps=[f.timestamp for f in frames],
                            host_frames=frames,
                        )
                        batch.enqueue_time = time.perf_counter()
                        if not self._deliver(batch):
                            return
                        continue
                    if self.pack_color:
                        color = np.stack(
                            [pack_rgb24_host(f.color) for f in frames]
                        )
                    else:
                        color = np.stack([f.color for f in frames])
                    batch = RigBatch(
                        depth=self._put(np.stack([f.depth for f in frames])),
                        color=self._put(color),
                        depth_scale=self._put(
                            np.asarray(
                                [f.depth_scale for f in frames], np.float32
                            )
                        ),
                        timestamps=[f.timestamp for f in frames],
                        host_frames=frames,
                    )
                    # Fence before stamping (see DeviceFeeder._run: an
                    # unfenced stamp reports dispatch, not transfer).
                    jax.block_until_ready((batch.depth, batch.color))
                    batch.upload_ms = (time.perf_counter() - t_up) * 1e3
                    batch.enqueue_time = time.perf_counter()
                    if not self._deliver(batch):
                        return
                if ended:
                    self._deliver_sentinel()
                    return
        except Exception as exc:
            self.error = exc
            self._deliver_sentinel(drop_pending=True)
