"""Profiling & telemetry: stage timers, FPS accounting, CSV logs.

Covers the reference's four tracing mechanisms (SURVEY.md §5):
  1. per-op GPU timers (cudaEventRecord, frameset.cpp:213-237) →
     :class:`StageTimer` with `block_until_ready` fencing;
  2. fusion hot-path stage CSV (fusion_node.hpp:197-204 schema) →
     :class:`StageLog`;
  3. registration CSV — lives in registration/pipeline.py;
  4. FPS telemetry strings ({"FPS": x, "lastCurrMSec": y},
     camera_node.cpp:388-434) → :class:`FpsCounter`.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

import jax

FUSION_STAGE_FIELDS = [
    "loop",
    "callback",
    "filter",
    "deproject",
    "transform_right",
    "fuse",
    "transform",
    "project",
    "publish",
    "latency",
    "diff",
    "copy_to_gpu",
    "copy_from_gpu",
    "filter_image",
]
"""The reference fusion profiling schema (fusion_node.hpp:198-200). The
profiling mode (FusionPipeline.process_profiled) fills the device stages
with real fenced times from the split sub-programs; the host stages
(callback/publish/diff/latency/copy_to_gpu/loop) come from host clocks in
FusionNodeApp.process_pair."""


class StageTimer:
    """Wall-clock stage timer with device fencing.

    ``lap(name, *arrays)`` blocks on the given arrays (the XLA analogue of
    cudaDeviceSynchronize in getTiming, fusion_node.cpp:620-631) and records
    the elapsed milliseconds since the previous lap.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.laps: Dict[str, float] = {}
        self._t = time.perf_counter()

    def reset(self) -> None:
        self.laps = {}
        self._t = time.perf_counter()

    def lap(self, name: str, *fence) -> float:
        if not self.enabled:
            return 0.0
        for arr in fence:
            # Fence by FETCHING one element: a scalar read is a true data
            # dependency on the stage's completion (~sub-ms), so each
            # stage's device time lands in its own lap.
            try:
                jax.device_get(arr.ravel()[0])
            except Exception:
                jax.block_until_ready(arr)
        now = time.perf_counter()
        ms = (now - self._t) * 1e3
        self.laps[name] = self.laps.get(name, 0.0) + ms
        self._t = now
        return ms


class StageLog:
    """Accumulates per-frame stage rows; flushes to CSV every ``log_size``
    rows (the reference writes `<node>_profiling.txt` the same way)."""

    def __init__(
        self,
        path: str,
        fields: Optional[List[str]] = None,
        log_size: int = 400,
    ):
        self.path = path
        self.fields = fields or FUSION_STAGE_FIELDS
        self.log_size = log_size
        self.rows: List[List[float]] = []
        self._header_written = False

    def add(self, laps: Dict[str, float]) -> None:
        self.rows.append([laps.get(f, 0.0) for f in self.fields])
        if len(self.rows) >= self.log_size:
            self.flush()

    def flush(self) -> None:
        if not self.rows:
            return
        # Append across flush windows (header once): mode "w" here would
        # overwrite every earlier window and keep only the tail of a run.
        mode = "a" if self._header_written else "w"
        with open(self.path, mode) as fh:
            if not self._header_written:
                fh.write(",".join(self.fields) + "\n")
                self._header_written = True
            for row in self.rows:
                fh.write(",".join(f"{v:.4f}" for v in row) + "\n")
        self.rows = []


class FpsCounter:
    """FPS over a sliding window, emitting the reference's JSON string
    format on a callback (the `<name>/fps` topic equivalent)."""

    def __init__(
        self,
        name: str = "FPS",
        report_every_s: float = 1.0,
        sink: Optional[Callable[[str], None]] = None,
    ):
        self.name = name
        self.report_every_s = report_every_s
        self.sink = sink
        # Runtime gate on the sink (the reference's ``profiling.publish_fps``
        # parameter, config.cpp:132-134): counting continues, emission stops.
        self.publish = True
        self.frame_count = 0
        self.elapsed = 0.0
        self._last = time.perf_counter()
        self.last_fps = 0.0
        self.last_frame_ms = 0.0

    def tick(self) -> Optional[str]:
        now = time.perf_counter()
        frame_ms = (now - self._last) * 1e3
        self._last = now
        self.frame_count += 1
        self.elapsed += frame_ms
        self.last_frame_ms = frame_ms
        if self.elapsed >= self.report_every_s * 1e3:
            self.last_fps = 1000.0 * self.frame_count / self.elapsed
            msg = json.dumps(
                {self.name: round(self.last_fps, 2), "lastCurrMSec": round(frame_ms, 2)}
            )
            self.frame_count = 0
            self.elapsed = 0.0
            if self.sink and self.publish:
                self.sink(msg)
            return msg
        return None


def get_current_rss_bytes() -> int:
    """Resident set size (Utils.h GetCurrentRSS equivalent)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        import resource  # noqa: PLC0415

        return pages * resource.getpagesize()
    except Exception:
        return 0
