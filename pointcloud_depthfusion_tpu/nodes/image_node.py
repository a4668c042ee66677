"""Image sink node: the visualization endpoint.

Equivalent of the reference image_node (OpenCV imshow viewer,
image_node/src/image_node.cpp:38-120) with all four of its callback kinds:
fused color (fusedCallback), raw depth (depthCallback), full frameset —
color + depth side by side with the 0.1 convertScaleAbs depth visualization
(framesetCallback, image_node.cpp:75-95) — and the small preview image
(imageSmallCallback). Fusion hosts are often headless, so the default sink writes
numbered PNGs to a directory; an interactive backend can be plugged in by
passing a custom ``display`` callable.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

import numpy as np

from pointcloud_depthfusion_tpu.io.artifacts import save_png


class WindowClosed(Exception):
    """Raised by an interactive ``display`` backend when its window closes.

    The reference viewer stops the whole app when the user closes the
    OpenCV window (``cv::getWindowProperty`` poll → ``rclcpp::shutdown``,
    image_node/src/image_node.cpp:54-68); a plugged-in display signals the
    same by raising this from the display callable."""


def depth_to_u8(depth_u16: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """cv::convertScaleAbs(depth, 0.1) (image_node.cpp:84): |d·scale|
    rounded (saturate_cast rounds to nearest even, like np.rint) and
    saturated to uint8 — the reference viewer's depth visualization."""
    return np.clip(np.rint(np.abs(depth_u16.astype(np.float64) * scale)),
                   0, 255).astype(np.uint8)


class OpenCVDisplay:
    """Interactive viewer backend: the reference's OpenCV imshow loop.

    Mirrors image_node.cpp:54-68 exactly: named window, RGB→BGR conversion,
    ``imshow`` + ``waitKey(1)`` pump, and a ``getWindowProperty`` poll that
    reports user window-close by raising :class:`WindowClosed` (the
    reference calls ``rclcpp::shutdown`` there; here ImageNode fires its
    ``on_close`` hook). Plug into ImageNode via ``display=OpenCVDisplay()``.

    Headless hosts have no display server — construction is cheap and
    lazy; the first ``__call__`` raises a clear RuntimeError if the GUI
    stack cannot open a window (keep the default PNG sink there).
    """

    def __init__(self, window_name: str = "fused_image", cv2_module=None):
        if cv2_module is None:
            try:
                import cv2 as cv2_module  # noqa: PLC0415
            except ImportError as exc:  # pragma: no cover
                raise RuntimeError(
                    "OpenCVDisplay needs the cv2 package; use the PNG sink "
                    "on hosts without it"
                ) from exc
        self._cv2 = cv2_module
        self.window_name = window_name
        self._opened: set = set()

    def _window_for(self, kind: Optional[str]) -> str:
        # One window PER SINK KIND, like the reference's per-callback
        # windows (image_node.cpp:38-109) — routing all four streams into
        # a single window would flicker between unrelated images.
        if kind in (None, "fused"):
            return self.window_name
        return f"{self.window_name}:{kind}"

    def __call__(
        self, image: np.ndarray, timestamp: float, kind: Optional[str] = None
    ) -> None:
        cv2 = self._cv2
        win = self._window_for(kind)
        try:
            if win not in self._opened:
                cv2.namedWindow(win, cv2.WINDOW_AUTOSIZE)
                self._opened.add(win)
            bgr = image[..., ::-1] if image.ndim == 3 else image
            cv2.imshow(win, np.ascontiguousarray(bgr))
            cv2.waitKey(1)
            # visibility poll == the reference's close detection
            # (getWindowProperty(WND_PROP_VISIBLE) < 1 → shutdown).
            if cv2.getWindowProperty(win, cv2.WND_PROP_VISIBLE) < 1:
                raise WindowClosed(win)
        except WindowClosed:
            raise
        except Exception as exc:  # cv2.error on headless hosts
            raise RuntimeError(
                f"OpenCVDisplay could not drive a window ({exc}); this host "
                "is likely headless — use ImageNode's PNG sink instead"
            ) from exc

    def close(self) -> None:
        for win in self._opened:
            try:
                self._cv2.destroyWindow(win)
            except Exception:
                pass
        self._opened = set()


class ImageNode:
    def __init__(
        self,
        out_dir: Optional[str] = None,
        display: Optional[Callable[[np.ndarray, float], None]] = None,
        every_n: int = 1,
        max_saved: Optional[int] = None,
        depth_scale_abs: float = 0.1,
        on_close: Optional[Callable[[], None]] = None,
    ):
        """``on_close``: invoked once when the display backend reports its
        window closed (raises :class:`WindowClosed`) — the app-shutdown hook
        the reference viewer triggers via rclcpp::shutdown
        (image_node.cpp:54-68). The composed demo wires this to stop the
        feeder/camera loops."""
        self.out_dir = out_dir
        self.display = display
        # Pass the sink kind to display backends that accept it (so an
        # interactive backend can open one window per stream, like the
        # reference's per-callback windows); plain (image, timestamp)
        # callables keep working.
        self._display_takes_kind = False
        if display is not None:
            import inspect  # noqa: PLC0415

            try:
                self._display_takes_kind = (
                    "kind" in inspect.signature(display).parameters
                )
            except (TypeError, ValueError):
                pass
        # A YAML-driven every_n of 0 must not crash the first frame
        # callback with a modulo-by-zero; 'save every frame' is the only
        # sane reading.
        self.every_n = max(1, int(every_n))
        self.max_saved = max_saved
        self.depth_scale_abs = depth_scale_abs
        self._on_close = on_close
        self.closed = threading.Event()
        self.received = 0
        self.saved = 0
        self._counters: dict = {}
        self._saved_per_kind: dict = {}
        # The sinks are fed from multiple threads in the composed demo (the
        # feeder thread drives depth/frameset/small, the main loop drives
        # fused); unsynchronized read-modify-writes would drop counts.
        self._lock = threading.Lock()

    # -- shared sink plumbing ------------------------------------------------

    def _sink(self, kind: str, image: np.ndarray, timestamp: float) -> None:
        with self._lock:
            n = self._counters.get(kind, 0)
            self._counters[kind] = n + 1
            self.received += 1
            save = not (self.out_dir is None or n % self.every_n)
            # max_saved budgets each sink kind independently, so auxiliary
            # depth/frameset/small saves never starve the fused stream.
            if save and (
                self.max_saved is not None
                and self._saved_per_kind.get(kind, 0) >= self.max_saved
            ):
                save = False
            if save:
                self._saved_per_kind[kind] = (
                    self._saved_per_kind.get(kind, 0) + 1
                )
                self.saved += 1
        if self.display is not None and not self.closed.is_set():
            try:
                if self._display_takes_kind:
                    self.display(image, timestamp, kind=kind)
                else:
                    self.display(image, timestamp)
            except WindowClosed:
                self.close()
        if save:
            save_png(os.path.join(self.out_dir, f"{kind}_{n:06d}.png"), image)

    def close(self) -> None:
        """Viewer-closed shutdown path: idempotently fire ``on_close``."""
        if not self.closed.is_set():
            self.closed.set()
            if self._on_close is not None:
                self._on_close()

    # -- the four reference callbacks ---------------------------------------

    def __call__(self, image: np.ndarray, timestamp: float) -> None:
        """Fused-image sink (fusedCallback, image_node.cpp:97-109)."""
        self._sink("fused", image, timestamp)

    def on_depth(self, depth_u16: np.ndarray, timestamp: float) -> None:
        """Depth viewer (depthCallback): scaled-abs uint8 visualization."""
        self._sink("depth", depth_to_u8(depth_u16, self.depth_scale_abs), timestamp)

    def on_frameset(self, frameset) -> None:
        """Frameset viewer (framesetCallback, image_node.cpp:75-95): the
        reference shows color and convertScaleAbs(0.1) depth as two windows;
        headless, they land side by side in one PNG. A decimated depth
        stream (smaller than color) is nearest-neighbor upscaled to the
        color height first."""
        depth_vis = depth_to_u8(frameset.depth, self.depth_scale_abs)
        ch = frameset.color.shape[0]
        if depth_vis.shape[0] != ch:
            from PIL import Image  # noqa: PLC0415

            cw = round(depth_vis.shape[1] * ch / depth_vis.shape[0])
            depth_vis = np.asarray(
                Image.fromarray(depth_vis).resize((cw, ch), Image.NEAREST)
            )
        depth_rgb = np.repeat(depth_vis[:, :, None], 3, axis=2)
        combo = np.concatenate([frameset.color, depth_rgb], axis=1)
        self._sink("frameset", combo, frameset.timestamp)

    def on_image_small(self, image: np.ndarray, timestamp: float) -> None:
        """Small-preview sink (imageSmallCallback, image_node.cpp:55-69)."""
        self._sink("small", image, timestamp)
