"""TCP frameset streaming: the cross-machine capture transport.

The reference's two-host deployment moves framesets between machines over
DDS/UDP (camera_node on each Jetson → fusion_node on one of them,
README.md:14-34). On the fusion host the capture silicon lives elsewhere; this
module is the runnable network backend for that topology: a **camera host**
(any machine that can produce framesets — a RealSense box, a recorded
dataset, the synthetic renderer) runs :class:`FramesetStreamServer`, and
the fusion host consumes it through :class:`NetworkSource` — a plain
FramesetSource, so it plugs straight into CameraNode / DeviceFeeder /
FusionNodeApp like any local source.

Wire protocol (version 1, little-endian):

  handshake:  b"PDFN" | u8 version | u32 json_len | json
              json = {name, fps, intrinsics, extrinsic_rotation (row-major
              9), extrinsic_translation (3)}
              (the GetCameraParameters service handshake, camera_node
              .cpp:377-386, folded into connection setup; depth_scale
              rides per-frame in the EncodedFrameset blob)
  per frame:  u32 blob_len | frame blob
  end:        u32 0  (clean end of stream)

Two frame codecs, negotiated via the handshake's ``codec`` field:

  "png"  (default) — EncodedFrameset blob (PNG-compressed pair,
         io/encoded.py — the reference's EncodedFrameset message put to
         work); ~10× smaller, costs a PNG encode per frame.
  "raw"  — uncompressed little-endian pair (what the reference's DDS
         DepthFrameset actually carries): u32 h | u32 w | f64 timestamp |
         f32 depth_scale | h·w u16 depth | h·w·3 u8 color. Zero encode
         cost; ~4.6 MB/frame at 1280×720 (~1.1 Gbps at 30 FPS — wired-LAN
         territory).

QoS semantics mirror the reference's sensor-data profile: the server keeps
a bounded per-client queue and drops the OLDEST frame when the consumer
falls behind (best-effort keep-last-N, camera_node.cpp:104-114) — a slow
link degrades to lower frame rate, never to unbounded latency.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import sys
import threading
from typing import Optional

import numpy as np

from pointcloud_depthfusion_tpu.core.camera import (
    Distortion,
    Extrinsics,
    Intrinsics,
)
from pointcloud_depthfusion_tpu.core.frameset import HostFrameset
from pointcloud_depthfusion_tpu.io.encoded import EncodedFrameset
from pointcloud_depthfusion_tpu.io.feeder import FramesetSource

_MAGIC = b"PDFN"
_VERSION = 1
# Producer→sender queue marker for a SOURCE FAILURE: the sender closes the
# connection without the clean u32(0) end sentinel, so the consuming host
# raises ConnectionError instead of reading the crash as end-of-stream.
_ABORT = object()
# Wire sanity caps: the u32 length fields come from the peer; a desynced,
# corrupt, or hostile sender must not drive a multi-GB allocation or an
# unbounded buffering stall on the fusion host.
_MAX_HANDSHAKE_BYTES = 1 << 20  # 1 MB of calibration JSON
_MAX_FRAME_BYTES = 64 << 20  # 64 MB/frame (4K raw pair is ~41 MB)


def _intrinsics_to_json(intr: Intrinsics) -> dict:
    return {
        "width": int(intr.width),
        "height": int(intr.height),
        "fx": float(intr.fx),
        "fy": float(intr.fy),
        "ppx": float(intr.ppx),
        "ppy": float(intr.ppy),
        "model": int(intr.model),
        "coeffs": [float(c) for c in np.asarray(intr.coeffs).reshape(-1)],
    }


def _intrinsics_from_json(d: dict) -> Intrinsics:
    return Intrinsics.create(
        d["width"], d["height"], fx=d["fx"], fy=d["fy"],
        ppx=d["ppx"], ppy=d["ppy"],
        model=Distortion(d.get("model", int(Distortion.NONE))),
        coeffs=d.get("coeffs", [0.0] * 5),
    )


def _encode_raw(fs: HostFrameset) -> bytes:
    depth = np.ascontiguousarray(fs.depth, dtype="<u2")
    color = np.ascontiguousarray(fs.color, dtype=np.uint8)
    h, w = depth.shape
    header = struct.pack("<IIdf", h, w, fs.timestamp, fs.depth_scale)
    return header + depth.tobytes() + color.tobytes()


def _decode_raw(blob: bytes) -> HostFrameset:
    hdr = struct.calcsize("<IIdf")
    if len(blob) < hdr:
        raise ConnectionError(f"raw frame truncated ({len(blob)} bytes)")
    h, w, ts, scale = struct.unpack("<IIdf", blob[:hdr])
    n_d = h * w * 2
    # h/w come from the wire: check the declared geometry against the blob
    # before frombuffer (an attacker-controlled h*w must not out-of-bounds
    # or allocate absurdly).
    if h == 0 or w == 0 or h > 16384 or w > 16384:
        raise ConnectionError(f"implausible raw frame geometry {h}x{w}")
    if len(blob) != hdr + n_d + h * w * 3:
        raise ConnectionError(
            f"raw frame size mismatch: {len(blob)} bytes for {h}x{w}"
        )
    depth = np.frombuffer(blob, dtype="<u2", count=h * w, offset=hdr).reshape(
        h, w
    )
    color = np.frombuffer(
        blob, dtype=np.uint8, count=h * w * 3, offset=hdr + n_d
    ).reshape(h, w, 3)
    return HostFrameset(
        depth=depth.copy(), color=color.copy(), timestamp=ts,
        depth_scale=scale,
    )


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # Preallocated + recv_into: `bytes +=` would recopy the accumulated
    # buffer per kernel-sized recv chunk — quadratic, tens of extra MB of
    # memcpy per raw-codec 720p frame at 30 FPS.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("stream closed mid-message")
        got += k
    return bytes(buf)


class FramesetStreamServer:
    """Stream a FramesetSource's frames to one TCP client at a time.

    The capture side of the two-host deployment. ``queue_size`` bounds the
    per-client backlog (drop-oldest, like SensorDataQoS keep-last). The
    server re-accepts after a client disconnects until :meth:`stop`.
    """

    def __init__(
        self,
        source: FramesetSource,
        host: str = "127.0.0.1",
        port: int = 0,
        name: str = "camera",
        fps: float = 30.0,
        depth_to_color: Optional[Extrinsics] = None,
        queue_size: int = 4,
        max_frames: Optional[int] = None,
        sndbuf: Optional[int] = None,
        codec: str = "png",
    ):
        """``sndbuf``: optional SO_SNDBUF for client connections — bounds
        the kernel-side backlog so the drop-oldest QoS engages promptly on
        slow links (loopback TCP otherwise autotunes to many MB).

        ``codec``: "png" (compressed, thin links) or "raw" (zero encode
        cost, the reference's uncompressed-DDS parity — wired LAN)."""
        if codec not in ("png", "raw"):
            raise ValueError(f"codec must be 'png' or 'raw', not {codec!r}")
        self.codec = codec
        self.source = source
        self.name = name
        self.fps = fps
        # Keep calibration host-side as numpy: every field read of a
        # device-resident jnp array is a device round-trip — a pure-host
        # transport must never touch the accelerator.
        if depth_to_color is not None:
            self._ext_rot = np.asarray(depth_to_color.rotation, np.float64)
            self._ext_t = np.asarray(depth_to_color.translation, np.float64)
        else:
            self._ext_rot = np.eye(3)
            self._ext_t = np.zeros(3)
        self.queue_size = queue_size
        self.max_frames = max_frames
        self.sndbuf = sndbuf
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self._sock.settimeout(0.5)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn: Optional[socket.socket] = None  # active client (stop())
        # Incremented from the producer AND sender threads; tests assert on
        # these, so guard them (unsynchronized += can under-count).
        self._stats_lock = threading.Lock()
        self.frames_sent = 0
        self.frames_dropped = 0
        # Built once here (any device fetches for the intrinsics happen at
        # construction, visibly), reused for every client.
        self._handshake = self._handshake_blob()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FramesetStreamServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Close the ACTIVE client connection too: a sender blocked in
        # conn.sendall (stalled client, kernel SNDBUF full) never checks
        # _stop — closing the socket unblocks it with an OSError, which
        # the serve loop treats as client-went-away. Without this the
        # daemon thread survives stop() and resumes streaming if the
        # client ever starts reading again.
        conn = self._conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=5.0)
        self._sock.close()

    def __enter__(self) -> "FramesetStreamServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals ---------------------------------------------------------

    def _handshake_blob(self) -> bytes:
        payload = json.dumps(
            {
                "name": self.name,
                "fps": self.fps,
                "codec": self.codec,
                "intrinsics": _intrinsics_to_json(self.source.intrinsics),
                "extrinsic_rotation": self._ext_rot.reshape(-1).tolist(),
                "extrinsic_translation": self._ext_t.reshape(-1).tolist(),
            }
        ).encode()
        return _MAGIC + struct.pack("<BI", _VERSION, len(payload)) + payload

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conn = conn
            try:
                self._stream_to(conn)
            except (ConnectionError, OSError, BrokenPipeError):
                pass  # client went away: re-accept
            finally:
                self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass

    def _stream_to(self, conn: socket.socket) -> None:
        if self.sndbuf:
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, self.sndbuf)
        conn.sendall(self._handshake)
        # Encode on a producer thread so a stalled socket cannot stall
        # capture; bounded drop-oldest queue = best-effort QoS.
        q: "queue.Queue[Optional[bytes]]" = queue.Queue(self.queue_size)
        done = threading.Event()

        def produce():
            import sys
            import time
            import traceback

            period = 1.0 / self.fps if self.fps > 0 else 0.0
            sent = 0
            while not (self._stop.is_set() or done.is_set()):
                t0 = time.perf_counter()
                # Check the cap BEFORE fetching: pulling frame N+1 only to
                # discard it would silently consume one frame per client
                # from a non-looping recorded source.
                if self.max_frames is not None and sent >= self.max_frames:
                    fs = None
                else:
                    try:
                        fs = self.source.next_frame()
                    except Exception:
                        # A broken source must end the stream LOUDLY: the
                        # abort marker makes the sender close the socket
                        # WITHOUT the clean end sentinel, so the consuming
                        # host's NetworkSource raises ConnectionError
                        # instead of reading a sensor crash as a normal
                        # end-of-recording (silent-EOS masking).
                        traceback.print_exc(file=sys.stderr)
                        fs = _ABORT
                if fs is None or fs is _ABORT:
                    marker = None if fs is None else _ABORT
                    # The end/abort marker MUST reach the sender even
                    # through a full queue — a lost marker leaves the
                    # consumer thread waiting and the client hanging. On a
                    # CLEAN end there is nothing left to capture, so just
                    # WAIT for the sender to drain (it exits via `done` if
                    # the client dies, so no hang) — dropping would lose
                    # the tail frames of a bounded stream. Only the ABORT
                    # path sacrifices queued frames for immediacy (the
                    # feeder sentinel makes the same distinction,
                    # feeder._deliver_sentinel(drop_pending)).
                    while not (self._stop.is_set() or done.is_set()):
                        try:
                            q.put(marker, timeout=0.1)
                            return
                        except queue.Full:
                            if marker is None:
                                continue  # clean end: let the sender drain
                            try:
                                q.get_nowait()
                                with self._stats_lock:
                                    self.frames_dropped += 1
                            except queue.Empty:
                                pass
                    return
                blob = (
                    _encode_raw(fs) if self.codec == "raw"
                    else EncodedFrameset.encode(fs).to_bytes()
                )
                sent += 1
                while True:
                    try:
                        q.put(blob, timeout=0.1)
                        break
                    except queue.Full:
                        try:  # drop-oldest (keep-last QoS)
                            q.get_nowait()
                            with self._stats_lock:
                                self.frames_dropped += 1
                        except queue.Empty:
                            pass
                    if self._stop.is_set() or done.is_set():
                        return
                if period:
                    dt = time.perf_counter() - t0
                    if dt < period:
                        time.sleep(period - dt)

        prod = threading.Thread(target=produce, daemon=True)
        prod.start()
        try:
            while not self._stop.is_set():
                try:
                    blob = q.get(timeout=0.5)
                except queue.Empty:
                    if not prod.is_alive():
                        # Producer died without a reachable marker (it
                        # crashed mid-drop): ABORT — closing without the
                        # clean sentinel makes the client raise
                        # ConnectionError rather than read a crash as EOS.
                        print(f"{self.name}: producer died, aborting client",
                              file=sys.stderr, flush=True)
                        return
                    continue
                if blob is None:
                    conn.sendall(struct.pack("<I", 0))  # clean end
                    return
                if blob is _ABORT:
                    # Source failure: close WITHOUT the clean end sentinel.
                    return
                conn.sendall(struct.pack("<I", len(blob)) + blob)
                with self._stats_lock:
                    self.frames_sent += 1
        finally:
            done.set()
            prod.join(timeout=2.0)


class NetworkSource(FramesetSource):
    """FramesetSource over a TCP frameset stream (the fusion-host side).

    Blocks in the constructor until the handshake arrives; ``intrinsics``
    and ``depth_to_color`` then carry the remote camera's calibration
    (the service handshake, delivered once per connection).
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        try:
            self._sock.settimeout(timeout_s)
            magic = _recv_exact(self._sock, 4)
            if magic != _MAGIC:
                raise ConnectionError(f"not a PDFN stream (got {magic!r})")
            version, jlen = struct.unpack("<BI", _recv_exact(self._sock, 5))
            if version != _VERSION:
                raise ConnectionError(f"unsupported stream version {version}")
            if jlen > _MAX_HANDSHAKE_BYTES:
                raise ConnectionError(
                    f"handshake length {jlen} exceeds the "
                    f"{_MAX_HANDSHAKE_BYTES} byte cap (desynced or hostile "
                    "peer)"
                )
            meta = json.loads(_recv_exact(self._sock, jlen).decode())
            self.name = meta.get("name", "camera")
            self.fps = float(meta.get("fps", 30.0))
            self.codec = meta.get("codec", "png")
            self._intr = _intrinsics_from_json(meta["intrinsics"])
            self.depth_to_color = Extrinsics.create(
                np.asarray(meta["extrinsic_rotation"], np.float64).reshape(
                    3, 3
                ),
                meta["extrinsic_translation"],
            )
        except BaseException:
            # A failed handshake must not leak the connected socket (a
            # reconnect loop would otherwise accumulate fds and pin the
            # server's single-client accept slot until GC).
            self._sock.close()
            raise
        self._ended = False
        self._failed: Optional[str] = None

    @property
    def intrinsics(self) -> Intrinsics:
        return self._intr

    def next_frame(self) -> Optional[HostFrameset]:
        if self._failed is not None:
            # The stream died on an ERROR: keep raising — a caller that
            # caught the first error and retried must not read the
            # post-error state as a clean end of stream.
            raise ConnectionError(self._failed)
        if self._ended:
            return None
        try:
            (n,) = struct.unpack("<I", _recv_exact(self._sock, 4))
            if n == 0:  # clean end of stream
                self._ended = True
                self._sock.close()
                return None
            if n > _MAX_FRAME_BYTES:
                self.close()
                raise ConnectionError(
                    f"frame length {n} exceeds the {_MAX_FRAME_BYTES} byte "
                    "cap (desynced or hostile peer)"
                )
            blob = _recv_exact(self._sock, n)
        except socket.timeout:
            # A frame gap beyond timeout_s is an ERROR, not a clean end —
            # silently returning None here would shut the whole fusion
            # pipeline down mid-capture with no diagnostic. Slow-cadence
            # servers should be consumed with a larger timeout_s.
            self.close()
            self._failed = (
                f"no frame from {self.name} within the socket timeout — "
                "raise NetworkSource(timeout_s=...) for slow senders"
            )
            raise TimeoutError(self._failed)
        except (ConnectionError, OSError) as exc:
            # An abrupt close is an ERROR, not a clean end: the server
            # always delivers a 0-length end sentinel, so missing it means
            # the peer died mid-stream or the framing desynced. Returning
            # None here would shut the fusion pipeline down as a normal
            # end-of-stream with zero diagnostic — and would also swallow
            # the oversized-frame ConnectionError raised above.
            self.close()
            self._failed = (
                f"frameset stream from {self.name} aborted mid-stream: "
                f"{exc}"
            )
            raise ConnectionError(self._failed) from exc
        # Decode failures latch _failed too: a desynced/corrupt payload is
        # a transport error like any other — letting it escape unlatched
        # would leave the socket open and a retrying caller reading length
        # fields from mid-frame bytes as if healthy (and the PNG decoder's
        # ValueError would bypass the documented ConnectionError contract).
        try:
            if self.codec == "raw":
                return _decode_raw(blob)
            return EncodedFrameset.from_bytes(blob).decode()
        except Exception as exc:
            self.close()
            self._failed = (
                f"frameset stream from {self.name} delivered an "
                f"undecodable frame: {exc}"
            )
            raise ConnectionError(self._failed) from exc

    def close(self) -> None:
        self._ended = True
        try:
            self._sock.close()
        except OSError:
            pass


def main() -> None:
    """Serve a camera over TCP (the camera-host process).

    ``python -m pointcloud_depthfusion_tpu.io.network --name camera_left
    --port 7447`` streams the synthetic camera; ``--dataset rec.npz``
    replays a recording instead.
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--name", default="camera_left",
                        choices=["camera_left", "camera_right"])
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7447)
    parser.add_argument("--width", type=int, default=848)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--frames", type=int, default=0,
                        help="stop after N frames per client (0 = endless)")
    parser.add_argument("--codec", default="png", choices=["png", "raw"],
                        help="frame codec: png (compressed) or raw "
                        "(reference DDS parity, wired LAN)")
    parser.add_argument("--dataset", default="",
                        help="replay a recorded .npz dataset (carries its "
                        "own intrinsics) instead of the synthetic camera")
    args = parser.parse_args()

    # The camera-host process is pure-host work; keep jax off the
    # accelerator so calibration field reads never ride a device link.
    import jax

    jax.config.update("jax_platforms", "cpu")

    if args.dataset:
        from pointcloud_depthfusion_tpu.io.recorded import RecordedSource

        source: FramesetSource = RecordedSource(args.dataset, loop=True)
    else:
        from pointcloud_depthfusion_tpu.io.feeder import (
            NativeSyntheticSource,
            SyntheticSource,
        )
        from pointcloud_depthfusion_tpu.io.synthetic import (
            SyntheticScene,
            two_camera_rig,
        )
        from pointcloud_depthfusion_tpu.runtime import is_available

        w, h = args.width, args.height
        fx = 631.0 * w / 848.0
        intr = Intrinsics.create(w, h, fx=fx, fy=fx, ppx=w / 2, ppy=h / 2)
        wl, wr = two_camera_rig()
        pose = wl if args.name == "camera_left" else wr
        cls = NativeSyntheticSource if is_available() else SyntheticSource
        # The source always needs a timestamp cadence; --fps 0 only
        # disables the SERVER's send pacing.
        source = cls(SyntheticScene(), intr, pose, fps=args.fps or 30.0,
                     depth_noise_std=0.002, hole_fraction=0.01)

    server = FramesetStreamServer(
        source, host=args.host, port=args.port, name=args.name,
        fps=args.fps, max_frames=args.frames or None, codec=args.codec,
    )
    server.start()
    print(f"{args.name}: serving framesets on {server.host}:{server.port} "
          f"({args.fps} FPS)")
    try:
        import time

        while True:
            time.sleep(5)
            print(f"sent {server.frames_sent} dropped {server.frames_dropped}")
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
