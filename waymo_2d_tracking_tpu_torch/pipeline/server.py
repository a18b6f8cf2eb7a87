"""Socket serving daemon over the online tracker (``serve``; counterpart of
``pipeline/server.py``, speaking its wire protocol byte for byte).

A long-lived process owns one online session (``pipeline/online.py``: on the
card the detector with the NMS kernel, then the tracker step captured as a
CUDA graph with its auction launches) and serves one camera stream, or one
camera rig, over a local socket. Clients pay the per-frame latency and never
the kernels' build or the graph's capture.

Design, in order:
  - The device step is serial (one tracker state), so the server is
    single-threaded: one connection at a time, frames in arrival order.
    Horizontal scale is one server process per card.
  - No dependencies: length-prefixed JSON and raw bytes over AF_UNIX or
    localhost TCP.
  - Crash-only: a client that disconnects mid-message drops its connection
    and the server returns to accept; the tracker state persists across
    connections unless a client sends ``reset``.
  - A request's error is served back and the server keeps going, except a
    kernel's build or launch failure or a CUDA error
    (``ops/_cuda.py KernelError``, ``torch.AcceleratorError``, a
    ``RuntimeError`` naming a CUDA error): the CUDA context may then be
    unusable, so the daemon re-raises and exits non-zero rather than answer
    ``ok: false`` forever.

Wire protocol (all lengths u32 big-endian):

  client -> server, one of:
    {"type": "frame", "timestamp_micros": int}   + payload (JPEG bytes or
        raw HxWx3 uint8 given "shape": [H, W, 3] in the header; against a
        multicam server: "shape": [N, H, W, 3] raw, or "jpeg_lens":
        [l1..lN] with N concatenated JPEGs)
    {"type": "reset", "context_name": str?}      (fresh track table)
    {"type": "stats"}                            (latency percentiles)
    {"type": "snapshot"}                         (tracker state -> base64)
    {"type": "restore", "context_name": str?}    + payload (snapshot bytes)
    {"type": "close"}                            (server replies, exits loop)
  each message = [len][header JSON][len][payload]; payload may be empty.

  server -> client: [len][body JSON]
    frame  -> {"ok": true, "records": [TrackRecord dicts], "latency_ms": f}
    reset  -> {"ok": true}
    stats  -> {"ok": true, "stats": {...}, "requests": n}
    errors -> {"ok": false, "error": "..."}

A snapshot is the JAX package's: an ``.npz`` of the ``TrackerState`` fields
in field order (``arr_0`` .. ``arr_13``) plus ``meta`` (context name,
multicam), so a snapshot moves between the two packages' servers. On the
card the live state is the captured step's buffers: a snapshot reads a copy
of them and a restore writes into them through the session's ``state``
setter.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.config import Config
from waymo_2d_tracking_tpu_torch.ops._cuda import KernelError
from waymo_2d_tracking_tpu_torch.types import TrackerState

_LEN = struct.Struct(">I")
MAX_MSG = 64 * 1024 * 1024  # refuse absurd lengths rather than run out of memory


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _recv_block(conn: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(conn, 4))
    if n > MAX_MSG:
        raise ConnectionError(f"message of {n} bytes exceeds {MAX_MSG}")
    return _recv_exact(conn, n) if n else b""


def _send_block(conn: socket.socket, data: bytes) -> None:
    conn.sendall(_LEN.pack(len(data)) + data)


def send_message(conn: socket.socket, header: dict, payload: bytes = b"") -> None:
    _send_block(conn, json.dumps(header).encode())
    _send_block(conn, payload)


def recv_response(conn: socket.socket) -> dict:
    return json.loads(_recv_block(conn).decode())


def is_device_fault(exc: BaseException) -> bool:
    """True for a kernel build / load / launch failure or a CUDA error: the
    daemon must stop, not serve the error back."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, KernelError) or (accel is not None and isinstance(exc, accel)):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


class TrackingServer:
    """Single-stream serving daemon; see the module docstring for the
    protocol.

    ``multicam=True`` serves a whole camera rig per frame message
    (``OnlineMultiCamTracker``, one detector batch a tick): the header
    carries ``"shape": [N, H, W, 3]`` for raw payloads or ``"jpeg_lens":
    [l1..lN]`` for N concatenated JPEGs, N = ``len(cfg.pipeline.cameras)``.
    ``state_dict``: detector weights (None: seeded random weights).
    """

    def __init__(self, cfg: Config, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda", seed: int = 0, camera_name: int = 1, multicam: bool = False):
        from waymo_2d_tracking_tpu_torch.pipeline.online import (
            OnlineMultiCamTracker,
            OnlineTracker,
        )

        self.multicam = bool(multicam)
        if self.multicam:
            num_cams = len(cfg.pipeline.cameras)
            self.sess = OnlineMultiCamTracker(
                cfg, camera_names=list(range(1, num_cams + 1)), state_dict=state_dict,
                device=device, seed=seed)
        else:
            self.sess = OnlineTracker(cfg, state_dict, device=device, seed=seed,
                                      camera_name=camera_name)
        self.cfg = cfg
        self._warmed: Optional[Tuple[int, int]] = None
        self.requests_served = 0

    def close(self) -> None:
        self.sess.close()

    def warmup(self, src_hw) -> float:
        """Build the kernels, capture the tracker step and warm the allocator
        for (H, W) step inputs; returns seconds. Owns the warmed-shape
        bookkeeping."""
        src_hw = (int(src_hw[0]), int(src_hw[1]))
        secs = self.sess.warmup(src_hw)
        self._warmed = src_hw
        return secs

    def warmup_source(self, src_hw) -> float:
        """Warm-up for full-resolution source dims (``serve --warmup H W``):
        the scaled shape compressed payloads decode to (when
        ``pipeline.decode_scale_denom > 1``) and the raw shape that decoded
        array payloads arrive at."""
        h, w = int(src_hw[0]), int(src_hw[1])
        secs = 0.0
        sd = self.cfg.pipeline.decode_scale_denom
        if sd > 1:
            secs += self.warmup((-(-h // sd), -(-w // sd)))
        secs += self.warmup((h, w))
        return secs

    # -- request handlers --------------------------------------------------
    def _decode_frames(self, header: dict, payload: bytes):
        """Header + payload -> the session's step input: decoded uint8
        array(s) for raw payloads, JPEG bytes for compressed ones (the
        session decodes them at ``decode_scale_denom`` and maps the boxes
        back)."""
        if "shape" in header:
            arr = np.frombuffer(payload, np.uint8).reshape(header["shape"])
            return list(arr) if self.multicam else arr
        if "jpeg_lens" in header:
            frames, off = [], 0
            for n in header["jpeg_lens"]:
                frames.append(bytes(payload[off:off + int(n)]))
                off += int(n)
            return frames
        return bytes(payload)

    def _step_src_hw(self, frames) -> Tuple[int, int]:
        """(H, W) the step will see for these frames: raw arrays as they
        are, compressed streams at ``decode_scale_denom`` (dims from each
        frame's JPEG header, so a new stream at another resolution re-warms)."""
        first = frames[0] if isinstance(frames, list) else frames
        if isinstance(first, (bytes, bytearray)):
            from waymo_2d_tracking_tpu_torch.data.jpeg import jpeg_dims

            h, w = jpeg_dims(bytes(first))
            sd = self.cfg.pipeline.decode_scale_denom
            return (-(-h // sd), -(-w // sd))
        arr = np.asarray(first)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(
                f"frame must be HxWx3 uint8, got shape {tuple(arr.shape)}"
                + ("" if self.multicam
                   else " (multicam payload against a single-camera server?)"))
        return tuple(arr.shape[:2])

    def _handle_frame(self, header: dict, payload: bytes) -> dict:
        frames = self._decode_frames(header, payload)
        # validate before the warm-up: a wrong rig size must not warm a
        # garbage shape
        if self.multicam and len(frames) != self.sess.num_cams:
            raise ValueError(
                f"rig has {self.sess.num_cams} cameras, got {len(frames)} frames")
        src_hw = self._step_src_hw(frames)
        if self._warmed != src_hw:
            self.warmup(src_hw)
        records = self.sess.step(frames, int(header["timestamp_micros"]))
        return {
            "ok": True,
            "records": [dataclasses.asdict(r) for r in records],
            "latency_ms": round(self.sess.last_latency_ms(), 3),
        }

    # -- state snapshot / restore ------------------------------------------
    def state_bytes(self) -> bytes:
        """The whole tracker state (track table, ages, embeddings, id
        counters) and the context metadata as ``.npz`` bytes."""
        import io

        state = self.sess.state.to_numpy()
        buf = io.BytesIO()
        np.savez(
            buf, *[getattr(state, f.name) for f in dataclasses.fields(TrackerState)],
            meta=np.array(json.dumps({
                "context_name": self.sess.context_name,
                "multicam": self.multicam,
            })),
        )
        return buf.getvalue()

    def load_state(self, data: bytes, context_name: Optional[str] = None) -> None:
        """Load ``state_bytes()`` output (of either package), checked field
        by field for shape and dtype against this server's config;
        ``context_name`` overrides the snapshot's."""
        import io

        cur = self.sess.state.to_numpy()
        fields = [f.name for f in dataclasses.fields(TrackerState)]
        with np.load(io.BytesIO(bytes(data))) as z:
            names = sorted((k for k in z.files if k.startswith("arr_")),
                           key=lambda k: int(k.split("_")[1]))
            leaves = [z[k] for k in names]
            meta = json.loads(str(z["meta"])) if "meta" in z.files else {}
        if len(leaves) != len(fields) or any(
            a.shape != getattr(cur, f).shape or a.dtype != getattr(cur, f).dtype
            for a, f in zip(leaves, fields)
        ):
            raise ValueError(
                "snapshot does not match this server's tracker config "
                "(slots/embed_dim/multicam must be identical)")
        self.sess.state = TrackerState.from_numpy(
            TrackerState(**dict(zip(fields, leaves))), device=self.sess.device)
        if context_name is not None:
            self.sess.context_name = str(context_name)
        elif meta.get("context_name"):
            self.sess.context_name = str(meta["context_name"])

    def _handle_snapshot(self) -> dict:
        import base64

        return {
            "ok": True,
            "snapshot": base64.b64encode(self.state_bytes()).decode(),
            "context_name": self.sess.context_name,
            "multicam": self.multicam,
        }

    def _handle(self, header: dict, payload: bytes) -> Tuple[dict, bool]:
        kind = header.get("type")
        if kind == "frame":
            return self._handle_frame(header, payload), False
        if kind == "snapshot":
            return self._handle_snapshot(), False
        if kind == "restore":
            self.load_state(payload, context_name=header.get("context_name"))
            return {"ok": True}, False
        if kind == "reset":
            self.sess.reset()
            if "context_name" in header:
                self.sess.context_name = str(header["context_name"])
            return {"ok": True}, False
        if kind == "stats":
            return {"ok": True, "stats": self.sess.latency_stats(),
                    "requests": self.requests_served}, False
        if kind == "close":
            return {"ok": True}, True
        return {"ok": False, "error": f"unknown message type {kind!r}"}, False

    # -- accept loop ---------------------------------------------------------
    def serve(self, socket_path: Optional[str] = None, port: Optional[int] = None,
              max_requests: Optional[int] = None, on_ready=None) -> int:
        """Blocking accept loop; returns the requests served.

        ``socket_path``: AF_UNIX path; ``port``: localhost TCP port (0 =
        ephemeral); exactly one. ``max_requests`` and the "close" message end
        the loop (tests, drain before an upgrade). A device fault (see
        ``is_device_fault``) propagates out of the loop.
        """
        if (socket_path is None) == (port is None):
            raise ValueError("exactly one of socket_path/port required")
        if socket_path is not None:
            try:  # crash-only restart: a killed daemon leaves the file
                os.unlink(socket_path)
            except OSError:
                pass
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(socket_path)
        else:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.bind(("127.0.0.1", port))
        srv.listen(1)
        if on_ready is not None:
            on_ready(srv.getsockname())
        closing = False
        try:
            while not closing:
                conn, _ = srv.accept()
                try:
                    while True:
                        try:
                            header = json.loads(_recv_block(conn).decode())
                            payload = _recv_block(conn)
                            if not isinstance(header, dict):
                                raise ValueError("header must be an object")
                        except (ConnectionError, json.JSONDecodeError,
                                UnicodeDecodeError, ValueError):
                            break  # client gone or garbled: drop the connection
                        try:
                            resp, closing = self._handle(header, payload)
                        except Exception as e:  # a request's error is served back
                            if is_device_fault(e):
                                raise
                            resp, closing = {"ok": False, "error": str(e)}, False
                        self.requests_served += 1
                        try:
                            _send_block(conn, json.dumps(resp).encode())
                        except OSError:
                            break  # client vanished mid-reply: drop, re-accept
                        if closing or (max_requests is not None
                                       and self.requests_served >= max_requests):
                            closing = True
                            break
                finally:
                    conn.close()
        finally:
            srv.close()
            if socket_path is not None:
                try:
                    os.unlink(socket_path)
                except OSError:
                    pass
        return self.requests_served


class TrackingClient:
    """Blocking client for ``TrackingServer`` (either package's).

    >>> with TrackingClient(socket_path="/tmp/w2t.sock") as c:
    ...     recs = c.step(jpeg_bytes, timestamp_micros=123)
    """

    def __init__(self, socket_path: Optional[str] = None, port: Optional[int] = None):
        if (socket_path is None) == (port is None):
            raise ValueError("exactly one of socket_path/port required")
        if socket_path is not None:
            self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._conn.connect(socket_path)
        else:
            self._conn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._conn.connect(("127.0.0.1", port))

    def _roundtrip(self, header: dict, payload: bytes = b"") -> dict:
        send_message(self._conn, header, payload)
        resp = recv_response(self._conn)
        if not resp.get("ok"):
            raise RuntimeError(f"server error: {resp.get('error')}")
        return resp

    def step(self, frame, timestamp_micros: int) -> dict:
        """frame: JPEG bytes or an HxWx3 uint8 array (sent raw); against a
        multicam server, a list of N such frames (the rig's one tick)."""
        if isinstance(frame, (list, tuple)):
            if all(isinstance(f, np.ndarray) for f in frame):
                arr = np.stack([np.ascontiguousarray(f, np.uint8) for f in frame])
                header = {"type": "frame", "timestamp_micros": timestamp_micros,
                          "shape": list(arr.shape)}
                payload = arr.tobytes()
            else:
                blobs = [bytes(f) for f in frame]
                header = {"type": "frame", "timestamp_micros": timestamp_micros,
                          "jpeg_lens": [len(b) for b in blobs]}
                payload = b"".join(blobs)
        elif isinstance(frame, np.ndarray):
            header = {"type": "frame", "timestamp_micros": timestamp_micros,
                      "shape": list(frame.shape)}
            payload = np.ascontiguousarray(frame, np.uint8).tobytes()
        else:
            header = {"type": "frame", "timestamp_micros": timestamp_micros}
            payload = bytes(frame)
        return self._roundtrip(header, payload)

    def reset(self, context_name: Optional[str] = None) -> None:
        header = {"type": "reset"}
        if context_name is not None:
            header["context_name"] = context_name
        self._roundtrip(header)

    def stats(self) -> dict:
        return self._roundtrip({"type": "stats"})

    def snapshot(self) -> dict:
        """{"blob": bytes, "context_name": str}: feed to ``restore`` on a
        fresh server of the same tracker config to continue identities."""
        import base64

        r = self._roundtrip({"type": "snapshot"})
        return {"blob": base64.b64decode(r["snapshot"]),
                "context_name": r.get("context_name")}

    def restore(self, blob: bytes, context_name: Optional[str] = None) -> None:
        header = {"type": "restore"}
        if context_name is not None:
            header["context_name"] = context_name
        self._roundtrip(header, bytes(blob))

    def close_server(self) -> None:
        self._roundtrip({"type": "close"})

    def close(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
