"""The port's serving daemon (``pipeline/server.py``, ``cli serve``) against
the JAX package's: the JAX serve tests' cases on the port, the two packages'
clients and servers speaking to each other, records equal to the JAX
server's on the same frames and weights, and tracker snapshots moving
between the two servers."""
import io
import json
import os
import socket as socketlib
import threading
import time

import cv2
import jax
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import load_config as jax_load_config
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
from waymo_2d_tracking_tpu.pipeline import server as jserver

from waymo_2d_tracking_tpu_torch import cli
from waymo_2d_tracking_tpu_torch.config import load_config
from waymo_2d_tracking_tpu_torch.ops._cuda import KernelError
from waymo_2d_tracking_tpu_torch.pipeline import server
from waymo_2d_tracking_tpu_torch.pipeline.server import TrackingClient, TrackingServer
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

torch.set_num_threads(1)

# tests/integration/test_serve.py's tiny config
TINY = [
    "detector.backbone=resnet18slim", "detector.image_size=[64,96]",
    "detector.fpn_channels=32", "detector.head_depth=1",
    "detector.pre_nms_topk=32", "detector.max_detections=8",
    "detector.embed_dim=0", "detector.dtype=float32",
    "detector.score_threshold=0.01",
    "tracker.max_tracks=16", "tracker.max_detections=8",
    "tracker.embed_dim=0", "tracker.score_threshold=0.0",
    "tracker.birth_score_threshold=0.0", "tracker.n_init=1",
]
CPU = ["--device", "cpu"]


def _overrides(pairs=TINY):
    return cli._parse_overrides(pairs)


def _frames(n, hw=(64, 96), seed=0):
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 255, (n,) + hw + (3,), dtype=np.uint8)
    out[:, hw[0] // 4:hw[0] // 2, hw[1] // 4:hw[1] // 2] = 255   # a bright blob
    return out


def _jpeg(frame):
    return cv2.imencode(".jpg", frame[:, :, ::-1])[1].tobytes()


def _wait(path, th=None):
    for _ in range(2400):
        if os.path.exists(path):
            return
        if th is not None and not th.is_alive():
            break
        time.sleep(0.05)
    pytest.fail("server socket never appeared")


def _serve_cli(sock, argv):
    th = threading.Thread(target=cli.main, args=(["serve", "--socket", sock] + argv,),
                          daemon=True)
    th.start()
    _wait(sock, th)
    return th


def _serve_object(srv, sock, max_requests=100):
    th = threading.Thread(target=srv.serve, kwargs=dict(socket_path=sock,
                                                        max_requests=max_requests), daemon=True)
    th.start()
    _wait(sock, th)
    return th


@pytest.fixture(scope="module")
def pair():
    """One set of weights for both packages: (port cfg, port state dict,
    JAX cfg, JAX params)."""
    jcfg = jax_load_config(None, _overrides())
    params = JaxRunner(jcfg.detector).init_params(jax.random.PRNGKey(0), batch_size=1)
    sd = from_flax_numpy(jax.tree.map(np.asarray, jax.device_get(params)))
    return load_config(None, _overrides()), sd, jcfg, params


def _same_records(got, want, what):
    key = lambda r: (r["timestamp_micros"], r["camera_name"], r["object_id"])   # noqa: E731
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert [(key(r), r["object_type"], r["context_name"]) for r in got] == \
        [(key(r), r["object_type"], r["context_name"]) for r in want], what
    for g, w in zip(got, want):
        for k in ("center_x", "center_y", "length", "width"):
            assert abs(g[k] - w[k]) <= 0.2, (what, k, g, w)
        assert abs(g["score"] - w["score"]) <= 1e-4, (what, g, w)


def _same_snapshot(a: bytes, b: bytes) -> bool:
    """Two snapshots hold the same arrays (the zip members carry their write
    time, so the bytes of equal states may differ)."""
    with np.load(io.BytesIO(a)) as x, np.load(io.BytesIO(b)) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files)


def _continued(seen, got) -> bool:
    """Identities continue: ids already assigned carry on, and an id born
    now is numbered above every id seen (the counter was restored too)."""
    num = lambda oid: int(oid.rsplit("_", 1)[1])   # noqa: E731
    return bool(got & seen) and all(num(g) > max(map(num, seen)) for g in got - seen)


def test_serve_roundtrip(tmp_path):
    """Raw and JPEG frames, stats, reset with a context, close; the socket
    file is unlinked at shutdown."""
    sock = str(tmp_path / "w2t.sock")
    th = _serve_cli(sock, ["--max-requests", "20", "--warmup", "64", "96", "--set"] + TINY + CPU)
    frame = _frames(1)[0]
    with TrackingClient(socket_path=sock) as c:
        r1 = c.step(frame, timestamp_micros=100)
        assert r1["ok"] and r1["records"] and r1["latency_ms"] > 0
        assert all(rec["timestamp_micros"] == 100 for rec in r1["records"])
        assert c.step(_jpeg(frame), timestamp_micros=200)["ok"]
        assert c.stats()["stats"]["count"] == 2
        c.reset(context_name="ctxB")
        r3 = c.step(frame, timestamp_micros=300)
        assert r3["records"] and all(rec["context_name"] == "ctxB" for rec in r3["records"])
        c.close_server()
    th.join(timeout=60)
    assert not th.is_alive() and not os.path.exists(sock)


def test_serve_scaled_decode_roundtrip(tmp_path):
    """decode_scale_denom 2 over the wire: JPEG payloads decode scaled in the
    session, records map back to full-resolution pixels, and a raw
    full-resolution array still works in the same server."""
    sock = str(tmp_path / "sd.sock")
    th = _serve_cli(sock, ["--max-requests", "10", "--warmup", "128", "192", "--set"] + TINY
                    + ["pipeline.decode_scale_denom=2"] + CPU)
    frame = _frames(1, hw=(128, 192), seed=1)[0]
    with TrackingClient(socket_path=sock) as c:
        r = c.step(_jpeg(frame), timestamp_micros=100)
        assert r["records"]
        for rec in r["records"]:
            assert 0 <= rec["center_x"] <= 192 + 8 and 0 <= rec["center_y"] <= 128 + 8
        assert max(rec["center_x"] for rec in r["records"]) > 96 or \
            max(rec["length"] for rec in r["records"]) > 48
        assert c.step(frame, timestamp_micros=200)["ok"]
        c.close_server()
    th.join(timeout=60)
    assert not th.is_alive()


def test_serve_rejects_bad_message(tmp_path, pair):
    """A header that is not UTF-8 drops the connection, not the daemon; an
    unknown type is answered with ok false and the server serves on."""
    cfg, sd, _, _ = pair
    sock = str(tmp_path / "s.sock")
    th = _serve_object(TrackingServer(cfg, sd, device="cpu"), sock, max_requests=4)
    conn = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    conn.connect(sock)
    conn.sendall(server._LEN.pack(2) + b"\xff\xfe" + server._LEN.pack(0))
    try:
        data = conn.recv(4)
    except ConnectionResetError:
        data = b""
    assert data == b""
    conn.close()
    conn = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    conn.connect(sock)
    server.send_message(conn, {"type": "bogus"})
    resp = server.recv_response(conn)
    assert resp["ok"] is False and "bogus" in resp["error"]
    server.send_message(conn, {"type": "stats"})
    assert server.recv_response(conn)["ok"] is True
    server.send_message(conn, {"type": "close"})
    assert server.recv_response(conn)["ok"] is True
    conn.close()
    th.join(timeout=30)
    assert not th.is_alive()


def test_device_fault_ends_the_daemon(tmp_path, pair, monkeypatch):
    """A kernel or CUDA failure is not served back: the accept loop
    re-raises it (the CLI then exits non-zero); an ordinary error is served."""
    cfg, sd, _, _ = pair
    assert server.is_device_fault(KernelError("nms kernel launch failed: cudaError_t 700"))
    assert server.is_device_fault(RuntimeError("CUDA error: an illegal memory access"))
    assert not server.is_device_fault(RuntimeError("server error: bad shape"))
    assert not server.is_device_fault(ValueError("rig has 2 cameras"))
    srv = TrackingServer(cfg, sd, device="cpu")

    def launch_fails(*a, **k):
        raise KernelError("nms kernel launch failed: cudaError_t 700")

    monkeypatch.setattr(srv.sess, "step", launch_fails)
    sock = str(tmp_path / "f.sock")
    errors = []

    def run():
        try:
            srv.serve(socket_path=sock, max_requests=10)
        except KernelError as e:
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    _wait(sock, th)
    c = TrackingClient(socket_path=sock)
    with pytest.raises((ConnectionError, json.JSONDecodeError, RuntimeError, OSError)):
        c.step(_frames(1)[0], timestamp_micros=0)
    c.close()
    th.join(timeout=30)
    assert not th.is_alive() and len(errors) == 1 and not os.path.exists(sock)


def test_serve_multicam_roundtrip(tmp_path):
    """--multicam: one rig tick (raw and JPEG encodings) per message; a wrong
    rig size is an error and the server serves on."""
    sock = str(tmp_path / "mc.sock")
    th = _serve_cli(sock, ["--multicam", "--max-requests", "20", "--warmup", "64", "96",
                           "--set", 'pipeline.cameras=["FRONT","FRONT_LEFT"]'] + TINY + CPU)
    rig = list(_frames(2, seed=1))
    with TrackingClient(socket_path=sock) as c:
        r1 = c.step(rig, timestamp_micros=100)
        assert r1["records"] and {rec["camera_name"] for rec in r1["records"]} == {1, 2}
        assert c.step([_jpeg(f) for f in rig], timestamp_micros=200)["ok"]
        with pytest.raises(RuntimeError, match="cameras"):
            c.step(rig[:1], timestamp_micros=300)
        assert c.stats()["ok"]
        c.close_server()
    th.join(timeout=60)
    assert not th.is_alive()


def test_records_equal_jax_server_and_clients_cross(tmp_path, pair):
    """The same frames through the JAX server (driven by the port's client)
    and the port's server (driven by the JAX client): equal records, raw and
    JPEG, single camera."""
    cfg, sd, jcfg, params = pair
    frames = _frames(4, seed=2)
    js, ps = str(tmp_path / "jax.sock"), str(tmp_path / "port.sock")
    jth = _serve_object(jserver.TrackingServer(jcfg, params=params), js)
    pth = _serve_object(TrackingServer(cfg, sd, device="cpu"), ps)
    with TrackingClient(socket_path=js) as cj, jserver.TrackingClient(socket_path=ps) as cp:
        n = 0
        for t, f in enumerate(frames):
            payload = f if t % 2 == 0 else _jpeg(f)
            want, got = cj.step(payload, timestamp_micros=t), cp.step(payload, timestamp_micros=t)
            _same_records(got["records"], want["records"], f"frame {t}")
            n += len(got["records"])
        assert n > 0
        assert cp.stats()["stats"]["count"] == cj.stats()["stats"]["count"] == 4
        cj.close_server()
        cp.close_server()
    jth.join(timeout=60)
    pth.join(timeout=60)
    assert not jth.is_alive() and not pth.is_alive()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_moves_between_packages(tmp_path, pair, direction):
    """A snapshot taken after two frames on one package's server restores
    into the other's, field for field, and its next frame gives the records
    of the first server's next frame."""
    cfg, sd, jcfg, params = pair
    frames = _frames(3, seed=3)
    make = {"jax": lambda: jserver.TrackingServer(jcfg, params=params),
            "port": lambda: TrackingServer(cfg, sd, device="cpu")}
    src, dst = direction.split("_to_")
    a, b = make[src](), make[dst]()
    sa, sb = str(tmp_path / "a.sock"), str(tmp_path / "b.sock")
    tha, thb = _serve_object(a, sa), _serve_object(b, sb)
    with TrackingClient(socket_path=sa) as ca, TrackingClient(socket_path=sb) as cb:
        ca.reset(context_name="moved")
        seen = set()
        for t in range(2):
            seen |= {r["object_id"] for r in ca.step(frames[t], timestamp_micros=t)["records"]}
        snap = ca.snapshot()
        cb.restore(snap["blob"], context_name=snap["context_name"])
        again = cb.snapshot()
        assert _same_snapshot(again["blob"], snap["blob"])
        with np.load(io.BytesIO(snap["blob"])) as x:
            assert len(x.files) == 15 and x["arr_13"].dtype == np.int32
        assert again["context_name"] == "moved"
        want = ca.step(frames[2], timestamp_micros=2)["records"]
        got = cb.step(frames[2], timestamp_micros=2)["records"]
        _same_records(got, want, direction)
        assert _continued(seen, {r["object_id"] for r in got})
        with pytest.raises(RuntimeError, match="config|load|file|zip"):
            cb.restore(snap["blob"][: len(snap["blob"]) // 2])
        assert cb.stats()["ok"]
        ca.close_server()
        cb.close_server()
    tha.join(timeout=60)
    thb.join(timeout=60)


def test_serve_snapshot_restore_failover(tmp_path):
    """Failover on the port: server A's snapshot restores into a fresh,
    unwarmed server B byte for byte in every field, and the identities on
    B's next step were all assigned by A."""
    frame1, frame2, frame3 = _frames(3, seed=4)
    sa, sb = str(tmp_path / "a.sock"), str(tmp_path / "b.sock")
    tha = _serve_cli(sa, ["--max-requests", "50", "--warmup", "64", "96", "--set"] + TINY + CPU)
    with TrackingClient(socket_path=sa) as ca:
        seen = {r["object_id"] for r in ca.step(frame1, timestamp_micros=100)["records"]}
        seen |= {r["object_id"] for r in ca.step(frame2, timestamp_micros=200)["records"]}
        snap = ca.snapshot()
        ca.close_server()
    tha.join(timeout=60)
    assert snap["blob"] and seen
    thb = _serve_cli(sb, ["--max-requests", "50", "--set"] + TINY + CPU)
    with TrackingClient(socket_path=sb) as cb:
        assert not _same_snapshot(cb.snapshot()["blob"], snap["blob"])
        cb.restore(snap["blob"], context_name=snap["context_name"])
        again = cb.snapshot()
        assert _same_snapshot(again["blob"], snap["blob"])
        assert again["context_name"] == snap["context_name"]
        got = {r["object_id"] for r in cb.step(frame3, timestamp_micros=300)["records"]}
        assert _continued(seen, got), (seen, got)
        cb.close_server()
    thb.join(timeout=60)


def test_serve_state_file_persists_across_restart(tmp_path):
    """--state-file: written atomically on exit, restored at the next start
    with its context; a corrupt file does not block the restart."""
    state_file = str(tmp_path / "tracker.state")
    sock = str(tmp_path / "s.sock")
    frame = _frames(1)[0]
    argv = ["--max-requests", "20", "--state-file", state_file, "--warmup", "64", "96",
            "--set"] + TINY + CPU
    th = _serve_cli(sock, argv)
    with TrackingClient(socket_path=sock) as c:
        c.reset(context_name="ctxZ")
        c.step(frame, timestamp_micros=100)
        snap1 = c.snapshot()["blob"]
        c.close_server()
    th.join(timeout=30)
    assert _same_snapshot(open(state_file, "rb").read(), snap1)
    assert not os.path.exists(state_file + ".tmp")
    th = _serve_cli(sock, argv)
    with TrackingClient(socket_path=sock) as c:
        again = c.snapshot()
        assert _same_snapshot(again["blob"], snap1) and again["context_name"] == "ctxZ"
        c.close_server()
    th.join(timeout=30)
    with open(state_file, "wb") as f:
        f.write(b"garbage")
    th = _serve_cli(sock, argv)
    with TrackingClient(socket_path=sock) as c:
        assert c.stats()["ok"]
        c.close_server()
    th.join(timeout=30)
    assert not th.is_alive()
