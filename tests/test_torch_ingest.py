"""The port's JPEG / TFRecord ingest (``data/{_native,jpeg,tfrecord_native,
waymo}.py``, ``SegmentFrames.jpeg_frames``, the online sessions' frame
decoder) against the JAX package's on the CPU: the cases of
``tests/unit/test_jpeg_native.py`` and ``tests/unit/test_waymo_data.py``,
the committed fixture segment's decoded hashes, and JPEG sources giving the
records of the same frames decoded.

The port builds its shims from ``native/*.cpp`` into its own ``_build/``;
the JAX package's decoder (its own build under ``native/``) is the
reference decode here.
"""
import hashlib
import json
import os
import subprocess
import tempfile

import cv2
import jax
import numpy as np
import pytest
import torch
from flax import serialization

from waymo_2d_tracking_tpu.config import (
    Config as JaxConfig,
    DetectorConfig as JaxDetectorConfig,
    PipelineConfig as JaxPipelineConfig,
    TrackerConfig as JaxTrackerConfig,
)
from waymo_2d_tracking_tpu.data import jpeg as jax_jpeg
from waymo_2d_tracking_tpu.data import tfrecord_native as jax_tfr
from waymo_2d_tracking_tpu.data import waymo as jax_waymo
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
from waymo_2d_tracking_tpu.pipeline.run import SegmentFrames as JaxFrames
from waymo_2d_tracking_tpu.pipeline.run import SegmentPipeline as JaxPipeline

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data import _native, jpeg, tfrecord_native, waymo
from waymo_2d_tracking_tpu_torch.io_out.submission import read_jsonl
from waymo_2d_tracking_tpu_torch.pipeline.online import OnlineTracker, _FrameDecoder
from waymo_2d_tracking_tpu_torch.pipeline.multicam import MultiCamPipeline
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR, fixture_state_dict

from test_torch_pipeline import DET_KW, TRK_KW

# xdist runs several workers on the machine's cores; one torch thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = json.load(open(os.path.join(FIXTURES_DIR, "ingest_fixture.json")))
FIXTURE_PATH = os.path.join(ROOT, FIXTURE["tfrecord"])


def _encode(img, quality=90, progressive=False):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality] + (
        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if progressive else [])
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], flags)
    assert ok
    return enc.tobytes()


@pytest.fixture(scope="module")
def jpegs():
    """tests/unit/test_jpeg_native.py's images: 16 smooth 96x128 frames."""
    rng = np.random.default_rng(0)
    return [_encode(cv2.GaussianBlur(rng.integers(0, 255, (96, 128, 3), dtype=np.uint8),
                                     (7, 7), 3)) for _ in range(16)]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


# ------------------------------------------------------------------- decode

@pytest.mark.parametrize("denom", [1, 2, 4])
def test_decode_bytes_equal_to_jax_decoder(denom, jpegs):
    """The port's decoder gives the JAX package's native decoder's bytes, at
    full size and at libjpeg's 1/2 and 1/4 scaled decode, odd sizes included
    (ceil(src / denom))."""
    rng = np.random.default_rng(denom)
    odd = [_encode(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), q)
           for h, w, q in ((66, 98, 90), (97, 131, 75), (31, 47, 95))]
    for batch in (jpegs[:6], *([b] for b in odd)):
        h, w = jpeg.jpeg_dims(batch[0])
        sh, sw = -(-h // denom), -(-w // denom)
        dec = jpeg.BatchJpegDecoder(sh, sw, n_threads=2, scale_denom=denom)
        ref = jax_jpeg.BatchJpegDecoder(sh, sw, n_threads=2, native=True, scale_denom=denom)
        assert ref.is_native
        try:
            got, want = dec.decode(batch), ref.decode(batch)
        finally:
            dec.close()
            ref.close()
        assert got.shape == (len(batch), sh, sw, 3) and got.any()
        np.testing.assert_array_equal(got, want)


def test_corrupt_and_mismatched_input_zeroed(jpegs):
    dec = jpeg.BatchJpegDecoder(96, 128, n_threads=2)
    out = dec.decode([jpegs[0], b"not a jpeg", jpegs[1][: len(jpegs[1]) // 4]])
    assert out[0].any() and not out[1].any()
    wrong = jpeg.BatchJpegDecoder(64, 64, n_threads=2)      # other dimensions
    assert not wrong.decode(jpegs[:2]).any()
    for d in (dec, wrong):
        d.close()
    with pytest.raises(RuntimeError, match="closed"):
        dec.decode(jpegs[:1])
    with pytest.raises(ValueError, match="scale_denom"):
        jpeg.BatchJpegDecoder(8, 8, scale_denom=3)


def test_jpeg_dims_header_probe(jpegs):
    assert jpeg.jpeg_dims(jpegs[0]) == (96, 128)
    for h, w in [(1280, 1920), (886, 1920), (31, 47)]:
        for progressive in (False, True):
            enc = _encode(np.zeros((h, w, 3), np.uint8), 80, progressive)
            assert jpeg.jpeg_dims(enc) == jax_jpeg.jpeg_dims(enc) == (h, w)
    for bad in (b"not a jpeg at all", jpegs[0][:8]):
        with pytest.raises(ValueError):
            jpeg.jpeg_dims(bad)


def test_frame_decoder_adapts_to_resolution_change(jpegs):
    small = _encode(np.random.default_rng(3).integers(0, 255, (48, 64, 3), dtype=np.uint8))
    dec = _FrameDecoder(scale_denom=2)
    try:
        a, denom = dec.decode_batch([jpegs[0]])
        assert a.shape == (1, 48, 64, 3) and a.any() and denom == 2
        b, _ = dec.decode_batch([small])          # a new stream, another size
        assert b.shape == (1, 24, 32, 3) and b.any()
        with pytest.raises(ValueError, match="mixed-resolution"):
            dec.decode_batch([jpegs[0], small])
        arr = np.zeros((5, 7, 3), np.uint8)
        out, denom = dec.decode_batch([arr])
        assert out.shape == (1, 5, 7, 3) and denom == 1
    finally:
        dec.close()


def test_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """The port compiles ``native/*.cpp`` with the compiler straight into its
    build directory: no ``make``, no output under ``native/``."""
    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **k):
        calls.append((list(cmd), k.get("cwd")))
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(subprocess, "run", spy)
    for name in _native.SHIMS:
        path = _native.build(name)
        assert os.path.dirname(path) == str(tmp_path / "build") and os.path.exists(path)
    native_dir = os.path.realpath(_native.NATIVE_DIR)
    assert len(calls) == len(_native.SHIMS)
    for cmd, cwd in calls:
        assert "make" not in os.path.basename(cmd[0]) and cwd is None
        out = cmd[cmd.index("-o") + 1]
        assert os.path.realpath(out).startswith(str(tmp_path / "build"))
        assert not os.path.realpath(out).startswith(native_dir)
        assert [s for s in cmd if s.endswith(".cpp")][0].startswith(_native.NATIVE_DIR)
    assert sorted(f.endswith(".so") for f in os.listdir(tmp_path / "build")) == [True, True]


def test_shim_that_cannot_load_or_build_raises(tmp_path, monkeypatch):
    """No fallback: a shim whose library cannot be loaded (a libjpeg missing
    on the machine) or built raises a RuntimeError naming it."""
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))

    def no_dlopen(path):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    monkeypatch.setattr(_native.ctypes, "CDLL", no_dlopen)
    with pytest.raises(RuntimeError, match="libjpeg.so.62"):
        jpeg.BatchJpegDecoder(8, 8)
    monkeypatch.setitem(_native.SHIMS, "w2t_jpeg", ("jpeg_decode.cpp", ("-lw2t_no_such_lib",)))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build2"))
    with pytest.raises(RuntimeError, match="jpeg_decode.cpp failed"):
        jpeg.BatchJpegDecoder(8, 8)


# ---------------------------------------------------------------- TFRecord

def test_tfrecord_round_trip_crc_and_frame_proto(tmp_path):
    path = str(tmp_path / "x.tfrecord")
    records = [b"hello", b"", b"a" * 1000]
    waymo.write_tfrecord(path, records)
    assert list(waymo.read_tfrecord(path, verify_crc=True)) == records
    assert list(jax_waymo.read_tfrecord(path, verify_crc=True)) == records
    jax_waymo.write_tfrecord(str(tmp_path / "j"), records)
    assert open(path, "rb").read() == open(str(tmp_path / "j"), "rb").read()
    assert waymo._crc32c(b"\x00" * 32) == 0x8A9136AA      # RFC 3720 vector
    labels = {1: [{"id": "obj1", "type": 1, "xyxy": (10.0, 20.0, 50.0, 60.0)}]}
    frame = waymo.encode_frame("ctx123", 1234567, images={1: b"jpegdata", 2: b"other"},
                               labels=labels)
    assert frame == jax_waymo.encode_frame("ctx123", 1234567,
                                           images={1: b"jpegdata", 2: b"other"}, labels=labels)
    parsed = waymo.parse_frame(frame)
    assert parsed == jax_waymo.parse_frame(frame)
    assert parsed["context_name"] == "ctx123" and parsed["timestamp"] == 1234567
    np.testing.assert_allclose(parsed["labels"][1][0]["xyxy"], (10, 20, 50, 60))


def _jax_python_walk(tmp_path, monkeypatch, cameras):
    """The JAX package's iter_segments through its pure-Python walker."""
    monkeypatch.setattr(jax_tfr, "index", lambda *a, **k: None)
    monkeypatch.setattr(jax_tfr, "meta", lambda *a, **k: None)
    monkeypatch.setattr(jax_tfr, "extract", lambda *a, **k: None)
    out = {s.camera_name: (list(s.timestamps), s.jpeg_frames[0:len(s.jpeg_frames)])
           for s in jax_waymo.iter_segments(str(tmp_path), cameras=cameras)}
    monkeypatch.undo()
    return out


def test_native_scanner_parity_with_python_walker(tmp_path, monkeypatch):
    """Index, timestamps (> 2^32), camera presence (a record without a camera,
    one with empty image bytes) and extracted bytes equal the JAX package's
    pure-Python walk of the same file."""
    jpeg_bytes = _encode(np.random.default_rng(5).integers(0, 255, (24, 32, 3), np.uint8))
    frames = [waymo.encode_frame("ctxN", 7_000_000_000_000 + 100 * t,
                                 images=({1: jpeg_bytes, 2: jpeg_bytes} if t % 3 == 0
                                         else {1: jpeg_bytes} if t % 3 == 1
                                         else {1: b"", 2: jpeg_bytes}))
              for t in range(9)]
    path = str(tmp_path / "seg.tfrecord")
    waymo.write_tfrecord(path, frames)
    positions = waymo.index_tfrecord(path)
    offset, walked = 0, []
    for rec in frames:
        walked.append((offset + 12, len(rec)))
        offset += 12 + len(rec) + 4
    assert positions == walked
    got = {s.camera_name: (list(s.timestamps), s.jpeg_frames[0:len(s.jpeg_frames)])
           for s in waymo.iter_segments(str(tmp_path), cameras=("FRONT", "FRONT_LEFT"))}
    want = _jax_python_walk(tmp_path, monkeypatch, ("FRONT", "FRONT_LEFT"))
    assert got == want and len(got[1][0]) == len(got[2][0]) == 6


def test_native_scanner_rejects_corrupt_tfrecord(tmp_path):
    """A corrupt file fails catchably: no record indexed, and meta / extract
    raise instead of handing back a wrong answer (there is no Python
    fallback in the port)."""
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes((1 << 40).to_bytes(8, "little") + b"\x00" * 40)
    assert tfrecord_native.index(str(bad)) == []
    with pytest.raises(OSError):
        tfrecord_native.meta(str(bad), 1, 2, 4, 1, 2, [1])
    with pytest.raises(OSError):
        tfrecord_native.extract(str(bad), 10**9, 100, 4, 1, 1, 2)


def test_tfrecord_lazy_and_directory_segments(tmp_path):
    """Per-camera bytes stream lazily a chunk at a time from a TFRecord and
    from a directory segment; ``source_hw`` reads one header, once."""
    rng = np.random.default_rng(2)
    t_total, chunk = 12, 4
    jpegs = [_encode(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)) for _ in range(t_total)]
    tfr_dir = tmp_path / "tfr"
    tfr_dir.mkdir()
    waymo.write_tfrecord(str(tfr_dir / "seg.tfrecord"), [
        waymo.encode_frame("ctxL", 100 * t, images={1: jpegs[t], 2: jpegs[t]})
        for t in range(t_total)])
    segs = list(waymo.iter_segments(str(tfr_dir), cameras=("FRONT", "FRONT_LEFT")))
    assert [s.camera_name for s in segs] == [1, 2]
    for seg in segs:
        lazy = seg.jpeg_frames
        assert isinstance(lazy, waymo.TfrecordCameraJpegs) and lazy.records_read == 0
        it = seg.chunk_iter(chunk)
        assert next(it).shape == (chunk, 32, 48, 3)
        assert lazy.records_read <= chunk + 1, lazy.records_read
        it.close()
    assert segs[0].jpeg_frames[3] == jpegs[3] and segs[1].jpeg_frames[5:8] == jpegs[5:8]

    seg_dir = tmp_path / "dir" / "ctxD"
    (seg_dir / "frames").mkdir(parents=True)
    for t in range(3):
        (seg_dir / "frames" / f"{t}_1.jpg").write_bytes(jpegs[t])
    (seg_dir / "meta.json").write_text(json.dumps(
        {"context_name": "ctxD", "cameras": {"FRONT": 1}, "timestamps": [0, 100, 200]}))
    (seg,) = waymo.iter_segments(str(tmp_path / "dir"))
    assert isinstance(seg.jpeg_frames, waymo.DirectoryCameraJpegs)
    assert seg.jpeg_frames.files_read == 0
    assert seg.source_hw() == seg.source_hw() == (32, 48) and seg.scaled_hw(2) == (16, 24)
    assert seg.jpeg_frames.files_read == 1          # one header probe, cached
    np.testing.assert_array_equal(next(seg.chunk_iter(3)),
                                  jpeg.BatchJpegDecoder(32, 48).decode(jpegs[:3]))


# ----------------------------------------------------------- the fixture

def test_fixture_segment_reads_and_decodes_to_committed_hashes():
    """The committed TFRecord (16 FRONT frames at 1280x1920) through the
    port: index, metadata, extracted bytes (equal to the Python walk) and
    the SHA-256 of its decode at denom 1 and 2."""
    assert os.path.getsize(FIXTURE_PATH) == FIXTURE["bytes"] <= 2_000_000
    (seg,) = [s for s in waymo.iter_segments(os.path.dirname(FIXTURE_PATH))
              if s.context_name == FIXTURE["context_name"]]
    assert list(seg.timestamps) == FIXTURE["timestamps"]
    blobs = seg.jpeg_frames[0:len(seg.jpeg_frames)]
    walked = [waymo.parse_frame(r, want_labels=False)["images"][FIXTURE["camera"]]
              for r in waymo.read_tfrecord(FIXTURE_PATH, verify_crc=True)]
    assert blobs == walked and [_sha(b) for b in blobs] == FIXTURE["jpeg_sha256"]
    assert seg.source_hw() == tuple(FIXTURE["height_width"])
    for denom in ("1", "2"):
        block = next(seg.chunk_iter(len(blobs), scale_denom=int(denom)))
        assert block.shape[1:3] == seg.scaled_hw(int(denom))
        assert [_sha(f.tobytes()) for f in block] == FIXTURE["decoded_sha256"][denom]


def _fixture_cfg(denom: int):
    return Config(detector=DetectorConfig(**DET_KW), tracker=TrackerConfig(**TRK_KW),
                  pipeline=PipelineConfig(chunk_frames=8, interp_max_gap=0,
                                          decode_scale_denom=denom))


def _scaled_records(records, factor):
    return [(r.timestamp_micros, r.object_id, r.object_type, r.score,
             r.center_x * factor, r.center_y * factor, r.length * factor, r.width * factor)
            for r in records]


def _fixture_segment():
    (seg,) = [s for s in waymo.iter_segments(os.path.dirname(FIXTURE_PATH))
              if s.context_name == FIXTURE["context_name"]]
    return seg


def test_run_segment_jpeg_frames_match_jax_and_decoded_frames():
    """The fixture segment's JPEG bytes at ``decode_scale_denom`` 2 through
    the port's ``run_segment`` (decoded in the prefetch worker at 1/2):
    JAX's records on the same bytes (ids exact, boxes to 0.2 px, as the
    port's pipeline test), and exactly the records of the same frames
    decoded first and passed as arrays at denom 1, in 1280x1920 pixels
    (twice their coordinates)."""
    seg = _fixture_segment()
    sd = fixture_state_dict("pixels_detector")
    records, _ = SegmentPipeline(_fixture_cfg(2), sd, device="cpu").run_segment(seg)
    assert records
    decoded = next(seg.chunk_iter(seg.num_frames, scale_denom=2))
    arrays, _ = SegmentPipeline(_fixture_cfg(1), sd, device="cpu").run_segment(
        SegmentFrames(seg.context_name, seg.camera_name, seg.timestamps, decoded))
    assert _scaled_records(records, 1.0) == _scaled_records(arrays, 2.0)

    jdet = JaxDetectorConfig(**DET_KW)
    template = jax.jit(lambda k: JaxRunner(jdet).init_params(k, batch_size=1))(
        jax.random.PRNGKey(0))
    with open(os.path.join(ROOT, "tests", "fixtures", "pixels_detector.msgpack"), "rb") as f:
        variables = serialization.from_bytes(template, f.read())
    jcfg = JaxConfig(detector=jdet, tracker=JaxTrackerConfig(**TRK_KW),
                     pipeline=JaxPipelineConfig(chunk_frames=8, interp_max_gap=0,
                                                decode_scale_denom=2))
    jrecords, _ = JaxPipeline(jcfg, params=variables).run_segment(JaxFrames(
        context_name=seg.context_name, camera_name=seg.camera_name,
        timestamps=list(seg.timestamps), jpeg_frames=seg.jpeg_frames[0:seg.num_frames]))
    ts = list(seg.timestamps)
    got = {t: sorted((r.object_id, r.to_xyxy()) for r in records if r.timestamp_micros == t)
           for t in ts}
    want = {t: sorted((r.object_id, r.to_xyxy()) for r in jrecords if r.timestamp_micros == t)
            for t in ts}
    for t in ts:
        assert [i for i, _ in got[t]] == [i for i, _ in want[t]], f"frame {t}"
        if got[t]:
            np.testing.assert_allclose([b for _, b in got[t]], [b for _, b in want[t]],
                                       atol=0.2, err_msg=f"frame {t}")


def test_online_and_multicam_jpeg_bytes_match_decoded_frames():
    """An ``OnlineTracker`` fed the fixture's JPEG bytes (decoded by its
    session decoder at denom 2) gives exactly what it gives on the same
    frames decoded first (at twice the coordinates); a two-camera
    ``run_segments_group`` of JPEG segments gives each camera the
    single-camera JPEG run's ids."""
    seg = _fixture_segment()
    sd = fixture_state_dict("pixels_detector")
    n = 8
    blobs = seg.jpeg_frames[0:n]
    decoded = next(seg.chunk_iter(n, scale_denom=2))
    runs = []
    for frames in (blobs, decoded):
        sess = OnlineTracker(_fixture_cfg(2), sd, device="cpu")
        recs = []
        for t in range(n):
            recs.extend(sess.step(frames[t], t))
        sess.close()
        runs.append(recs)
    assert runs[0] and _scaled_records(runs[0], 1.0) == _scaled_records(runs[1], 2.0)

    single, _ = SegmentPipeline(_fixture_cfg(2), sd, device="cpu").run_segment(seg)
    with tempfile.TemporaryDirectory() as out:
        MultiCamPipeline(_fixture_cfg(2), num_cams=2, state_dict=sd, device="cpu") \
            .run_segments_group([SegmentFrames("mc", c, seg.timestamps, jpeg_frames=seg.jpeg_frames)
                                 for c in (1, 2)], out)
        for cam in (1, 2):
            got = read_jsonl(os.path.join(out, f"mc_{cam}.jsonl"))
            # object ids are "<camera>_<track id>"
            key = lambda r: (r.timestamp_micros, r.object_id.split("_", 1)[1])   # noqa: E731
            assert sorted(map(key, got)) == sorted(map(key, single))


def test_chip_smoke_ingest_phase_on_the_cpu(capsys):
    """``chip_smoke.py``'s ingest phase, JPEG half included (libjpeg is here),
    on the CPU with a small int8 preset: the branch the card runs where its
    machine has libjpeg."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    preset = {"detector": {"backbone": "resnet18slim", "image_size": [64, 96],
                           "fpn_channels": 32, "fpn_levels": [3, 4, 5], "head_depth": 1,
                           "embed_dim": 16, "reid_channels": 32, "max_detections": 8,
                           "score_threshold": 0.01, "quant": "int8"},
              "tracker": {"max_tracks": 16, "max_detections": 8, "embed_dim": 16,
                          "score_threshold": 0.0, "birth_score_threshold": 0.0, "n_init": 1},
              "pipeline": {"chunk_frames": 8, "decode_scale_denom": 2}}
    assert smoke.phase_ingest(np, torch, "cpu", preset, device="cpu")
    out = capsys.readouterr().out
    assert "16 of 16 frames' SHA-256 equal" in out and "exactly the" in out


# ------------------------------------------- the second way to find libjpeg

SYSTEM_LIBJPEG = "/lib/x86_64-linux-gnu/libjpeg.so.62"


def _pillow_route_lib():
    return _native.pillow_libjpeg()


@pytest.mark.parametrize("which", ["system-so-by-path", "pillow-bundled"])
def test_jpeg_shim_through_vendored_headers_decodes_the_fixture(which, tmp_path, monkeypatch):
    """With no system ``jpeglib.h`` in reach, the shim is compiled against
    the vendored 62-ABI headers and linked by full path (the system's
    libjpeg 62, or the libjpeg-turbo that Pillow carries); it passes the
    probe check and decodes the fixture to the committed SHA-256 at denom 1,
    2 and 4."""
    lib = SYSTEM_LIBJPEG if which == "system-so-by-path" else _pillow_route_lib()
    if lib is None or not os.path.exists(lib):
        pytest.skip(f"no {which} libjpeg on this machine")
    calls = []
    real_run = subprocess.run

    def spy(cmd, *a, **k):
        calls.append(list(cmd))
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(_native, "SYSTEM_INCLUDE_DIRS", (str(tmp_path / "no-include"),))
    monkeypatch.delenv("CPATH", raising=False)
    monkeypatch.delenv("CPLUS_INCLUDE_PATH", raising=False)
    monkeypatch.setattr(_native, "pillow_libjpeg", lambda: lib)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(subprocess, "run", spy)
    assert _native.jpeg_route()[0] == "pillow"
    seg = _fixture_segment()
    blobs = seg.jpeg_frames[0:len(seg.jpeg_frames)]
    for denom in ("1", "2", "4"):
        h, w = (-(-s // int(denom)) for s in FIXTURE["height_width"])
        dec = jpeg.BatchJpegDecoder(h, w, scale_denom=int(denom))
        got = [_sha(f.tobytes()) for f in dec.decode(blobs)]
        dec.close()
        assert got == FIXTURE["decoded_sha256"][denom], denom
    (cmd,) = [c for c in calls if any(a.endswith("jpeg_decode.cpp") for a in c)]
    assert "-ljpeg" not in cmd and lib in cmd and f"-Wl,-rpath,{os.path.dirname(lib)}" in cmd
    assert cmd[cmd.index("-I") + 1] == _native.JPEG62_HEADERS
    with open("/proc/self/maps") as f:
        assert os.path.realpath(lib) in f.read()


def test_jpeg_shim_without_any_libjpeg_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "SYSTEM_INCLUDE_DIRS", (str(tmp_path / "no-include"),))
    monkeypatch.delenv("CPATH", raising=False)
    monkeypatch.delenv("CPLUS_INCLUDE_PATH", raising=False)
    monkeypatch.setattr(_native, "pillow_libjpeg", lambda: None)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="needs libjpeg"):
        jpeg.BatchJpegDecoder(8, 8)


def test_jpeg_shim_that_fails_the_probe_is_refused(monkeypatch):
    """A shim whose libjpeg refuses every frame (headers and library of
    other ABIs) leaves frames zero and reports 0 decoded: the probe check
    refuses it, and it is not cached."""

    class Refusing:
        def w2t_decoder_create(self, n):
            return 1

        def w2t_decoder_destroy(self, h):
            pass

        def w2t_decode_batch_scaled(self, *args):
            return 0

    with pytest.raises(RuntimeError, match="does not decode the probe"):
        jpeg._check_probe(Refusing())
    monkeypatch.setattr(_native, "_LIBS", {})
    monkeypatch.setattr(jpeg, "_configure", lambda lib: None)
    monkeypatch.setattr(_native.ctypes, "CDLL", lambda path: Refusing())
    with pytest.raises(RuntimeError, match="does not decode the probe"):
        jpeg.BatchJpegDecoder(8, 8)
    assert "w2t_jpeg" not in _native._LIBS
