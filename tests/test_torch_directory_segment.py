"""``data/waymo.py materialize_directory_segment`` against the JAX package's:
the same frames, cameras and labels give a byte-equal directory (JPEGs,
``meta.json``, ``labels.jsonl``), a second camera merges into the context's
``meta.json`` in both, a camera with other timestamps is refused, and the
port's ``iter_segments`` reads the written segment back."""
import os

import cv2
import numpy as np
import pytest

from waymo_2d_tracking_tpu.data import waymo as jwaymo
from waymo_2d_tracking_tpu.io_out.submission import TrackRecord as JaxTrackRecord

from waymo_2d_tracking_tpu_torch.data import waymo
from waymo_2d_tracking_tpu_torch.io_out.submission import TrackRecord


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _write(mod, record, out, frames, stamps):
    labels = [record.from_xyxy("ctx", int(stamps[t]), 1, f"{k}", 1 + k % 3,
                               (10.0 + t, 12.0 + k, 40.5 + t, 60.25 + k), 0.5 + 0.1 * k)
              for t in range(len(stamps)) for k in range(2)]
    seg = mod.materialize_directory_segment(out, "ctx", frames, stamps, camera_id=1,
                                            labels=labels, jpeg_quality=85)
    mod.materialize_directory_segment(out, "ctx", frames[:, ::-1], stamps, camera_id=2)
    mod.materialize_directory_segment(out, "ctx", frames[:, :, ::-1], stamps, camera_id=7)
    with pytest.raises(AssertionError, match="share timestamps"):
        mod.materialize_directory_segment(out, "ctx", frames, [s + 1 for s in stamps],
                                          camera_id=3)
    return seg


def test_directory_segment_byte_equal_to_jax_and_read_back(tmp_path):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:48, 0:64]
    ramp = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1)        # smooth, so JPEG keeps it
    frames = np.stack([ramp + 20 * t for t in range(3)])
    frames = np.clip(frames + rng.integers(0, 6, frames.shape), 0, 255).astype(np.uint8)
    stamps = [1_000_000 + 100_000 * t for t in range(3)]
    jseg = _write(jwaymo, JaxTrackRecord, str(tmp_path / "jax"), frames, stamps)
    seg = _write(waymo, TrackRecord, str(tmp_path / "port"), frames, stamps)
    assert os.path.basename(seg) == os.path.basename(jseg) == "ctx"
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    # 4 cameras x 3 frames (the refused camera's JPEGs are written before its
    # timestamps are checked, in both packages), meta.json, labels.jsonl
    assert len(got) == 4 * 3 + 2
    for name in want:
        assert got[name] == want[name], name

    segs = list(waymo.iter_segments(str(tmp_path / "port"), cameras=("FRONT", "FRONT_LEFT")))
    assert [(s.context_name, s.camera_name) for s in segs] == [("ctx", 1), ("ctx", 2)]
    for s, view in zip(segs, (frames, frames[:, ::-1])):
        assert list(s.timestamps) == stamps and s.num_frames == 3
        for t, jpg in enumerate(s.jpeg_frames[0:3]):
            assert jpg == got[os.path.join("ctx", "frames", f"{t}_{s.camera_name}.jpg")]
            rgb = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1]
            assert rgb.shape == view[t].shape
            # JPEG at quality 85: the decode is near the frame, not equal
            assert np.abs(rgb.astype(np.int16) - view[t]).mean() < 4
