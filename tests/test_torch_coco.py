"""The port's training input and detection AP against the JAX package on the
CPU: ``convert_segments_to_coco`` (the same annotations and the JPEG bytes
as they are, TFRecord and directory segments), ``CocoTrainDataset
.make_batch`` on a tiny COCO directory of rendered frames (boxes, classes,
validity and track ids exact; images within 1e-4 after the normalisation,
for cv2's float ``INTER_LINEAR``, which ``resize_linear`` reproduces to
within 3e-6 on [0, 1] values), the worker-parallel and prefetched streams,
``evaluate_detections`` (equal to JAX's), and the synthetic batch makers
and clip generator (the same arrays from the same seeds).
"""
import io
import json
import os
from itertools import islice

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from waymo_2d_tracking_tpu.data import coco as jcoco
from waymo_2d_tracking_tpu.data import synthetic as jsyn
from waymo_2d_tracking_tpu.eval import ap as jap
from waymo_2d_tracking_tpu.data.waymo import materialize_directory_segment
from waymo_2d_tracking_tpu.io_out import submission as jsubm

from waymo_2d_tracking_tpu_torch.data import coco as pcoco
from waymo_2d_tracking_tpu_torch.data import synthetic as psyn
from waymo_2d_tracking_tpu_torch.data.waymo import encode_frame, write_tfrecord
from waymo_2d_tracking_tpu_torch.eval import ap as pap

torch.set_num_threads(1)

HW = (72, 104)


def _jpeg(frame) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """Two TFRecord segments of rendered frames with labels (ids reused
    across the two, as real segments do) and one directory segment."""
    root = tmp_path_factory.mktemp("segs")
    for s, seed in enumerate((3, 4)):
        frames, gt = psyn.render_video_clip(
            psyn.SyntheticClipConfig(num_frames=4, num_objects=5, image_size=(720, 1040),
                                     seed=seed), render_hw=HW)
        records = []
        for t in range(len(frames)):
            labs = [{"xyxy": tuple(float(v) for v in gt["boxes"][t, k]), "type": (1, 2, 4)[k % 3],
                     "id": f"obj{k}"} for k in np.flatnonzero(gt["present"][t])]
            records.append(encode_frame(f"ctx{s}", 100_000 * t, {1: _jpeg(frames[t])},
                                        {1: labs}))
        write_tfrecord(str(root / f"seg{s}.tfrecord"), records)
    frames, gt = psyn.render_video_clip(
        psyn.SyntheticClipConfig(num_frames=3, num_objects=4, image_size=(720, 1040), seed=9),
        render_hw=HW)
    labels = [jsubm.TrackRecord.from_xyxy("ctxD", 1000 * t, 1, f"obj{k}", 2,
                                          tuple(gt["boxes"][t, k]), 1.0)
              for t in range(3) for k in np.flatnonzero(gt["present"][t])]
    materialize_directory_segment(str(root), "ctxD", frames,
                                  [1000 * t for t in range(3)], labels=labels)
    return str(root)


@pytest.fixture(scope="module")
def coco_dirs(segments, tmp_path_factory):
    out = tmp_path_factory.mktemp("coco")
    j, p = str(out / "jax"), str(out / "port")
    assert jcoco.convert_segments_to_coco(segments, j) == pcoco.convert_segments_to_coco(segments, p)
    return j, p


def test_convert_segments_to_coco_matches_jax(coco_dirs):
    j, p = coco_dirs
    with open(os.path.join(j, "annotations.json")) as f:
        want = json.load(f)
    with open(os.path.join(p, "annotations.json")) as f:
        got = json.load(f)
    assert got == want and len(got["images"]) == 11 and got["annotations"]
    for im in got["images"]:
        with open(os.path.join(j, "images", im["file_name"]), "rb") as a, \
                open(os.path.join(p, "images", im["file_name"]), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scale_range=(0.6, 1.4), color_jitter=0.2, flip_augment=True),
    dict(scale_range=(1.3, 1.8), sample_by_context=True, max_gt=4),
])
def test_make_batch_matches_jax(coco_dirs, kw):
    j, p = coco_dirs
    args = dict(batch_size=4, image_hw=(64, 96), seed=5, **kw)
    jd, pd = jcoco.CocoTrainDataset(j, **args), pcoco.CocoTrainDataset(p, **args)
    for i in range(3):
        want, got = jd.make_batch(i), pd.make_batch(i)
        assert set(got) == set(want)
        for k in ("gt_boxes", "gt_classes", "gt_valid", "gt_track_ids"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["images"].dtype == np.float32
        np.testing.assert_allclose(got["images"], want["images"], atol=1e-4, rtol=0)
    assert got["gt_valid"].any()


def test_resize_linear_matches_cv2():
    rng = np.random.default_rng(0)
    for h, w, oh, ow in ((48, 64, 30, 41), (48, 64, 97, 130), (37, 53, 37, 80), (20, 30, 200, 301)):
        img = rng.random((h, w, 3), dtype=np.float32)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(pcoco.resize_linear(img, (oh, ow)), want, atol=3e-6, rtol=0)
    np.testing.assert_array_equal(pcoco.resize_linear(img, img.shape[:2]), img)


def test_batch_streams_deterministic_and_prefetched(coco_dirs):
    _, p = coco_dirs
    kw = dict(batch_size=2, image_hw=(32, 48), seed=7, scale_range=(0.8, 1.2), color_jitter=0.2)
    sync = list(islice(pcoco.CocoTrainDataset(p, **kw).batches(num_workers=0), 4))
    par = list(islice(pcoco.CocoTrainDataset(p, **kw).batches(num_workers=3), 4))
    it = pcoco.coco_batch_iterator(p, num_workers=2, prefetch_depth=2, device="cpu", **kw)
    pre = list(islice(it, 4))
    it.close()
    for b0, b1, b2 in zip(sync, par, pre):
        for k in b0:
            np.testing.assert_array_equal(b0[k], b1[k], err_msg=k)
            assert isinstance(b2[k], torch.Tensor)
            np.testing.assert_array_equal(b2[k].numpy(), b0[k], err_msg=k)


def _dets(seed, n_img=6):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for i in range(n_img):
        g = rng.integers(0, 6)
        gb = np.sort(rng.uniform(0, 300, (g, 4)), axis=1)[:, [0, 1, 2, 3]]
        gb[:, 2:] = gb[:, :2] + rng.uniform(5, 150, (g, 2))
        gc = rng.integers(0, 3, g)
        d = rng.integers(0, 8)
        db = np.concatenate([gb + rng.normal(0, 6, gb.shape),
                             rng.uniform(0, 300, (max(d - g, 0), 4))])[:d]
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        dc = np.concatenate([gc, rng.integers(0, 3, max(d - g, 0))])[:d]
        ds = np.round(rng.uniform(0, 1, d), 2)         # ties in score order
        preds.append(((0, i), db, ds, dc))
        gts.append(((0, i), gb, gc))
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_detections_equals_jax(seed):
    preds, gts = _dets(seed)
    want = jap.evaluate_detections(preds, gts, num_classes=3)
    got = pap.evaluate_detections(preds, gts, num_classes=3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    recs = [jsubm.TrackRecord.from_xyxy("c", 10 * i, 1, str(d), (1, 2, 4)[int(c)], tuple(b), s)
            for (_, i), bb, ss, cc in preds for d, (b, s, c) in enumerate(zip(bb, ss, cc))]
    assert pap.records_to_frames(recs, True).__repr__() == jap.records_to_frames(recs, True).__repr__()


def test_synthetic_batches_and_clips_match_jax():
    for make_j, make_p in ((lambda r: jsyn.render_detection_batch(r, 3, (48, 64)),
                            lambda r: psyn.render_detection_batch(r, 3, (48, 64))),):
        want, got = make_j(np.random.default_rng(1)), make_p(np.random.default_rng(1))
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_pixels_fixture", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "train_pixels_fixture.py"))
    # the JAX tool enables a compile cache at import; read its two batch
    # makers' source instead of importing it
    ns = {"np": np, "draw_rect_objects": jsyn.draw_rect_objects}
    src = open(spec.origin).read()

    class _Det:
        image_size = (256, 384)

    ns["PIXELS_DET"] = _Det
    for name in ("random_rect_batch", "random_rect_batch_reid"):
        start = src.index(f"def {name}(")
        end = src.index("\ndef ", start + 1) if name == "random_rect_batch_reid" else \
            src.index("\nTEX_AMP", start)
        exec(compile(src[start:end], spec.origin, "exec"), ns)
    ns["TEX_AMP"] = 0.25
    for name in ("random_rect_batch", "random_rect_batch_reid"):
        want = ns[name](np.random.default_rng(2), 3)
        got = getattr(psyn, name)(np.random.default_rng(2), 3)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    frames = [[([0, 0, 10, 10], 0.9, 1)], [], [([1, 2, 3, 4], 0.5, 0), ([5, 5, 9, 9], 0.7, 2)]]
    want, got = jsyn.scripted_detections(frames), psyn.scripted_detections(frames)
    for k in ("boxes", "scores", "classes", "embeds", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    for kw in (dict(num_frames=20, seed=3),
               dict(num_frames=30, num_objects=20, seed=31, accel=0.35, pan_amplitude=90.0,
                    occlusion_dip=True, lifespan_frac=(0.2, 0.7), distance_noise=True,
                    ghost_prob=0.12, dip_window=(5, 9), image_size=(640, 960))):
        (dj, gj), (dp, gp) = (jsyn.generate_clip(jsyn.SyntheticClipConfig(**kw)),
                              psyn.generate_clip(psyn.SyntheticClipConfig(**kw)))
        for k in ("boxes", "scores", "classes", "embeds", "valid"):
            np.testing.assert_array_equal(getattr(dp, k).numpy(), np.asarray(getattr(dj, k)))
        for k in gj:
            np.testing.assert_array_equal(gp[k], gj[k])
