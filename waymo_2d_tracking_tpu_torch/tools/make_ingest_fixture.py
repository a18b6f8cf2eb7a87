#!/usr/bin/env python3
"""Write the ingest fixture: one Waymo-format TFRecord segment for the JPEG /
TFRecord ingest tests, and the SHA-256 of its frames decoded here.

    python3 waymo_2d_tracking_tpu_torch/tools/make_ingest_fixture.py

The segment holds 16 frames of the FRONT camera at 1280x1920: the seed-5
synthetic clip rendered at 640x960 and upscaled 2x by pixel repetition,
JPEG-encoded with Pillow at the highest quality (from 90 down in steps of 5)
that keeps the file under ``MAX_BYTES``. Beside it,
``fixtures/ingest_fixture.json`` records the quality, the SHA-256 of each
frame's JPEG bytes and of its decode by the port's ``BatchJpegDecoder`` at
denom 1, 2 and 4 (libjpeg's DCT-scaled decode), and the libjpeg that decoded
them. It also writes ``fixtures/jpeg_probe.jpg``, a 24x40 JPEG of a few
hundred bytes with 4:2:0 chroma, and the SHA-256 of its decode: the decoder
checks a freshly loaded shim against it. Needs Pillow (for the encoder; the
port's sources import no cv2) and a libjpeg for the decoder shim.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MAX_BYTES = 1_900_000
CONTEXT = "ingest_fixture_seed5"
NUM_FRAMES = 16
FRAME_PERIOD_US = 100_000      # 10 Hz, as Waymo segments
PROBE_HW = (24, 40)


def render_frames():
    import numpy as np  # noqa: F401  (the render returns numpy arrays)

    from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip

    frames, _ = render_video_clip(SyntheticClipConfig(num_frames=NUM_FRAMES, num_objects=8,
                                                      seed=5), render_hw=(640, 960))
    return frames.repeat(2, axis=1).repeat(2, axis=2)


def shim_libjpeg() -> str:
    """The libjpeg the decoder shim is linked against (``ldd``)."""
    import subprocess

    from waymo_2d_tracking_tpu_torch.data import _native

    out = subprocess.run(["ldd", _native.build("w2t_jpeg")], capture_output=True, text=True).stdout
    paths = [ln.split("=>")[1].split()[0] for ln in out.splitlines()
             if "libjpeg" in ln and "=>" in ln]
    return ", ".join(os.path.realpath(p) for p in paths) or "unknown"


def encode_jpeg(frame, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def probe_image():
    """A smooth gradient with three coloured blocks: chroma upsampling and
    the IDCT both show in its bytes."""
    import numpy as np

    h, w = PROBE_HW
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx + yy) * 4 % 256], -1)
    img[4:12, 4:14] = (220, 30, 40)
    img[10:20, 18:30] = (20, 200, 60)
    img[2:9, 30:38] = (30, 40, 230)
    return img.astype(np.uint8)


def main() -> int:
    import PIL

    from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder
    from waymo_2d_tracking_tpu_torch.data.waymo import CAMERA_NAMES, encode_frame, write_tfrecord
    from waymo_2d_tracking_tpu_torch.weights import FIXTURES_DIR

    frames = render_frames()
    cam = CAMERA_NAMES["FRONT"]
    path = os.path.join(FIXTURES_DIR, "ingest_fixture.tfrecord")
    for quality in range(90, 0, -5):
        jpegs = [encode_jpeg(f, quality) for f in frames]
        records = [encode_frame(CONTEXT, t * FRAME_PERIOD_US, {cam: j})
                   for t, j in enumerate(jpegs)]
        write_tfrecord(path, records)
        if os.path.getsize(path) <= MAX_BYTES:
            break
    sha = lambda b: hashlib.sha256(b).hexdigest()   # noqa: E731
    decoded = {}
    for denom in (1, 2, 4):
        h, w = (-(-s // denom) for s in frames.shape[1:3])
        dec = BatchJpegDecoder(h, w, scale_denom=denom)
        decoded[str(denom)] = [sha(a.tobytes()) for a in dec.decode(jpegs)]
        dec.close()
    probe = encode_jpeg(probe_image(), 75)
    with open(os.path.join(FIXTURES_DIR, "jpeg_probe.jpg"), "wb") as f:
        f.write(probe)
    dec = BatchJpegDecoder(*PROBE_HW)
    probe_decoded = sha(dec.decode([probe])[0].tobytes())
    dec.close()
    meta = {
        "tfrecord": os.path.relpath(path, ROOT),
        "bytes": os.path.getsize(path),
        "context_name": CONTEXT,
        "camera": cam,
        "frames": NUM_FRAMES,
        "height_width": list(frames.shape[1:3]),
        "timestamps": [t * FRAME_PERIOD_US for t in range(NUM_FRAMES)],
        "source": "seed-5 synthetic clip (8 objects) rendered at 640x960, upscaled 2x",
        "jpeg_quality": quality,
        "jpeg_encoder": f"Pillow {PIL.__version__}",
        "jpeg_sha256": [sha(j) for j in jpegs],
        "decoded_sha256": decoded,
        "decoded_by": shim_libjpeg(),
        "probe": {"file": "jpeg_probe.jpg", "height_width": list(PROBE_HW),
                  "jpeg_sha256": sha(probe), "decoded_sha256": probe_decoded},
    }
    with open(os.path.join(FIXTURES_DIR, "ingest_fixture.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps({k: meta[k] for k in ("tfrecord", "bytes", "jpeg_quality", "decoded_by")}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
