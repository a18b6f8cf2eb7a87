"""The ``jpeg_segments`` runner on a tiny bank: the frames are encoded in
set-up, the program decodes them at 1/``decode_scale_denom`` in its
prefetch worker, and the check gets frames that OpenCV decoded apart from
the program, already at the scaled size, with ``denom`` 1."""
import threading

import numpy as np
import torch

from benchmark.harness import check, core, frames, spec

torch.set_num_threads(1)
SEED = 2 ** 32 + 6007
# the two decoders' largest difference on a pixel's channel (libjpeg-turbo's
# DCT-scaled decode in the program's shim and in OpenCV)
DECODERS_MAX_DIFF = 0


def test_encode_and_both_decoders_agree(tiny_cell):
    cell = tiny_cell("tiny.jpeg_segments")
    drv = spec.runner(cell)
    hw = tuple(cell["traffic"]["source_hw"])
    bank, _ = frames.draw_bank(SEED, 1, 1, 6, (2, 4), hw, "cpu")
    blobs = drv.encode(bank.numpy(), cell["traffic"]["jpeg"])[0][0]
    assert len(blobs) == 6 and all(b[:2] == b"\xff\xd8" for b in blobs)
    ref = drv.reference_decode(blobs, 2)
    prog = drv.program_decode(blobs, 2, hw)
    assert ref.shape == prog.shape == (6, hw[0] // 2, hw[1] // 2, 3)
    assert int(np.abs(ref.astype(np.int16) - prog.astype(np.int16)).max()) <= DECODERS_MAX_DIFF
    # the decode is of these frames: near their 2 x 2 means
    means = bank.numpy()[0, 0].reshape(6, hw[0] // 2, 2, hw[1] // 2, 2, 3).mean((2, 4))
    assert np.abs(ref - means).mean() < 8


def test_the_program_decodes_in_its_worker_and_the_check_gets_half_size(tiny_cell, monkeypatch):
    from waymo_2d_tracking_tpu_torch.data.jpeg import BatchJpegDecoder
    cell = tiny_cell("tiny.jpeg_segments")
    hw = tuple(cell["traffic"]["source_hw"])
    threads = set()
    decode = BatchJpegDecoder.decode

    def noted(self, jpegs):
        threads.add(threading.current_thread() is threading.main_thread())
        return decode(self, jpegs)
    monkeypatch.setattr(BatchJpegDecoder, "decode", noted)
    seen = {}
    compare = check.compare

    def kept(ref, model, cfg, samples, tracks, device):
        seen["samples"], seen["tracks"] = samples, tracks
        return compare(ref, model, cfg, samples, tracks, device)
    monkeypatch.setattr(check, "compare", kept)

    out = core.result_line(cell, core.run(cell, SEED, 1.0, False, "cpu"))
    assert out["correct"], out["checks"]
    assert False in threads                         # a worker thread decoded
    half = (hw[0] // 2, hw[1] // 2)
    for s in seen["samples"]:
        assert s.denom == 1 and tuple(s.frames().shape[1:3]) == half
    for u in seen["tracks"]:
        assert u.denom == 1 and tuple(u.frames(0).shape[1:3]) == half
    assert out["seen"]["jpeg decoders' largest pixel difference"] <= DECODERS_MAX_DIFF
    assert out["seen"]["jpeg bytes a frame"] > 0
    assert out["seen"]["records"] > 0

