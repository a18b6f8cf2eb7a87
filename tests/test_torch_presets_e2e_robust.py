"""``configs/robust.yaml`` end to end through the port's ``SegmentPipeline``
against the JAX package's, on the CPU: the headline's architecture narrowed
to the slim detector of ``test_torch_presets_e2e.py`` (whose docstring
states the reduction and the tolerances), its tracker and pipeline sections
as shipped: S = D = 64, the auction with ReID recovery over a gallery of 4,
BYTE at 0.1 and buffered IoU at 0.3 (three association stages a frame),
chunk 128 and ``decode_scale_denom`` 2. The 12 source frames are 128x192,
decoded at 64x96, one chunk padded to 128 frames.

On these 12 frames neither knob changes a record (the records equal those
of the same run with either knob off, probed): what this holds is that the
three-stage step runs alike in both packages. The knobs' effect is held by
``test_torch_presets_occl.py`` and ``test_torch_hostile_knobs.py``."""
from test_torch_presets_e2e import compare_single_camera


def test_robust_preset_matches_jax():
    cfg, _ = compare_single_camera("robust.yaml", (128, 192), num_frames=12)
    t = cfg.tracker
    assert (t.byte_low_threshold, t.iou_buffer, t.gallery_size, cfg.pipeline.chunk_frames,
            cfg.pipeline.decode_scale_denom) == (0.1, 0.3, 4, 128, 2)
