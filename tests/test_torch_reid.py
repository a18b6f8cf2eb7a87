"""ReID stage-2 recovery through the port's whole slice on the CPU: the
trained ReID fixture, rendered seed-29 clip with a 22-frame occlusion
(``tests/golden/test_reid_recovery.py``), recovery ON must beat OFF."""
from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.synthetic import (
    SyntheticClipConfig,
    render_video_clip,
)
from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
from waymo_2d_tracking_tpu_torch.pipeline.run import SegmentFrames, SegmentPipeline
from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict

from test_torch_pipeline import records_to_frames

DET = DetectorConfig(
    backbone="resnet18slim", image_size=(256, 384), fpn_channels=32,
    fpn_levels=(3, 4, 5), head_depth=2, head_channels=32,
    pre_nms_topk=128, nms_topk=256, max_detections=32, embed_dim=32,
    dtype="float32", score_threshold=0.3,
)
CLIP = SyntheticClipConfig(
    num_frames=100, num_objects=6, image_size=(1024, 1536), seed=29,
    occlusion_gap=(30, 52), texture_amp=0.25,
)
TRK_KW = dict(
    max_tracks=32, max_detections=32, embed_dim=32,
    n_init=2, max_age=5, max_lost_age=30, iou_threshold=0.3,
    score_threshold=0.55, birth_score_threshold=0.65, birth_iou_threshold=0.3,
)


def test_reid_recovery_beats_off_through_port():
    frames, gt = render_video_clip(CLIP)
    sd = fixture_state_dict("pixels_detector_reid")
    ts = list(range(CLIP.num_frames))

    def run(**kw):
        cfg = Config(detector=DET, tracker=TrackerConfig(**{**TRK_KW, **kw}),
                     pipeline=PipelineConfig(chunk_frames=16, interp_max_gap=0))
        records, _ = SegmentPipeline(cfg, sd, device="cpu").run_segment(
            SegmentFrames("recovery", 1, ts, frames))
        return evaluate_mot(gt_to_frames(gt), records_to_frames(records, len(ts)))

    off = run()
    on = run(reid_recovery=True, appearance_gate=0.3, gallery_size=4)
    assert on.idf1 >= off.idf1 + 0.05, (off.as_dict(), on.as_dict())
    assert on.num_idsw <= off.num_idsw, (off.num_idsw, on.num_idsw)
    assert on.mota >= off.mota - 0.01, (off.as_dict(), on.as_dict())
