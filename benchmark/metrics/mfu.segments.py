"""The whole step's share of the card's bf16 dense peak, in %: the
detector's FLOPs per image (counted on the reference at the cell's shapes,
ReID crops included) times the real camera-frames of the stretch, over the
stretch's seconds and 989 TFLOP/s."""


def read(view):
    w, frames = view.trace.window_s(), view.info.get("cam_frames", 0)
    if w <= 0 or not frames or not view.trace.device:
        return None
    return 100.0 * view.flops_per_image * frames / (w * view.peaks.BF16_FLOPS_PER_S)
