"""Device milliseconds of the Swin window-attention kernel
(``csrc/window_attention.cu``, every launch in the stretch) per real
camera-frame of the stretch."""


def read(view):
    frames = view.info.get("cam_frames", 0)
    runs = view.trace.kernels("window_attention")
    if not frames or not runs:
        return None
    return sum(e - s for s, e, _ in runs) * 1e-3 / frames
