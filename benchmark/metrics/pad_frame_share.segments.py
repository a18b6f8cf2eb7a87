"""Share in % of the camera-frames the detector and tracker ran that were
pad frames (a unit's last chunk filled by repeating its last frame): the
program's counters ``frames_pad`` over ``frames_real`` + ``frames_pad``."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    pad, real = c.get("frames_pad"), c.get("frames_real")
    if pad is None or not real:
        return None
    return 100.0 * pad / (real + pad)
