"""Share in % of the detector's output slots that carry a detection the
tracker could birth a track from: the program's counter ``det_birth``
(valid detections scored at or above the tracker's birth gate, summed on
the device over the real frames, read once) over the slots of the real
camera-frames, D each. The valid slots alone (``det_valid``) fill all D
under the benchmark's weights, so they would show no change."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    dets, frames = c.get("det_birth"), c.get("frames_real")
    if dets is None or not frames:
        return None
    return 100.0 * dets / (view.cfg["detector"]["max_detections"] * frames)
