"""Share in % of the tracker's output slots that carry a valid track: the
program's counter ``track_live`` (valid slots of the fetched outputs over
the real frames) over the slots of the real camera-frames, S each."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    live, frames = c.get("track_live"), c.get("frames_real")
    if live is None or not frames:
        return None
    return 100.0 * live / (view.cfg["tracker"]["max_tracks"] * frames)
