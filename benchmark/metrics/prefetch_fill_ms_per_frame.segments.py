"""Host milliseconds the prefetch worker spends per real camera-frame on a
chunk (taking it from the source, the transform, the copy into pinned
memory and the copy's launch): the program's counter ``prefetch_fill_s``
over its ``frames_real``, both counted over the traced stretch alone."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    fill, frames = c.get("prefetch_fill_s"), c.get("frames_real")
    if fill is None or not frames:
        return None
    return fill * 1e3 / frames
