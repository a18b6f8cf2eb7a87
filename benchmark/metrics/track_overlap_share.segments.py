"""Share of the chunks the tracker ran on its own stream beside the next
chunk's staging and forward: 100 x the program's counter
``track_overlapped`` (chunks for which the previous chunk's tracker work,
in the same graph cache, was still running when the chunk was handed to
the tracker, its own staging and forward already queued) over
``track_chunks`` (chunks tracked on the tracker stream), both counted over
the traced stretch alone. None where the program has no such counters or
tracked no chunk there."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    overlapped, chunks = c.get("track_overlapped"), c.get("track_chunks")
    if overlapped is None or not chunks:
        return None
    return 100.0 * overlapped / chunks
