"""Share of the chunks the driving thread took from the prefetcher that were
already queued when it asked, so that it did not block: 100 x the program's
counter ``prefetch_ready`` over ``prefetch_chunks``, both counted over the
traced stretch alone. Near 100 the card sets the pace; near 0 the prefetch
worker's fill does."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    ready, chunks = c.get("prefetch_ready"), c.get("prefetch_chunks")
    if ready is None or not chunks:
        return None
    return 100.0 * ready / chunks
