"""Host milliseconds per real camera-frame of the stretch in which the
driving thread waits for, or assembles, the next chunk's frames: the union
of the program's ``w2t/prefetch_wait`` (blocked on the prefetch worker) and
``w2t/stack`` (a rig's cameras taken and stacked) spans."""
from benchmark.harness.trace import clip, union_length

NAMES = ("w2t/prefetch_wait", "w2t/stack")


def read(view):
    tr, frames = view.trace, view.info.get("cam_frames", 0)
    spans = [(s, e) for s, e, n in tr.host_ops.get(tr.main_tid, []) if n in NAMES]
    if not frames or not spans:
        return None
    return union_length(clip(spans, *tr.window)) * 1e-3 / frames
