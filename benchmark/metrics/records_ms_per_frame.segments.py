"""Host milliseconds of the records layer per real camera-frame of the
stretch: the union of the program's ``w2t/records`` spans on the driving
thread (the track records built from the fetched outputs, the track file,
the gallery sidecar, the manifest)."""
from benchmark.harness.trace import clip, union_length


def read(view):
    tr, frames = view.trace, view.info.get("cam_frames", 0)
    spans = [(s, e) for s, e, n in tr.host_ops.get(tr.main_tid, []) if n == "w2t/records"]
    if not frames or not spans:
        return None
    return union_length(clip(spans, *tr.window)) * 1e-3 / frames
