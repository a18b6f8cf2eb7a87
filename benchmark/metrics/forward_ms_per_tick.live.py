"""Device milliseconds of the detector layer per traced tick."""


def read(view):
    ticks = view.info.get("ticks", 0)
    if not ticks or not any(d[3] == "detector" for d in view.trace.device):
        return None
    return view.trace.layer_s("detector") * 1e3 / ticks
