"""Device milliseconds of the tracker layer per traced tick."""


def read(view):
    ticks = view.info.get("ticks", 0)
    if not ticks or not any(d[3] == "tracker" for d in view.trace.device):
        return None
    return view.trace.layer_s("tracker") * 1e3 / ticks
