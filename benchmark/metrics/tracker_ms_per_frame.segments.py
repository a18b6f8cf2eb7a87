"""Device milliseconds of the tracker layer (the captured step's replays)
per real camera-frame of the stretch."""


def read(view):
    frames = view.info.get("cam_frames", 0)
    if not frames or not any(d[3] == "tracker" for d in view.trace.device):
        return None
    return view.trace.layer_s("tracker") * 1e3 / frames
