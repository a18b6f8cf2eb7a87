"""Device milliseconds of the staging layer (host-to-device copies, the
decode downscale, the letterbox) per real camera-frame of the stretch."""


def read(view):
    frames = view.info.get("cam_frames", 0)
    if not frames or not any(d[3] == "staging" for d in view.trace.device):
        return None
    return view.trace.layer_s("staging") * 1e3 / frames
