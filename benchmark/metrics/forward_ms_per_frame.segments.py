"""Device milliseconds of the detector layer (the forward, candidates, NMS,
RoIAlign and the ReID tower) per real camera-frame of the stretch."""


def read(view):
    frames = view.info.get("cam_frames", 0)
    if not frames or not any(d[3] == "detector" for d in view.trace.device):
        return None
    return view.trace.layer_s("detector") * 1e3 / frames
