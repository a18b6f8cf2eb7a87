"""Share of the traced stretch, in %, with no kernel or copy running on the
device (the union of the device intervals)."""


def read(view):
    w = view.trace.window_s()
    return 100.0 * (1.0 - view.trace.busy_s() / w) if w > 0 and view.trace.device else None
