"""The auction kernel's share of its roofline, in %: the least time its
launches need, counted from their inputs (each problem's n x n float32
benefit read once, its n assignments written once, n^2 operations), over
the kernels' device time. A launch carries one problem a camera at the
side the program pads to (64 up to 64 rows or columns, else a multiple of
128)."""


def read(view):
    runs = view.trace.kernels("auction")
    busy = sum(e - s for s, e, _ in runs) * 1e-6
    if not runs or busy <= 0:
        return None
    t = view.cfg["tracker"]
    m = max(t["max_tracks"], t["max_detections"])
    n = 64 if m <= 64 else -(-max(m, 128) // 128) * 128
    cams = len(view.cfg["pipeline"]["cameras"])
    least = len(runs) * view.peaks.least_seconds(*view.peaks.auction_work(cams, n))
    return 100.0 * least / busy
