"""Over the traced ticks, the share in % of each tick's span, from its due
time to its records on the host, with nothing running on the device."""


def read(view):
    ticks = view.trace.ranges.get("tick", [])
    spans = view.info.get("tick_spans", [])
    if not ticks or len(ticks) != len(spans) or not view.trace.device:
        return None
    total = idle = 0.0
    for (ts, _), (due, done) in zip(sorted(ticks), spans):
        lo, hi = ts + due, ts + done
        total += hi - lo
        idle += (hi - lo) - view.trace.busy_s(lo, hi) * 1e6
    return 100.0 * idle / total if total > 0 else None
