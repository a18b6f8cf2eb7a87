"""Share in % of the stretch's device-idle time during which the driving
thread is in none of the program's ``w2t/`` spans below the unit's own
(``w2t/segment``, ``w2t/group``, ``w2t/tick``): the idle the program's
spans leave unnamed."""
from benchmark.harness.trace import clip, merged

UNITS = ("w2t/segment", "w2t/group", "w2t/tick")


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(view):
    tr = view.trace
    lo, hi = tr.window
    named = merged(clip([(s, e) for s, e, n in tr.host_ops.get(tr.main_tid, [])
                         if n.startswith("w2t/") and n not in UNITS], lo, hi))
    if not named or not tr.device:
        return None
    busy = tr.busy_spans()
    idle = (hi - lo) - sum(e - s for s, e in busy)
    if idle <= 0:
        return None
    named_idle = sum(e - s for s, e in named) - _overlap(named, busy)
    return 100.0 * (idle - named_idle) / idle
