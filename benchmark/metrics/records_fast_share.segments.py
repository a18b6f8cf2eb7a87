"""Share of the JSONL lines the records layer wrote from its template: 100 x
(1 - ``records_lines_slow`` / ``records_lines``), the program's counters of
the lines written and of those that fell back to ``json.dumps``, both
counted over the traced stretch alone. 100 is every line on the fast path;
None where the program has no such counters or wrote no line."""


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    c = _counters()
    lines, slow = c.get("records_lines"), c.get("records_lines_slow")
    if slow is None or not lines:
        return None
    return 100.0 * (1.0 - slow / lines)
