"""Fixed-slot SORT-family tracker (counterpart of ``tracker/``)."""
from waymo_2d_tracking_tpu_torch.tracker.tracker import (  # noqa: F401
    Tracker,
    init_multicam_state,
    init_state,
    track_segment,
    track_step,
)
