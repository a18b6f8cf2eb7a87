"""The port's tracker against the JAX package's on two more hostile clips,
the regimes of the BYTE second association and of buffered IoU: exact
``valid`` and ids, boxes within 0.2 px, equal MOT metrics (see
``test_torch_hostile.py``; the cases are split over two files so that the
test workers share them)."""
import pytest

from test_torch_hostile import compare_on_clip


@pytest.mark.parametrize("clip_name,cfg_name", [("occl_dips", "byte"),
                                                ("curved_pan", "byte_biou")])
def test_knob_ids_equal_jax(clip_name, cfg_name):
    compare_on_clip(clip_name, cfg_name)
