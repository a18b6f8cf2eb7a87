"""``configs/robust.yaml`` against ``configs/headline.yaml`` on the hostile
``occl_dips`` clip, the regime of robust's BYTE second association: each
preset's tracker section through the port's ``Tracker.run`` with ids equal
to the JAX package's (see ``test_torch_presets.py``), and robust ahead of
the headline by JAX's margins (``tests/golden/test_preset_quality.py``
``test_robust_preset_quality``): 0.05 MOTA and 0.04 IDF1. A file of its
own: the auctions of both packages on this 36-object clip take seconds a
run."""
from test_torch_presets import run_presets


def test_robust_beats_headline_on_occl_dips_with_ids_equal_jax():
    m = run_presets(("robust.yaml", "headline.yaml"), ("occl_dips",))
    r, h = m[("robust.yaml", "occl_dips")], m[("headline.yaml", "occl_dips")]
    assert r.mota >= h.mota + 0.05, (r.as_dict(), h.as_dict())
    assert r.idf1 >= h.idf1 + 0.04, (r.as_dict(), h.as_dict())
