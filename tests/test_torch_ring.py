"""The ring-sharded gallery at a world of 4 ranks (gloo on the CPU, one
spawn for the file) against JAX's ``ring_gallery_topmatch`` on a mesh of 4
virtual devices: the same shard count, so the same visiting order and the
same winner under exact ties. The cases and tolerances are
``tests/test_torch_parallel.py``'s, and ``link`` with ``mesh=`` equals the
dense scoring at this world too (padding to sizes 4 divides)."""
import os

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
from waymo_2d_tracking_tpu_torch.pipeline import link
from waymo_2d_tracking_tpu_torch.tools import rank_cases

from test_torch_parallel import LINK_CAMS, check_rings, make_cams, ring_cases, write_link_dir

torch.set_num_threads(1)

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    out = str(d / "link")
    os.makedirs(out)
    write_link_dir(out, make_cams())
    res = run_ranks(rank_cases.ring_case, WORLD, "cpu", ring_cases(WORLD), LINK_CAMS,
                    [(out, os.path.join(out, "linked_ring"), 0.9)], device="cpu", threads=1,
                    timeout=240, workdir=str(d / "ranks"))
    return {"res": res, "dir": out}


def test_ring_equals_jax_at_four_shards(ranks):
    check_rings([r["rings"] for r in ranks["res"]], ring_cases(WORLD), WORLD)


def test_link_with_mesh_equals_dense_at_four(ranks, tmp_path):
    for res in ranks["res"]:
        for (rows, mapping), (cams, th) in zip(res["matches"], LINK_CAMS):
            dense = link.best_cross_camera_matches(cams)
            assert [r[:4] for r in rows] == [r[:4] for r in dense]
            np.testing.assert_allclose([r[4] for r in rows], [r[4] for r in dense], atol=1e-6)
            assert mapping == link.link_context(cams, threshold=th)
        assert res["reports"][0]["cross_camera_merges"] == 1
    link.link_tracks(ranks["dir"], linked_dir=str(tmp_path / "dense"), threshold=0.9)
    for name in sorted(os.listdir(tmp_path / "dense")):
        ring_file = os.path.join(ranks["dir"], "linked_ring", name)
        assert open(ring_file).read() == open(tmp_path / "dense" / name).read()
