"""The port's ``parallel/`` modules at a world of 2 ranks (gloo on the CPU,
one spawn for the file, ``run_ranks``): ``make_mesh``, ``shard_batch`` rows
against the JAX array's addressable shards on a mesh of 2 virtual devices,
``replicate``, the refusals (a world ``model_parallel`` does not divide, NCCL
on ranks that share a device), the ring-sharded gallery against JAX's
``ring_gallery_topmatch`` on a mesh of 2 (the three cases of
``tests/distributed/test_ring_gallery.py`` and exact ties, where the first
shard visited wins), and ``link`` with ``mesh=`` against the dense scoring
on ``tests/distributed/test_link.py``'s galleries. Ring similarities within
1e-6 (two products of float32), indices exact."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.parallel import sharding as jshd
from waymo_2d_tracking_tpu.parallel.ring import ring_gallery_topmatch as jax_ring

from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
from waymo_2d_tracking_tpu_torch.pipeline import link
from waymo_2d_tracking_tpu_torch.tools import rank_cases

torch.set_num_threads(1)

WORLD = 2


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def ring_cases(world: int):
    """(queries, gallery, valid) of the JAX ring tests, and an exact-tie
    case: basis vectors, so equal rows score exactly equal in every shard."""
    rng = np.random.default_rng(0)
    dense = (_norm(rng.normal(0, 1, (16, 32))), _norm(rng.normal(0, 1, (64, 32))),
             rng.uniform(size=64) > 0.2)
    rng = np.random.default_rng(1)
    invalid = (_norm(rng.normal(0, 1, (8, 16))), _norm(rng.normal(0, 1, (32, 16))),
               np.zeros(32, bool))
    g = _norm(np.random.default_rng(2).normal(0, 1, (64, 32)))
    self_match = (g[np.arange(0, 64, 4)], g, np.ones(64, bool))
    eye = np.eye(8, dtype=np.float32)
    ties = (eye[np.arange(2 * world) % 3], eye[np.arange(4 * world) % 3], np.ones(4 * world, bool))
    return [dense, invalid, self_match, ties]


def make_cams(e=8):
    """``tests/distributed/test_link.py``'s galleries: (1, 10) and (2, 20)
    share an appearance, the others are random."""
    rng = np.random.default_rng(0)
    unit = lambda v: (v / np.linalg.norm(v)).astype(np.float32)   # noqa: E731
    shared = unit(rng.standard_normal(e))
    return {1: (np.array([10, 11]), np.stack([shared, unit(rng.standard_normal(e))])),
            2: (np.array([20, 21]), np.stack([shared, unit(rng.standard_normal(e))]))}


LINK_CAMS = [(make_cams(16), 0.9), (make_cams(8), 0.9), (make_cams(8), 1.1)]


def write_link_dir(out: str, cams, e: int = 8) -> None:
    """Track files and gallery sidecars as ``run_segments`` writes them."""
    for cam, (ids, emb) in cams.items():
        recs = [subm.TrackRecord.from_xyxy("ctxL", 1000 * t, cam, f"{cam}_{tid}", 1,
                                           (10, 10, 20, 20), 0.9)
                for tid in ids for t in range(2)]
        subm.write_jsonl(os.path.join(out, f"ctxL_{cam}.jsonl"), recs)
        track_id = np.full(4, -1, np.int32)
        status = np.zeros(4, np.int8)
        embed = np.zeros((4, e), np.float32)
        track_id[:2], status[:2], embed[:2] = ids, 2, emb
        np.savez(os.path.join(out, f"ctxL_{cam}.gallery.npz"), track_id=track_id,
                 status=status, embed=embed)


def jax_ring_results(cases, world: int):
    mesh = jshd.make_mesh(n_devices=world)
    out = []
    for q, g, v in cases:
        sim, idx = jax_ring(jnp.asarray(q), jnp.asarray(g), jnp.asarray(v), mesh)
        out.append((np.asarray(sim), np.asarray(idx)))
    return out


def check_rings(got_by_rank, cases, world: int):
    want = jax_ring_results(cases, world)
    for got in got_by_rank:
        for (gs, gi), (ws, wi) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gs, ws, atol=1e-6, rtol=0)
    # ties: the first shard a block visits wins, so a query of a block that
    # starts past shard 0 takes the copy in its own shard, not the lowest index
    q, g, v = cases[3]
    _, idx = got_by_rank[0][3]
    dense_first = (q @ g.T).argmax(axis=1)
    assert (idx != dense_first).any() and (idx == dense_first).any()
    assert (q[np.arange(len(q))] @ g[idx].T).diagonal().min() == 1.0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    out = str(d / "link")
    os.makedirs(out)
    write_link_dir(out, make_cams())
    store = str(d / "stores")
    os.makedirs(store)
    calls = [("mesh_case", ("cpu", store)),
             ("ring_case", ("cpu", ring_cases(WORLD), LINK_CAMS,
                            [(out, os.path.join(out, "linked_ring"), 0.9)]))]
    res = run_ranks(rank_cases.run_all, WORLD, calls, device="cpu", threads=1, timeout=240,
                    workdir=str(d / "ranks"))
    return {"mesh": [r["results"][0] for r in res], "ring": [r["results"][1] for r in res],
            "dir": out,
            "cases": ring_cases(WORLD)}


def test_shard_batch_rows_equal_jax_addressable_shards(ranks):
    x = np.arange(WORLD * 6, dtype=np.float32).reshape(WORLD * 3, 2)
    for mp, key in ((1, "rows"), (2, "rows_mp2")):
        mesh = jshd.make_mesh(n_devices=WORLD, model_parallel=mp)
        arr = jshd.shard_batch({"x": x}, mesh)["x"]
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r, res in enumerate(ranks["mesh"]):
            data, model = res["coord_mp2" if mp == 2 else "coord"]
            assert (data, model) == divmod(r, mp)
            np.testing.assert_array_equal(res[key], by_dev[mesh.devices[data, model]])
        if mp == 1:
            for res in ranks["mesh"]:
                np.testing.assert_array_equal(res["rows_y"], res["rows"][:, 0])


def test_replicate_gives_rank0_bits_everywhere(ranks):
    for res in ranks["mesh"]:
        np.testing.assert_array_equal(res["replicated"], np.full(4, 0.5, np.float32))
    assert [res["writer"] for res in ranks["mesh"]] == [True] + [False] * (WORLD - 1)


def test_make_mesh_refuses_worlds_that_do_not_fit(ranks):
    for res in ranks["mesh"]:
        assert len(res["refusals"]) == 2
        assert f"not divisible by model_parallel={WORLD + 1}" in res["refusals"][0]
        assert f"n_devices={WORLD + 1}" in res["refusals"][1]


def test_nccl_refused_where_ranks_share_a_device(ranks):
    for res in ranks["mesh"]:
        assert "NCCL takes one rank a device" in res["nccl"] and "cuda:0" in res["nccl"]


def test_ring_equals_jax_at_two_shards(ranks):
    check_rings([r["rings"] for r in ranks["ring"]], ranks["cases"], WORLD)
    # the dense oracle of the JAX test, and -1 where nothing is valid
    sim, idx = ranks["ring"][0]["rings"][0]
    q, g, v = ranks["cases"][0]
    dense = q @ g.T
    dense[:, ~v] = -np.inf
    np.testing.assert_allclose(sim, dense.max(axis=1), atol=1e-5)
    assert (ranks["ring"][1]["rings"][1][1] == -1).all()
    np.testing.assert_array_equal(ranks["ring"][0]["rings"][2][1], np.arange(0, 64, 4))


def test_link_with_mesh_equals_dense(ranks, tmp_path):
    for res in ranks["ring"]:
        for (rows, mapping), (cams, th) in zip(res["matches"], LINK_CAMS):
            dense = link.best_cross_camera_matches(cams)
            assert [r[:4] for r in rows] == [r[:4] for r in dense]
            np.testing.assert_allclose([r[4] for r in rows], [r[4] for r in dense], atol=1e-6)
            assert mapping == link.link_context(cams, threshold=th)
    want = link.link_tracks(ranks["dir"], linked_dir=str(tmp_path / "dense"), threshold=0.9)
    for res in ranks["ring"]:
        got = res["reports"][0]
        assert {k: v for k, v in got.items() if k != "out"} == \
            {k: v for k, v in want.items() if k != "out"}
        assert got["cross_camera_merges"] == 1
    for name in sorted(os.listdir(tmp_path / "dense")):
        ring_file = os.path.join(ranks["dir"], "linked_ring", name)
        assert open(ring_file).read() == open(tmp_path / "dense" / name).read()
    assert set(ranks["ring"][0]["launches"].values()) == {0}
