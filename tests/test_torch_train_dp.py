"""Data-parallel training (``DetectorTrainer(mesh=...)``) at a world of 2
ranks (gloo on the CPU, one spawn for the file) against the port's
single-device step on the same global batch, at the configuration of
``tests/distributed/test_train_sharded.py`` (slim detector, 64x96, FPN 32,
head depth 1, batch 8, float32), plain, with ``grad_accum_steps=2``, with
``remat`` and on a ReID batch under the triplet and the supervised
contrastive losses.

JAX's data-parallel step is the single-device step on the global batch, and
so is the port's; what can differ is the order of float32 sums. The
forward's BatchNorm statistics are the same bits (per-image sums gathered
and summed in one order), so they are held bit-equal, and no ReLU input
changes side. The backward sums each weight's gradient over the ranks'
images in another order. Measured on these batches: the loss within 2.2e-7
relative; the whole gradient (every tensor, the GroupNorm-fed conv biases
aside, whose gradient is zero analytically and noise in both) within 5e-6
relative L2, held to 1e-5; tensor by tensor (T1's measure in
``chip_smoke.py``) 4e-6 to 1.2e-5, the stem convolution's the largest, which
is the single-device step's own spread when the same batch's images are
merely reordered (up to 1.4e-5), held to 3e-5. After 3 steps parameters and
EMA are bit-equal across the ranks; a checkpoint saved under the mesh
restores on every rank."""
import dataclasses

import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu_torch.config import Config, DetectorConfig, TrainConfig
from waymo_2d_tracking_tpu_torch.parallel.launch import run_ranks
from waymo_2d_tracking_tpu_torch.tools import rank_cases
from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, _as_batch

torch.set_num_threads(1)

WORLD = 2
DET = DetectorConfig(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
                     fpn_levels=(3, 4, 5), head_depth=1, embed_dim=16, dtype="float32")
BASE = TrainConfig(batch_size=8, learning_rate=1e-3, warmup_steps=2, total_steps=50)
CASES = {
    "plain": {},
    "accum2": {"grad_accum_steps": 2},
    "remat": {"remat": True},
    "reid_triplet": {"reid_loss_weight": 0.5, "reid_loss": "triplet"},
    "reid_supcon": {"reid_loss_weight": 0.5, "reid_loss": "supcon"},
}
STEPS_CFG = Config(detector=DET, train=dataclasses.replace(
    BASE, ema_decay=0.9, reid_loss_weight=0.5, reid_loss="supcon"))


def cfg_of(kw) -> Config:
    return Config(detector=DET, train=dataclasses.replace(BASE, **kw))


def noise_grad(name: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group."""
    return name.endswith(".bias") and ("tower.conv" in name or name == "reid.conv0.bias")


def rel_l2(got, want) -> float:
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / (den if den > 0 else 1.0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    return run_ranks(rank_cases.train_case, WORLD, "cpu",
                     {name: cfg_of(kw) for name, kw in CASES.items()}, 8, str(d / "ckpt"),
                     STEPS_CFG, 3, device="cpu", threads=1, timeout=300, workdir=str(d / "ranks"))


def single_device(kw):
    cfg = cfg_of(kw)
    tr = DetectorTrainer(cfg, device="cpu")
    st = tr.create_state(torch.Generator().manual_seed(0))
    batch = rank_cases.train_batch(3, 8, DET.image_size, cfg.train.reid_loss_weight > 0)
    grads, stats, metrics = tr._grads_and_stats(st, _as_batch(batch, tr.device))
    return grads, stats, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_equals_single_device_step(ranks, name):
    grads, stats, metrics = single_device(CASES[name])
    got = ranks[0]["cases"][name]
    assert abs(got["metrics"]["loss"] - metrics["loss"]) <= 1e-5 * abs(metrics["loss"])
    assert got["metrics"]["num_pos"] == metrics["num_pos"]
    if "reid_active" in metrics:
        assert got["metrics"]["reid_active"] == metrics["reid_active"] > 0
    for k, v in stats.items():
        assert torch.equal(got["stats"][k], v), k
    keys = [k for k in grads if not noise_grad(k)]
    per_tensor = max(rel_l2(got["grads"][k], grads[k]) for k in keys)
    whole = rel_l2(torch.cat([got["grads"][k].reshape(-1) for k in keys]),
                   torch.cat([grads[k].reshape(-1) for k in keys]))
    assert whole <= 1e-5, whole
    assert per_tensor <= 3e-5, per_tensor
    # the ranks hold the same summed gradients and statistics
    assert len({r["cases"][name]["grads_digest"] for r in ranks}) == 1
    assert len({r["cases"][name]["stats_digest"] for r in ranks}) == 1


def test_params_and_ema_bit_equal_across_ranks_after_three_steps(ranks):
    assert len({r["params_digest"] for r in ranks}) == 1
    assert len({r["ema_digest"] for r in ranks}) == 1
    assert np.isfinite(ranks[0]["loss"])


def test_checkpoint_saved_under_the_mesh_restores(ranks):
    for r in ranks:
        assert r["restored_digest"] == r["params_digest"] + r["ema_digest"]
        assert r["restored_step"] == 3
