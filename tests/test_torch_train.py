"""The port's detector training against the JAX package's
``DetectorTrainer``, float32 on the CPU: three ``train_step``s from the same
weights (the JAX init carried over by ``weights.from_flax_numpy``) on the
same batches, for AdamW and SGD, accumulation 1 and 2, remat, EMA, and the
FCOS and CenterNet heads; BatchNorm's train-mode statistics; the gradients
of one step; remat's gradients bit-equal to the plain backward; the
optimizer and schedule against optax; checkpoints and their mismatch error;
the flax-matching initializer.

How close two frameworks can be here, and so the tolerances: the forward
passes agree to about 1e-5 relative (convolutions sum in another order),
and the few ReLU inputs that lie within that of zero take the other side in
one of them (2 of the 98304 stage-1 outputs on these batches), which moves
the gradients below them by a few percent (a flipped position carries its
whole gradient): up to 4 % in the backbone, 1.3 % in the FPN under the
ReID tower's flips, 1e-4 with the ReID loss off. Conv biases directly before a GroupNorm of one channel per group
have a gradient that is zero analytically, rounding noise in both, and are
held only to the bound of an update. Adam's first updates are about
lr * sign(g), so an element whose small gradient flips sign moves by 2 lr.
Hence: per-step metrics rtol 1e-4 until the first non-zero update (the
schedule gives update 1 a rate of 0) and 5e-3 after it; each tensor's
gradient within 0.05 (FPN, heads, ReID) or 0.1 (backbone) in relative L2
norm; each tensor's total change over three steps (parameters, EMA) within
0.5 of the JAX change in relative L2 norm; BatchNorm statistics within 5e-3.
The optimizer itself is held to optax at rtol 1e-5 on given gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waymo_2d_tracking_tpu.config import Config as JaxConfig
from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.config import TrainConfig as JaxTrainConfig
from waymo_2d_tracking_tpu.train.train import DetectorTrainer as JaxTrainer

from waymo_2d_tracking_tpu_torch.config import Config, DetectorConfig, TrainConfig
from waymo_2d_tracking_tpu_torch.data.synthetic import render_detection_batch
from waymo_2d_tracking_tpu_torch.models.detector import Detector
from waymo_2d_tracking_tpu_torch.models.resnet import BatchNorm2d
from waymo_2d_tracking_tpu_torch.train.train import DetectorTrainer, Optimizer
from waymo_2d_tracking_tpu_torch.weights import from_flax_numpy

torch.set_num_threads(1)

TINY = dict(backbone="resnet18slim", image_size=(64, 96), fpn_channels=32,
            fpn_levels=(3, 4, 5), head_depth=1, pre_nms_topk=64, max_detections=16,
            embed_dim=16, dtype="float32", score_threshold=0.3)
TRAIN = dict(batch_size=4, learning_rate=3e-3, warmup_steps=2, total_steps=6,
             weight_decay=1e-4, ema_decay=0.9, reid_loss_weight=0.5, reid_loss="supcon")


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), jax.device_get(tree))


def _batches(n_steps, n=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        b = render_detection_batch(rng, n, TINY["image_size"], max_gt=6)
        # identities recurring across the batch's images
        b["gt_track_ids"] = np.where(b["gt_valid"], np.arange(6)[None, :] % 4, -1).astype(np.int32)
        out.append(b)
    return out


def _pair(det_kw, train_kw):
    jcfg = JaxConfig(detector=JaxDetectorConfig(**det_kw), train=JaxTrainConfig(**train_kw))
    pcfg = Config(detector=DetectorConfig(**det_kw), train=TrainConfig(**train_kw))
    jt = JaxTrainer(jcfg)
    jstate = jt.create_state(jax.random.PRNGKey(0), batch_size=2)
    pt = DetectorTrainer(pcfg, device="cpu")
    variables = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
    pstate = pt.state_from_weights(from_flax_numpy(variables))
    return jt, jstate, pt, pstate


def _close(got, want, atol, rtol, what):
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=f"{what} {k}")


def _noise_grad(name: str) -> bool:
    """A conv bias right before a GroupNorm of one channel per group (the
    tiny config's 32 groups of 32 channels): zero gradient analytically."""
    return name.endswith(".bias") and ("tower.conv" in name or name == "reid.conv0.bias")


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||, or ||got|| where want is all zero."""
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / (den if den > 0 else 1.0)


def _close_changes(got, want, start, bound, what, lr_sum):
    for k in start:
        dg, dw = got[k].detach() - start[k], want[k] - start[k]
        if _noise_grad(k):
            assert float(dg.abs().max()) <= lr_sum * (1 + 1e-4), (what, k)
            continue
        if float(dw.abs().max()) == 0:     # unused (FPN levels CenterNet skips)
            assert float(dg.abs().max()) == 0, (what, k)
            continue
        assert _rel_l2(dg, dw) <= bound, (what, k, _rel_l2(dg, dw))


CASES = {
    "adamw-accum1-fcos": (dict(), dict(optimizer="adamw")),
    "sgd-accum2-remat-fcos": (dict(), dict(optimizer="sgd", grad_accum_steps=2, remat=True)),
    "adamw-accum2-remat-centernet": (dict(head_family="centernet", head_depth=2),
                                     dict(optimizer="adamw", grad_accum_steps=2, remat=True)),
    "sgd-accum1-triplet-centernet": (dict(head_family="centernet"),
                                     dict(optimizer="sgd", reid_loss="triplet")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_train_steps_match_jax(case):
    det_over, train_over = CASES[case]
    jt, jstate, pt, pstate = _pair({**TINY, **det_over}, {**TRAIN, **train_over})
    start = {k: v.detach().clone() for k, v in pstate.params.items()}
    for step, batch in enumerate(_batches(3)):
        jstate, jm = jt.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pt.train_step(pstate, batch)
        jm = _np(jm)
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4 if step < 2 else 5e-3,
                                       atol=1e-6, err_msg=f"step {step} {k}")
    assert pstate.step == int(jstate.step) == 3
    lr_sum = sum(pt.tx.schedule(c) for c in range(3))
    want = from_flax_numpy(_np({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    _close_changes(pstate.params, want, start, 0.5, "param", lr_sum)
    _close(pstate.batch_stats, {k: want[k].numpy() for k in pstate.batch_stats}, 5e-3, 0,
           "batch stat")
    ema = from_flax_numpy(_np({"params": jstate.ema_params}))
    _close_changes(pstate.ema_params, ema, start, 0.5, "ema", lr_sum)
    # the eval variables serve: DetectorRunner loads them strictly
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner

    runner = DetectorRunner(pt.cfg.detector, pt.eval_variables(pstate), device="cpu")
    torch.testing.assert_close(runner.module.state_dict()["backbone.stem_conv.weight"],
                               pstate.ema_params["backbone.stem_conv.weight"])


@pytest.mark.parametrize("accum", [1, 2])
def test_gradients_and_batch_stats_of_one_step_match_jax(accum):
    jt, jstate, pt, pstate = _pair(TINY, {**TRAIN, "grad_accum_steps": accum})
    batch = _batches(1)[0]
    jgrads, jstats, jm = jax.jit(jt._grads_and_stats)(
        jstate.params, jstate.batch_stats, {k: jnp.asarray(v) for k, v in batch.items()})
    from waymo_2d_tracking_tpu_torch.train.train import _as_batch

    grads, stats, pm = pt._grads_and_stats(pstate, _as_batch(batch, pt.device))
    want = from_flax_numpy(_np({"params": jgrads, "batch_stats": jstats}))
    assert set(grads) == {k for k in want if k in pstate.params}
    for k, g in grads.items():
        if not _noise_grad(k):
            bound = 0.1 if k.startswith("backbone.") else 0.05
            assert _rel_l2(g, want[k]) <= bound, (k, _rel_l2(g, want[k]))
    _close(stats, {k: want[k].numpy() for k in stats}, 1e-5, 1e-5, "batch stat")
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_remat_gradients_bit_equal_and_stats_updated_once():
    """Per-block recompute: the same gradients bit for bit, and the
    BatchNorm statistics updated once per forward, not again in the
    recompute."""
    batch = _batches(1)[0]
    out = {}
    for remat in (False, True):
        cfg = Config(detector=DetectorConfig(**TINY), train=TrainConfig(**TRAIN, remat=remat))
        tr = DetectorTrainer(cfg, device="cpu")
        st = tr.create_state(torch.Generator().manual_seed(1))
        from waymo_2d_tracking_tpu_torch.train.train import _as_batch

        grads, stats, _ = tr._grads_and_stats(st, _as_batch(batch, tr.device))
        out[remat] = ({k: v.clone() for k, v in grads.items()},
                      {k: v.clone() for k, v in stats.items()})
    for k in out[False][0]:
        assert torch.equal(out[False][0][k], out[True][0][k]), k
    for k in out[False][1]:
        assert torch.equal(out[False][1][k], out[True][1][k]), k


def test_batchnorm_train_mode_matches_flax():
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = rng.normal(1.5, 2.0, (4, 5, 6, 8)).astype(np.float32)   # NHWC
    scale = rng.normal(1, 0.2, 8).astype(np.float32)
    bias = rng.normal(0, 0.2, 8).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}}, x, mutable=["batch_stats"])
    m = BatchNorm2d(8)
    m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                       "running_mean": torch.from_numpy(mean0),
                       "running_var": torch.from_numpy(var0),
                       "num_batches_tracked": torch.zeros((), dtype=torch.long)})
    got = m.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    # eval mode is torch's BatchNorm, unchanged
    ref = torch.nn.BatchNorm2d(8, eps=1e-5)
    ref.load_state_dict(m.state_dict())
    xe = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(m.eval()(xe), ref.eval()(xe))


def test_schedule_and_first_update_follow_optax():
    import optax

    cfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=20)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 5, 20)
    opt = Optimizer(cfg)
    for c in range(25):
        # optax evaluates it in float32
        np.testing.assert_allclose(opt.schedule(c), float(sched(c)), rtol=1e-5, atol=1e-12)
    assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_optimizer_updates_match_optax(optimizer):
    """Five updates of random gradients, some above the clip norm of 10."""
    from waymo_2d_tracking_tpu.train.train import make_optimizer as jax_make_optimizer

    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=8, weight_decay=1e-2,
                      optimizer=optimizer)
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    tx = jax_make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    opt = Optimizer(cfg)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = opt.init(pp)
    for i in range(5):
        g = {k: (rng.normal(size=v.shape) * (20.0 if i % 2 else 0.1)).astype(np.float32)
             for k, v in params.items()}
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        opt.update(pp, {k: torch.from_numpy(v) for k, v in g.items()}, ps)
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"update {i} {k}")


def test_checkpoint_round_trip_and_mismatch(tmp_path):
    cfg = Config(detector=DetectorConfig(**TINY),
                 train=TrainConfig(**TRAIN, checkpoint_dir=str(tmp_path / "ck")))
    tr = DetectorTrainer(cfg, device="cpu")
    st = tr.create_state(torch.Generator().manual_seed(0))
    batches = _batches(4)
    st, _ = tr.train_step(st, batches[0])
    path = tr.save_checkpoint(st)
    assert path == str(tmp_path / "ck" / "step_1")
    best = tr.save_checkpoint(st, str(tmp_path / "ck" / "best"), exact_path=True)
    assert best == str(tmp_path / "ck" / "best")
    restored = tr.restore_checkpoint(path, st)
    for b in batches[1:]:
        st, _ = tr.train_step(st, b)
    for b in batches[1:]:
        restored, _ = tr.train_step(restored, b)
    a, b = st.to_tree(), restored.to_tree()
    assert a["step"] == b["step"] == 4 and a["opt_state"]["count"] == b["opt_state"]["count"]
    for part in ("params", "batch_stats", "ema_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for k in a["opt_state"]["mu"]:
        assert torch.equal(a["opt_state"]["nu"][k], b["opt_state"]["nu"][k]), k
    # a tree of another width refuses with the JAX package's guidance
    other = DetectorTrainer(Config(detector=DetectorConfig(**{**TINY, "fpn_channels": 64}),
                                   train=TrainConfig(**TRAIN)), device="cpu")
    template = other.create_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not match the current config's parameter tree"):
        other.restore_checkpoint(path, template)


def test_initializer_std_matches_flax():
    """Training's init (truncated): per-layer standard deviation of every
    kernel within 5 % of the JAX package's init (layers of at least 500
    values), truncated at two standard deviations as flax's, biases, scales
    and the focal prior exactly; the serving init's draws are unchanged."""
    from waymo_2d_tracking_tpu.models.detector import Detector as JaxDetector

    cfg = {**TINY, "fpn_channels": 64, "head_channels": 64, "embed_dim": 32}
    model = JaxDetector(JaxDetectorConfig(**cfg))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
                           method=JaxDetector.init_all)
    want = from_flax_numpy(_np({"params": variables["params"],
                                "batch_stats": variables["batch_stats"]}))
    det = Detector(DetectorConfig(**cfg))
    det.init_weights(torch.Generator().manual_seed(0), truncated=True)
    got = det.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        if w.dim() > 1 and w.numel() >= 500:
            ratio = float(g.std() / w.std())
            assert abs(ratio - 1) < 0.05, (k, ratio)
            bound = 2 * np.sqrt(1 / g[0].numel()) / 0.87962566103423978
            assert float(g.abs().max()) <= bound * (1 + 1e-6), k   # truncated at 2 sigma
        elif w.dim() <= 1:
            assert torch.equal(g.float(), w.float()), k
    # the serving paths' random weights: plain normal draws, as before
    plain = Detector(DetectorConfig(**cfg))
    plain.init_weights(torch.Generator().manual_seed(0))
    w = plain.state_dict()["backbone.stem_conv.weight"]
    want = torch.randn(w.shape, generator=torch.Generator().manual_seed(0)) / np.sqrt(w[0].numel())
    assert torch.equal(w, want)


def test_trainer_refuses_mesh_and_needs_a_card():
    """A ``mesh`` that is not a (data, model) ``DeviceMesh`` is refused (the
    data-parallel trainer itself: ``tests/test_torch_train_dp.py``)."""
    cfg = Config(detector=DetectorConfig(**TINY), train=TrainConfig(**TRAIN))
    with pytest.raises(TypeError, match="DeviceMesh"):
        DetectorTrainer(cfg, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectorTrainer(cfg)


def _smoke():
    from test_torch_isolation import _chip_smoke

    return _chip_smoke()


SMOKE_SMALL = {"backbone": "resnet18slim", "image_size": [64, 96], "fpn_channels": 32,
               "fpn_levels": [3, 4, 5], "head_depth": 1, "embed_dim": 16, "reid_channels": 32}


def test_chip_smoke_train_phases_on_the_cpu(capsys):
    """``chip_smoke.py``'s T1 (CPU against CPU here: the card's check with
    its tolerances) and T4 (the full-width step loop, here at the tiny size,
    ReID on, and remat with accumulation 2) on the CPU."""
    smoke = _smoke()
    smoke.phase_train_parity(np, torch, "cpu", devices=("cpu", "cpu"))
    smoke.phase_train_full_width(np, torch, "cpu", device="cpu", runs=[
        ("tiny reid", SMOKE_SMALL, 4, {"reid_loss_weight": 0.5}, True),
        ("tiny remat accum", SMOKE_SMALL, 4, {"grad_accum_steps": 2, "remat": True}, False)])
    out = capsys.readouterr().out
    assert out.count("[T1]") == 2 and "(rel 0.00e+00)" in out
    assert "[T4] tiny reid train step, batch 4 at 64x96" in out and "[T4] tiny remat accum" in out


@pytest.mark.slow
def test_training_produces_working_detector(capsys):
    """tests/integration/test_train_to_detect.py's learning proof through the
    port on the CPU (``chip_smoke.py`` T2 runs it on the card): 300 steps on
    one rendered batch, loss halved, recall@0.5 <= 0.2 untrained and >= 0.6
    trained through ``DetectorRunner.detect``, best checkpoint written, and a
    checkpoint resume bit-equal to 5 uninterrupted steps."""
    from waymo_2d_tracking_tpu_torch.ops import nms

    _smoke().phase_train_proof(np, torch, "cpu", nms, device="cpu")
    assert "bit-equal" in capsys.readouterr().out
