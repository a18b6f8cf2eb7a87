"""The comparison that decides ``correct``, driven through whole tiny runs
on the CPU (the harness's look for a card skipped): sound runs come out
correct, the control (the reference one precision step lower in the
program's place) and each fault this kind of cell can have, planted in the
timed path underneath, come out not correct. A cell on one chip has no
exchange between chips to leave out."""
import numpy as np
import pytest
import torch

from benchmark.harness import core

torch.set_num_threads(1)
SEED = 2 ** 31 + 977


def _run(cell, control=False, fault=None):
    res = core.run(cell, SEED, 0.3, False, "cpu", control=control, fault=fault)
    return core.result_line(cell, res)


@pytest.mark.parametrize("name", ["tiny.segments", "tiny_rig.segments", "tiny_rig.live"])
def test_sound_run_is_correct(tiny_cell, name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["seen"]["records"] > 0 and out["seen"]["detections"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", ["tiny.segments", "tiny_rig.live"])
def test_control_is_not_correct(tiny_cell, name):
    out = _run(tiny_cell(name), control=True)
    assert not out["correct"]
    limits = tiny_cell(name)["cell"]["limits"]
    assert out["checks"]["forward_gap"]["value"] > limits["forward_gap"]


def _state_unchanged(ctx):
    """The tracker step hands back the state it was given."""
    from waymo_2d_tracking_tpu_torch.pipeline import online
    from waymo_2d_tracking_tpu_torch.tracker import graph, tracker
    real = tracker.track_step

    def step(state, dets, cfg):
        return state, real(state, dets, cfg)[1]
    for mod in (tracker, graph, online):
        ctx.probe._set(mod, "track_step", step)


def _half_batch(ctx):
    """The detector runs the first half of each batch; the rest repeat it."""
    module = (getattr(ctx, "pipe", None) or ctx.sess).detector.module
    real = module.forward

    def forward(images):
        n = images.shape[0]
        head, feats = real(images[: max(n // 2, 1)])
        idx = torch.arange(n) % max(n // 2, 1)
        return ({lvl: tuple(t[idx] for t in v) for lvl, v in head.items()},
                {lvl: f[idx] for lvl, f in feats.items()})
    ctx.probe._set(module, "forward", forward)


def _altered_answer(ctx):
    """One detection's score is altered where it is produced."""
    runner = (getattr(ctx, "pipe", None) or ctx.sess).detector
    real = runner.select

    def select(candidates, feats):
        dets = real(candidates, feats)
        dets.scores[..., 0] = dets.scores[..., 0] * 0.999
        return dets
    ctx.probe._set(runner, "select", select)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_answer],
                         ids=["state_unchanged", "half_batch", "altered_answer"])
@pytest.mark.parametrize("name", ["tiny.segments", "tiny_rig.live"])
def test_fault_is_not_correct(tiny_cell, name, fault):
    out = _run(tiny_cell(name), fault=fault)
    assert not out["correct"], out["checks"]


def test_reference_auction_is_the_cards_schedule():
    """The reference's Jacobi auction gives the program's plain model of the
    card's kernel, row for row, ties included."""
    from benchmark.reference import assign
    from waymo_2d_tracking_tpu_torch.ops.assign import auction_kernel_reference
    rng = np.random.default_rng(3)
    for trial in range(40):
        n = (32, 64, 128)[trial % 3]
        r, c = int(rng.integers(1, n + 1)), int(rng.integers(1, n + 1))
        cost = torch.from_numpy(rng.uniform(0, 1, (r, c)).astype(np.float32))
        if trial % 2:
            cost = torch.round(cost * 4) / 4
        valid = torch.from_numpy(rng.uniform(size=(r, c)) < 0.4)
        if not bool(valid.any()):
            continue
        ben, eps0 = assign.benefit(cost, valid, n, 1e-2)
        got = assign.solve_jacobi(ben.numpy(), eps0.numpy(), 0.2, 1e-2, 4096)
        want = auction_kernel_reference(ben[None], eps0.reshape(1), valid.any().reshape(1),
                                        eps_scale=0.2, eps_min=1e-2, max_iters=4096)[0][0]
        assert np.array_equal(got, want.numpy())


@pytest.mark.card
def test_a_cell_runs_on_the_card(card, tiny_cell):
    cell = tiny_cell("tiny_rig.segments")
    res = core.run(cell, SEED, 0.5, False, "cuda")
    out = core.result_line(cell, res)
    assert out["correct"] and out["device"]["platform"] == "gpu"
