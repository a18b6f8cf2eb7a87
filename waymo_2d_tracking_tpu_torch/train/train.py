"""Detector training (counterpart of ``train/train.py``): the loss, the
optimizer with its schedule, gradient accumulation, EMA, checkpoints,
held-out AP and the host loop, on the card.

The JAX trainer is one jitted step over an optax chain. Here it is autograd
over the detector in train mode (``models/resnet.py BatchNorm2d``: flax's
train-mode statistics and running updates), and the optax semantics
written out as tensor code over the parameter list (``Optimizer``):

- ``clip_by_global_norm(10)``: scale by ``10 / norm`` when the norm reaches
  10, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- ``warmup_cosine_decay_schedule``: the learning rate of update t is
  ``lr(t)``, counted from 0, so the first update has ``lr(0) = 0``;
- AdamW (b1 0.9, b2 0.999, eps 1e-8; f32 bias corrections): weight decay on
  every parameter, norms' scales and biases included, times the scheduled
  rate; SGD: the coupled L2 added before the momentum trace (torch's SGD).

``TrainState`` holds the parameters (``nn.Parameter``, float32 whatever the
compute dtype, as flax keeps them), the BatchNorm statistics, the optimizer
state and the EMA. A step updates them in place and returns the same state
(the JAX step donates its state). The module's parameters are the state's:
``train_step`` binds a state it has not seen before into the module.

Under ``dtype: bfloat16`` the forward runs under bf16 autocast; the losses
and the optimizer run in float32. TF32 is off for every matmul and
convolution of a step, as for serving.

Data parallel (``mesh=``, a ``DeviceMesh`` from ``parallel/sharding.py``):
one rank a card, each given the same global batch, of which it takes its
rows of the data axis. JAX's step is one jitted program with sharding
annotations, so it is the single-device step on the global batch, and so is
this one: BatchNorm's statistics are the global batch's (every rank's
per-image sums gathered and summed, ``models/resnet.py``),
the losses' normalisers are global and the ReID anchors meet every rank's
embeddings (``train/losses.py``), so each rank's loss is its share of the
global loss; the gradients are summed by one all-reduce and every rank
applies the same update, so parameters and EMA stay bit-equal across ranks.
Under accumulation micro-batch i is the global rows [i*micro, (i+1)*micro),
then sharded, weighted by its global positives. The metrics are the global
ones. The rank at (data 0, model 0) writes checkpoints and logs; every rank
restores.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from waymo_2d_tracking_tpu_torch import resolve_device
from waymo_2d_tracking_tpu_torch.config import Config, TrainConfig
from waymo_2d_tracking_tpu_torch.models.centernet import centernet_loss
from waymo_2d_tracking_tpu_torch.models.detector import Detector, _no_tf32
from waymo_2d_tracking_tpu_torch.models.resnet import BatchNorm2d
from waymo_2d_tracking_tpu_torch.parallel import sharding as shd
from waymo_2d_tracking_tpu_torch.parallel.collectives import sum_detached
from waymo_2d_tracking_tpu_torch.train.losses import (
    fcos_loss,
    reid_supcon_loss,
    reid_triplet_loss,
)

CLIP_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BATCH_KEYS = ("images", "gt_boxes", "gt_classes", "gt_valid", "gt_track_ids")
# metrics that are a rank's share of a global sum under data parallelism
SHARE_METRICS = ("loss", "loss_cls", "loss_box", "loss_ctr", "reid_loss")


@dataclasses.dataclass
class TrainState:
    """Training state. ``step`` counts updates; ``params`` and
    ``ema_params`` (empty when ``train.ema_decay == 0``) map the module's
    parameter names to float32 tensors, ``batch_stats`` its BatchNorm
    ``running_mean`` / ``running_var`` names; ``opt_state`` is
    ``{"count": int, "mu": ..., "nu": ...}`` (AdamW) or ``{"count": int,
    "trace": ...}`` (SGD)."""

    step: int
    params: Dict[str, nn.Parameter]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: dict
    ema_params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def to_tree(self) -> dict:
        """Host copy as nested dicts of CPU tensors and ints."""
        cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}  # noqa: E731
        opt = {k: (cpu(v) if isinstance(v, dict) else v) for k, v in self.opt_state.items()}
        return {"step": int(self.step), "params": cpu(self.params),
                "batch_stats": cpu(self.batch_stats), "opt_state": opt,
                "ema_params": cpu(self.ema_params)}

    @classmethod
    def from_tree(cls, tree: dict, device) -> "TrainState":
        dev = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        opt = {k: (dev(v) if isinstance(v, dict) else v) for k, v in tree["opt_state"].items()}
        return cls(step=int(tree["step"]),
                   params={k: nn.Parameter(v.to(device)) for k, v in tree["params"].items()},
                   batch_stats=dev(tree["batch_stats"]), opt_state=opt,
                   ema_params=dev(tree["ema_params"]))


def _f32(x: float) -> float:
    return float(np.float32(x))


class Optimizer:
    """``optax.chain(clip_by_global_norm(10), adamw(schedule, wd))`` or
    ``optax.chain(clip_by_global_norm(10), add_decayed_weights(wd),
    sgd(schedule, momentum))`` with ``warmup_cosine_decay_schedule(0 -> lr
    over warmup_steps, cosine to 0 at total_steps)``, in place over lists of
    tensors."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"train.optimizer must be 'adamw' or 'sgd', got {cfg.optimizer!r}")
        self.cfg = cfg

    def schedule(self, count: int) -> float:
        """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, total)``."""
        cfg = self.cfg
        peak, warm = cfg.learning_rate, cfg.warmup_steps
        if count < warm:
            return (0.0 - peak) * (1 - min(max(count, 0), warm) / warm) + peak
        decay = cfg.total_steps - warm
        c = min(count - warm, decay)
        return peak * (0.5 * (1 + math.cos(math.pi * c / decay)))

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(v, memory_format=torch.preserve_format)  # noqa: E731
                         for k, v in params.items()}
        if self.cfg.optimizer == "adamw":
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        return {"count": 0, "trace": zeros()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               opt_state: dict) -> None:
        """One update of ``params`` and ``opt_state``, in place."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.where(gnorm < CLIP_NORM, torch.ones_like(gnorm), CLIP_NORM / gnorm)
        g = torch._foreach_mul(g, scale)
        count = opt_state["count"]
        lr = _f32(self.schedule(count))
        wd = self.cfg.weight_decay
        if self.cfg.optimizer == "adamw":
            mu = [opt_state["mu"][k] for k in names]
            nu = [opt_state["nu"][k] for k in names]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1 - ADAM_B2)
            c = np.int32(count + 1)
            bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** c)
            bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** c)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, p, alpha=wd)
        else:
            trace = [opt_state["trace"][k] for k in names]
            torch._foreach_add_(g, p, alpha=wd)
            torch._foreach_mul_(trace, self.cfg.sgd_momentum)
            torch._foreach_add_(trace, g)
            upd = trace
        torch._foreach_add_(p, upd, alpha=-lr)
        opt_state["count"] = count + 1


def _as_batch(batch, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k in BATCH_KEYS:
        if k in batch:
            v = batch[k]
            v = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            out[k] = v.to(device, non_blocking=True)
    return out


class DetectorTrainer:
    """Owns the model in train mode, the optimizer, the step and the
    checkpoints. ``device`` defaults to ``"cuda"``; with ``mesh`` (data
    parallel, see the module's docstring) the device is this rank's."""

    def __init__(self, cfg: Config, mesh=None, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.group = None
        if mesh is not None:
            self.group = shd.data_group(shd.check_mesh(mesh))
            self.device = shd.mesh_device(mesh)
        else:
            self.device = resolve_device(device)
        self.model = Detector(cfg.detector, remat=cfg.train.remat).to(self.device).train()
        for m in self.model.modules():
            if isinstance(m, BatchNorm2d):
                m.process_group = self.group
        self.tx = Optimizer(cfg.train)
        self._bound: Optional[int] = None
        names = dict(self.model.named_buffers())
        self._stat_names = [k for k in names if k.endswith(("running_mean", "running_var"))]

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs (always without a
        mesh; the rank at (data 0, model 0) with one)."""
        return self.mesh is None or shd.is_writer(self.mesh)

    # ------------------------------------------------------------- state

    def create_state(self, generator: torch.Generator) -> TrainState:
        """Fresh state from flax's initializers (``Detector.init_weights``,
        truncated) drawn from ``generator`` (a CPU ``torch.Generator``)."""
        init = Detector(self.cfg.detector)
        init.init_weights(generator, truncated=True)
        return self.state_from_weights(init.state_dict())

    def state_from_weights(self, state_dict: Dict[str, torch.Tensor]) -> TrainState:
        """State at step 0 from a port ``state_dict`` (e.g.
        ``weights.from_flax_numpy`` of the JAX package's variables)."""
        params = {k: nn.Parameter(state_dict[k].detach().to(self.device, torch.float32).clone())
                  for k, _ in self.model.named_parameters()}
        stats = {k: state_dict[k].detach().to(self.device, torch.float32).clone()
                 for k in self._stat_names}
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if self.cfg.train.ema_decay > 0 else {})
        state = TrainState(step=0, params=params, batch_stats=stats,
                           opt_state=self.tx.init(params), ema_params=ema)
        if self.mesh is not None:
            shd.replicate([state.params, state.batch_stats, state.opt_state, state.ema_params],
                          self.mesh)
        return state

    def _bind(self, state: TrainState) -> None:
        """Make the module's parameters and statistics the state's tensors."""
        if self._bound == id(state.params):
            return
        for name, t in list(state.params.items()) + list(state.batch_stats.items()):
            prefix, _, leaf = name.rpartition(".")
            setattr(self.model.get_submodule(prefix), leaf, t)
        self._bound = id(state.params)

    # -------------------------------------------------------------- step

    def _forward(self, batch: Dict[str, torch.Tensor], reid_on: bool):
        """(head outputs, GT-box embeddings or None): the module in train
        mode, under bf16 autocast for a bf16 config."""
        with self._precision():
            return self.model.forward_train(batch["images"],
                                            batch["gt_boxes"] if reid_on else None)

    def _objective(self, head_out, embeds, batch: Dict[str, torch.Tensor], reid_on: bool):
        """(loss, metrics) in float32: the head family's detection loss, plus
        the weighted ReID loss."""
        cfg = self.cfg
        if cfg.detector.head_family == "centernet":
            loss, metrics = centernet_loss(head_out, batch["gt_boxes"], batch["gt_classes"],
                                           batch["gt_valid"], num_classes=cfg.detector.num_classes,
                                           group=self.group)
        else:
            loss, metrics = fcos_loss(head_out, batch["gt_boxes"], batch["gt_classes"],
                                      batch["gt_valid"], num_classes=cfg.detector.num_classes,
                                      focal_alpha=cfg.train.focal_alpha,
                                      focal_gamma=cfg.train.focal_gamma, group=self.group)
        if reid_on:
            if cfg.train.reid_loss == "triplet":
                reid_l, n_active = reid_triplet_loss(embeds, batch["gt_track_ids"],
                                                     batch["gt_valid"], margin=cfg.train.reid_margin,
                                                     group=self.group)
            elif cfg.train.reid_loss == "supcon":
                reid_l, n_active = reid_supcon_loss(
                    embeds, batch["gt_track_ids"], batch["gt_valid"],
                    temperature=cfg.train.reid_temperature, group=self.group)
            else:
                raise ValueError("train.reid_loss must be 'supcon' or 'triplet', "
                                 f"got {cfg.train.reid_loss!r}")
            loss = loss + cfg.train.reid_loss_weight * reid_l
            metrics = dict(metrics, reid_loss=reid_l, reid_active=n_active)
        return loss, metrics

    def _loss(self, batch: Dict[str, torch.Tensor], reid_on: bool):
        """(loss, global metrics) of ``batch``: this rank's rows of it under a
        mesh, whose loss is this rank's share of the global loss."""
        if self.mesh is not None:
            batch = shd.shard_batch(batch, self.mesh)
        loss, metrics = self._objective(*self._forward(batch, reid_on), batch, reid_on)
        if self.group is not None:
            keys = [k for k in SHARE_METRICS if k in metrics]
            total = sum_detached(torch.stack([metrics[k].detach().float() for k in keys]),
                                 self.group)
            metrics = dict(metrics, **dict(zip(keys, total.unbind())))
        return loss, metrics

    def _sum_over_ranks(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The ranks' gradients summed, by one all-reduce of one flat buffer."""
        if self.group is None:
            return list(grads)
        flat = sum_detached(torch.cat([g.reshape(-1) for g in grads]), self.group)
        return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def reid_on(self, batch) -> bool:
        """Whether a step on ``batch`` trains the ReID tower."""
        return (self.cfg.train.reid_loss_weight > 0 and self.cfg.detector.embed_dim > 0
                and "gt_track_ids" in batch)

    def _precision(self):
        if self.cfg.detector.dtype == "bfloat16":
            return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16)
        return torch.autocast(device_type=self.device.type, enabled=False)

    def _grads_and_stats(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """(grads, batch_stats, metrics) of one update, honouring
        ``grad_accum_steps``; the state's BatchNorm statistics are updated in
        place. With accumulation the batch is split into micro-batches run in
        order (the statistics updated after each), and the gradients are
        the mean weighted by each micro-batch's ``max(num_pos, 1)``, which
        recovers the whole batch's detection objective. Under a mesh
        ``batch`` is the global batch and every micro-batch is sharded."""
        self._bind(state)
        reid_on = self.reid_on(batch)
        names = list(state.params)
        leaves = [state.params[k] for k in names]
        accum = self.cfg.train.grad_accum_steps
        with _no_tf32():
            if accum <= 1:
                loss, metrics = self._loss(batch, reid_on)
                grads = self._sum_over_ranks(
                    torch.autograd.grad(loss, leaves, materialize_grads=True))
            else:
                n = batch["images"].shape[0]
                if n % accum != 0:
                    raise ValueError(f"batch size {n} not divisible by grad_accum_steps={accum}")
                micro = n // accum
                gsum, wsum, seq = None, 0.0, []
                for i in range(accum):
                    mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
                    loss, m = self._loss(mb, reid_on)
                    g = torch.autograd.grad(loss, leaves, materialize_grads=True)
                    w = torch.clamp(m["num_pos"].detach().float(), min=1.0)
                    wg = torch._foreach_mul(g, w)
                    gsum = wg if gsum is None else torch._foreach_add(gsum, wg)
                    wsum = wsum + w
                    seq.append(m)
                grads = torch._foreach_div(self._sum_over_ranks(gsum), wsum)
                metrics = {k: torch.stack([m[k].detach().float() for m in seq]).mean()
                           for k in seq[0]}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(zip(names, grads)), state.batch_stats, metrics

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch`` (numpy arrays or tensors: images (N,H,W,3)
        float32 normalised, gt_boxes (N,G,4), gt_classes (N,G), gt_valid
        (N,G), optionally gt_track_ids (N,G); under a mesh the global batch,
        the same on every rank). Updates ``state`` in place and returns it
        with the step's metrics (device tensors)."""
        batch = _as_batch(batch, self.device)
        grads, _, metrics = self._grads_and_stats(state, batch)
        with _no_tf32():
            self.tx.update(state.params, grads, state.opt_state)
        d = self.cfg.train.ema_decay
        if d > 0:
            step = np.float32(state.step + 1)
            d_t = float(min(np.float32(d), (np.float32(1.0) + step) / (np.float32(10.0) + step)))
            with torch.no_grad():
                ema = [state.ema_params[k] for k in state.params]
                torch._foreach_mul_(ema, d_t)
                torch._foreach_add_(ema, list(state.params.values()), alpha=1.0 - d_t)
        state.step += 1
        return state, metrics

    def eval_variables(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """``state_dict`` for ``DetectorRunner``: the EMA parameters when
        ``train.ema_decay > 0``, else the raw ones, with the statistics."""
        params = state.ema_params if self.cfg.train.ema_decay > 0 else state.params
        sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        sd.update({k: v.detach().clone() for k, v in params.items()})
        sd.update({k: v.detach().clone() for k, v in state.batch_stats.items()})
        return sd

    # -------------------------------------------------------- checkpoint

    def save_checkpoint(self, state: TrainState, path: Optional[str] = None,
                        exact_path: bool = False) -> str:
        """Save under ``<path>/step_N``, or exactly at ``path``
        (``exact_path=True``, the replace-in-place ``<checkpoint_dir>/best``),
        made absolute; ``path`` defaults to ``train.checkpoint_dir``. Written
        to a temporary file renamed into place, under a mesh by the writing
        rank while the others wait. Returns the path."""
        path = path or self.cfg.train.checkpoint_dir
        if not exact_path:
            path = os.path.join(path, f"step_{int(state.step)}")
        path = os.path.abspath(path)
        if self.is_writer:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(state.to_tree(), tmp)
            os.replace(tmp, path)
        if self.mesh is not None:
            shd.barrier(self.mesh)
        return path

    def restore_checkpoint(self, path: str, template: TrainState) -> TrainState:
        """The state saved at ``path``, on the trainer's device. Raises
        ValueError when its tree (names, shapes, optimizer) differs from
        ``template``'s."""
        tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
        try:
            _check_tree(tree, template.to_tree())
        except (ValueError, KeyError) as e:
            raise ValueError(
                f"checkpoint at {path} does not match the current config's "
                "parameter tree. If the checkpoint predates the s2d stem "
                "default (or was imported from torch by hand), restore with "
                "detector.stem=conv7 or convert exactly via "
                "models.resnet.convert_stem_to_s2d / `w2t import-weights`; "
                "otherwise check width/depth/class-count settings against "
                f"the training config. Original error: {e}"
            ) from e
        return TrainState.from_tree(tree, self.device)


def _check_tree(got, want, path: str = "") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            missing = sorted(set(want) - set(got if isinstance(got, dict) else {}))[:3]
            extra = sorted(set(got if isinstance(got, dict) else {}) - set(want))[:3]
            raise ValueError(f"{path or 'state'}: keys differ (missing {missing}, "
                             f"unexpected {extra})")
        for k in want:
            _check_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape:
            shape = tuple(got.shape) if isinstance(got, torch.Tensor) else type(got).__name__
            raise ValueError(f"{path}: shape {shape} where the config has {tuple(want.shape)}")


def evaluate_detector(trainer: DetectorTrainer, state: TrainState, val_batches: Iterable,
                      runner=None) -> Dict[str, float]:
    """Held-out detection AP (``eval/ap.py evaluate_detections``) with the
    eval variables, through ``DetectorRunner.detect`` (so the NMS kernel on
    the card). ``val_batches``: train-format batches, typically a small
    materialised list; ``runner``: a ``DetectorRunner`` to load the
    variables into (one is made otherwise)."""
    from waymo_2d_tracking_tpu_torch.eval.ap import evaluate_detections
    from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner

    variables = trainer.eval_variables(state)
    if runner is None:
        runner = DetectorRunner(trainer.cfg.detector, variables, device=trainer.device)
    else:
        runner.module.load_state_dict(variables)
    preds, gts = [], []
    for bi, batch in enumerate(val_batches):
        images = _as_batch({"images": batch["images"]}, runner.device)["images"]
        dets = runner.detect(images).to_numpy()
        gt_boxes = np.asarray(_host(batch["gt_boxes"]))
        gt_classes = np.asarray(_host(batch["gt_classes"]))
        gt_valid = np.asarray(_host(batch["gt_valid"])).astype(bool)
        valid = dets.valid.astype(bool)
        for n in range(dets.boxes.shape[0]):
            key = (bi, n)
            v = valid[n]
            preds.append((key, dets.boxes[n][v], dets.scores[n][v], dets.classes[n][v]))
            g = gt_valid[n]
            gts.append((key, gt_boxes[n][g], gt_classes[n][g]))
    return evaluate_detections(preds, gts, num_classes=trainer.cfg.detector.num_classes)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def train_loop(trainer: DetectorTrainer, data_iter: Iterator, num_steps: int,
               state: Optional[TrainState] = None, log_every: int = 50,
               checkpoint_every: Optional[int] = None, log_fn=print,
               val_batches: Optional[List[dict]] = None, val_every: Optional[int] = None,
               save_best: bool = True, generator: Optional[torch.Generator] = None) -> TrainState:
    """Host loop: one step per batch, logging, periodic checkpoints and,
    with ``val_batches`` and ``val_every``, held-out AP every ``val_every``
    steps and at the end, the best-mAP state saved to
    ``<checkpoint_dir>/best``. ``state`` defaults to ``create_state`` from
    ``generator`` (seed 0). Under a mesh every rank draws the same global
    batches; the writing rank logs."""
    if state is None:
        state = trainer.create_state(generator or torch.Generator().manual_seed(0))
    best_map = float("-inf")
    runner = None
    for i in range(num_steps):
        batch = next(data_iter)
        state, metrics = trainer.train_step(state, batch)
        step = int(state.step)
        # state.step is absolute and survives a restore; the end of training
        # is the loop's own position
        is_last = i == num_steps - 1
        if trainer.is_writer and (step % log_every == 0 or is_last):
            m = {k: float(v) for k, v in metrics.items()}
            log_fn(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        if checkpoint_every and step % checkpoint_every == 0:
            trainer.save_checkpoint(state)
        if val_batches is not None and val_every and (step % val_every == 0 or is_last):
            if runner is None:
                from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner

                runner = DetectorRunner(trainer.cfg.detector, trainer.eval_variables(state),
                                        device=trainer.device)
            res = evaluate_detector(trainer, state, val_batches, runner=runner)
            log_fn(f"step {step}: val " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(res.items())))
            if save_best and res.get("mAP", float("nan")) > best_map:
                best_map = res["mAP"]
                trainer.save_checkpoint(
                    state, os.path.join(trainer.cfg.train.checkpoint_dir, "best"),
                    exact_path=True)
    return state
