"""Weights from the JAX package's flax variables into the port's modules.

``from_flax_numpy`` takes the ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of numpy arrays and returns the port's ``state_dict``. The
module names of the port follow the flax names, so a leaf at
``params/backbone/stage1_block0/conv1/kernel`` lands at
``backbone.stage1_block0.conv1.weight``:

- conv kernel (kH, kW, Cin, Cout) -> weight (Cout, Cin, kH, kW);
- Dense kernel (in, out) -> weight (out, in) (the ReID head flattens its
  (P, P, C) input in NHWC order, like flax, so no permutation is needed);
- BatchNorm / GroupNorm scale -> weight, bias -> bias; batch_stats
  mean / var -> running_mean / running_var;
- the per-level FCOS ``scale{l}`` scalars stay scalars;
- a calibrated int8 checkpoint's ``quant`` collection (``act_absmax`` per
  quantized conv) -> the ``QuantConv2d`` buffers of the same name, so the
  port serves the JAX package's activation scales.

(``train/port_torch.py`` in the JAX package holds the opposite mapping.)
``load_npz`` reads the flat ``.npz`` form of such a tree (keys joined by
``/``), which is how the trained fixtures ship in ``fixtures/``.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

FIXTURES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def from_flax_numpy(variables) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats", "quant"}`` numpy tree -> port
    ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})):
        *mod, leaf = path
        if leaf == "kernel" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and value.ndim == 2:
            value = value.T
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        sd[".".join(mod + [name])] = torch.tensor(value, dtype=torch.float32)
    for path, value in _flatten(variables.get("batch_stats", {})):
        *mod, leaf = path
        sd[".".join(mod + [_STATS[leaf]])] = torch.tensor(value, dtype=torch.float32)
        if leaf == "mean":
            sd[".".join(mod + ["num_batches_tracked"])] = torch.zeros((), dtype=torch.long)
    for path, value in _flatten(variables.get("quant", {})):
        sd[".".join(path)] = torch.tensor(value, dtype=torch.float32)
    return sd


def load_npz(path: str) -> dict:
    """Flat ``.npz`` (keys ``params/backbone/...``) -> nested dict tree."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def fixture_state_dict(name: str) -> Dict[str, torch.Tensor]:
    """State dict of a trained fixture in ``fixtures/`` (e.g.
    ``"pixels_detector"`` or ``"pixels_detector_reid"``)."""
    return from_flax_numpy(load_npz(os.path.join(FIXTURES_DIR, f"{name}.npz")))
