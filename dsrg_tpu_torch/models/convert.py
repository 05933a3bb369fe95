"""Weight conversion between flax variable trees and a torch state_dict.

Flax kernels are HWIO, torch's are OIHW; module names are the same in both,
so the mapping is one to one.  A nested flax path joins with dots: the
ResNet's ``params/res4_22/bn2/scale`` is ``res4_22.bn2.weight`` and its
``batch_stats/res4_22/bn2/mean`` is ``res4_22.bn2.running_mean``.  Leaves:
``kernel`` <-> ``weight`` (transposed), ``scale`` <-> ``weight`` (a BN's, one
axis), ``bias`` <-> ``bias``, ``mean`` / ``var`` <-> ``running_mean`` /
``running_var``.  :func:`state_from_flax` carries a whole JAX train state
across (weights, BN statistics, Caffe SGD velocities and step).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, leaves: Mapping, prefix: str = "") -> dict:
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            out.update(_flatten(sub, leaves, f"{prefix}{name}."))
            continue
        a = np.array(sub, np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1)
        out[prefix + leaves[name]] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_from_flax(tree: Mapping) -> dict:
    """A flax ``params`` tree (``{layer: {"kernel": HWIO, "bias": (O,)}}``,
    nested for the ResNet) -> ``{"layer.weight": OIHW, ...}``."""
    return _flatten(tree, _PARAM_LEAVES)


def variables_from_flax(variables: Mapping) -> dict:
    """``{"params", "batch_stats"?}`` -> the full state_dict (parameters and
    BN buffers)."""
    return {**params_from_flax(variables["params"]),
            **_flatten(variables.get("batch_stats", {}), _STAT_LEAVES)}


def flax_variables_from_state(state_dict: Mapping) -> dict:
    """Inverse of :func:`variables_from_flax`, as numpy arrays:
    ``{"params": ..., "batch_stats": ...}`` (no ``batch_stats`` without BN
    buffers)."""
    out: dict = {"params": {}}
    for key, t in state_dict.items():
        *path, kind = key.split(".")
        a = t.detach().cpu().float().numpy()
        if kind in ("running_mean", "running_var"):
            node = out.setdefault("batch_stats", {})
            leaf = "mean" if kind == "running_mean" else "var"
        else:
            node = out["params"]
            leaf = "bias" if kind == "bias" else ("kernel" if a.ndim == 4 else "scale")
            if leaf == "kernel":
                a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return out


def flax_from_params(state_dict: Mapping) -> dict:
    """The flax ``params`` tree of a state_dict, as numpy arrays (BN
    buffers left out)."""
    return flax_variables_from_state(state_dict)["params"]


def state_from_flax(params: Mapping, opt_state, step, extra_vars: Optional[Mapping] = None) -> dict:
    """A JAX train state's parts -> the port's train state.

    ``params``: the flax parameter tree; ``opt_state``: its
    ``CaffeSGDState`` (``.velocity``, a tree like ``params``, and
    ``.step``); ``step``: the train state's step, which must equal the
    optimizer's; ``extra_vars``: the JAX step's ``{"batch_stats": ...}`` of
    a BN backbone.  Arrays may be numpy or anything ``np.array`` takes.
    Returns ``{"model": state_dict, "optimizer": {"velocity", "step"}}``
    for ``TrainState.load_state_dict``; velocities exist for parameters only.
    """
    if int(np.asarray(step)) != int(np.asarray(opt_state.step)):
        raise ValueError(f"train state step {int(np.asarray(step))} != optimizer step "
                         f"{int(np.asarray(opt_state.step))}")
    return {
        "model": variables_from_flax({"params": params, **(extra_vars or {})}),
        "optimizer": {"velocity": params_from_flax(opt_state.velocity),
                      "step": int(np.asarray(opt_state.step))},
    }
