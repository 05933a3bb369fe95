"""Weight conversion between the flax parameter tree and a torch state_dict.

Flax kernels are HWIO, torch's are OIHW; layer names are the prototxt's in
both, so the mapping is one to one.  :func:`state_from_flax` carries a whole
stage-1 train state across (weights, Caffe SGD velocities and step).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> dict:
    """``{layer: {"kernel": HWIO, "bias": (O,)}}`` -> ``{"layer.weight": OIHW, ...}``."""
    out = {}
    for name, p in tree.items():
        out[f"{name}.weight"] = torch.from_numpy(
            np.array(p["kernel"], np.float32)
        ).permute(3, 2, 0, 1).contiguous()
        out[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return out


def flax_from_params(state_dict: Mapping) -> dict:
    """Inverse of :func:`params_from_flax`, as numpy arrays."""
    out: dict = {}
    for key, t in state_dict.items():
        name, kind = key.rsplit(".", 1)
        a = t.detach().cpu().numpy()
        if kind == "weight":
            out.setdefault(name, {})["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        else:
            out.setdefault(name, {})["bias"] = a
    return out


def state_from_flax(params: Mapping, opt_state, step) -> dict:
    """A JAX stage-1 ``TrainState``'s parts -> the port's train state.

    ``params``: the flax parameter tree; ``opt_state``: its
    ``CaffeSGDState`` (``.velocity``, a tree like ``params``, and
    ``.step``); ``step``: the train state's step, which must equal the
    optimizer's.  Arrays may be numpy or anything ``np.array`` takes.
    Returns ``{"model": state_dict, "optimizer": {"velocity", "step"}}``
    for ``TrainState.load_state_dict``.
    """
    if int(np.asarray(step)) != int(np.asarray(opt_state.step)):
        raise ValueError(f"train state step {int(np.asarray(step))} != optimizer step "
                         f"{int(np.asarray(opt_state.step))}")
    return {
        "model": params_from_flax(params),
        "optimizer": {"velocity": params_from_flax(opt_state.velocity),
                      "step": int(np.asarray(opt_state.step))},
    }
