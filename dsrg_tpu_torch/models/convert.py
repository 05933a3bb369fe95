"""Weight conversion between the flax parameter tree and a torch state_dict.

Flax kernels are HWIO, torch's are OIHW; layer names are the prototxt's in
both, so the mapping is one to one.
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
