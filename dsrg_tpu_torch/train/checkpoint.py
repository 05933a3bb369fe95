"""Checkpoint / resume / warm-start (``dsrg_tpu/train/checkpoint.py``).

Covers the reference's solver-snapshot contract (``SURVEY.md`` §5) with
``torch.save`` / ``torch.load(weights_only=True)`` in place of orbax:

* ``save_checkpoint`` / ``restore_checkpoint``: the full train state — the
  model's state_dict (parameters, and a ResNet's frozen BN statistics as its
  buffers), ``CaffeSGD``'s velocities (parameters only) and step, and the random
  stream's ``torch.Generator`` state — the ``.caffemodel`` + ``.solverstate``
  pair's equivalent (``solver-s.prototxt:16-17``, ``train.py:57-58``).
* ``save_params`` / ``load_params``: the model's state_dict alone (BN
  buffers included), what
  ``tools/train.py`` writes as ``step_{n}_params`` and the inference tools
  and ``--weights`` read.
* ``copy_from``: Caffe's ``net.copy_from(weights)`` partial warm start
  (``train.py:59-62``) — copy entries whose name and shape match, keep
  everything else (how stage 2 inherits stage 1's weights, ``run.sh:5,9``).

Every file is written to ``<path>.tmp`` and renamed into place, so a killed
process never leaves a partial snapshot that :func:`latest_checkpoint` would
pick.  The port reads no orbax checkpoint of the JAX package; weights cross
between the packages through ``models/convert.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Mapping, Optional, Union

import torch
from torch import nn

from dsrg_tpu_torch.train.train_state import TrainState


def _abs(path: str) -> str:
    return os.path.abspath(path)


def _host(tensors: Mapping[str, torch.Tensor]) -> dict:
    """Host copies, taken now: the step updates the parameters in place."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _state_payload(state: TrainState, step: int) -> dict:
    return {
        "model": _host(state.model.state_dict()),
        "optimizer": {"velocity": _host(state.optimizer.velocity), "step": int(state.optimizer.step_count)},
        "generator": state.generator.get_state().clone(),
        "step": int(step),
    }


def _params_payload(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> dict:
    return _host(params.state_dict() if isinstance(params, nn.Module) else params)


def _write(payload: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    return _write(_state_payload(state, step), os.path.join(_abs(ckpt_dir), f"step_{step}"))


class AsyncCheckpointWriter:
    """Non-blocking snapshot writes for long runs.

    ``save`` / ``save_params`` take host copies of every tensor before they
    return — the train step updates parameters and velocities in place, so a
    write that read them later would mix steps — then serialise on a
    background thread.  Each call first waits for the previous write (at
    most one in flight); ``wait`` and ``close`` drain.  The synchronous
    :func:`save_checkpoint` stays for tests and scripts that need the file on
    return.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _start(self, payload: dict, path: str) -> str:
        self.wait()

        def run():
            try:
                _write(payload, path)
            except Exception as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()
        return path

    def save(self, ckpt_dir: str, state: TrainState, step: int) -> str:
        return self._start(_state_payload(state, step), os.path.join(_abs(ckpt_dir), f"step_{step}"))

    def save_params(self, path: str, params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> str:
        return self._start(_params_payload(params), _abs(path))

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a :func:`save_checkpoint` file into ``state`` in place, onto the
    devices its model, velocities and generator already live on."""
    ckpt = torch.load(_abs(path), map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.generator.set_state(ckpt["generator"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpt_dir = _abs(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append(int(name[5:]))
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


def save_params(path: str, params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> str:
    return _write(_params_payload(params), _abs(path))


def load_params(path: str) -> dict:
    """A :func:`save_params` file -> state_dict of CPU tensors."""
    return torch.load(_abs(path), map_location="cpu", weights_only=True)


def copy_from(target: Union[nn.Module, Mapping[str, torch.Tensor]], source: Mapping[str, torch.Tensor],
              verbose: bool = True) -> dict:
    """Partial parameter copy by name + shape (net.copy_from parity).

    ``target``: a module (loaded in place) or a state_dict.  Returns the
    merged state_dict: the source's tensor where name and shape match, the
    target's own value elsewhere."""
    dst = target.state_dict() if isinstance(target, nn.Module) else target
    out = {}
    for key, val in dst.items():
        if key in source:
            sval = torch.as_tensor(source[key])
            if tuple(sval.shape) == tuple(val.shape):
                out[key] = sval.to(dtype=val.dtype, device=val.device)
            else:
                if verbose:
                    print(f"copy_from: shape mismatch at {key}, keeping init")
                out[key] = val
        else:
            if verbose:
                print(f"copy_from: {key} not in source, keeping init")
            out[key] = val
    if isinstance(target, nn.Module):
        target.load_state_dict(out)
    return out
