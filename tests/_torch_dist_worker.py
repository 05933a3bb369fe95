"""A rank of a multi-process CPU job of the port (torch.distributed, gloo).

Run as::

    python tests/_torch_dist_worker.py jobs <coordinator> <world_size> <rank> <spec> <out>
    python tests/_torch_dist_worker.py cli <tools/train.py argv...>

``jobs`` runs the jobs listed in the ``torch.save``'d ``spec`` (train steps
through ``parallel.data_parallel_step``, snapshots written and restored
across world sizes, ``local_batch_slice``) and writes this rank's results to
``<out>.<rank>``.  ``cli`` runs the train CLI with mirroring and dropout off
(the comparisons with a one-process run need the same draws everywhere).
Imports no JAX: ``tests/test_torch_port_parallel.py`` compares the results
with the JAX package.
"""

import copy
import functools
import hashlib
import os
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dsrg_tpu_torch.config import Stage1Config, Stage2Config  # noqa: E402
from dsrg_tpu_torch.models import DeepLabLargeFOV  # noqa: E402
from dsrg_tpu_torch.parallel import data_parallel_step, make_mesh, replicate_to_mesh, shard_batch  # noqa: E402
from dsrg_tpu_torch.parallel import distributed  # noqa: E402
from dsrg_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from dsrg_tpu_torch.train import stage1, stage2  # noqa: E402
from dsrg_tpu_torch.train.train_state import TrainState  # noqa: E402

STAGES = {1: (Stage1Config, stage1.init_stage1, stage1.make_stage1_step, stage1.make_optimizer),
          2: (Stage2Config, stage2.init_stage2, stage2.make_stage2_step, stage2.make_optimizer)}
_initial = {}


def _state(job):
    """A fresh train state on the CPU as ``init_stage1`` / ``init_stage2``
    makes it (its weights initialised once per model, then copied), with the
    job's weights if it has any."""
    config, init, _, make_optimizer = STAGES[job["stage"]]
    cfg = config(**job["cfg"])
    key = (job["stage"], tuple(sorted(job["model"].items())), cfg.seed)
    if key not in _initial:
        _initial[key] = init(DeepLabLargeFOV(**job["model"]), cfg, device="cpu").model
    model = copy.deepcopy(_initial[key])
    state = TrainState(model, make_optimizer(model, cfg), torch.Generator().manual_seed(cfg.seed))
    if job.get("state") is not None:
        state.load_state_dict(job["state"])
    return cfg, state


def _step(job, cfg, state, mesh=None):
    step = STAGES[job["stage"]][2](state.model, cfg, state.optimizer, state.generator, axis_name=mesh)
    return step if mesh is None else data_parallel_step(step, mesh)


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def digest(tensors: dict) -> str:
    """The bits of a dict of tensors, in one string (results stay small)."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode() + tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _run_steps(job, mesh):
    """``steps`` data-parallel steps on the global ``batch``: metrics per
    step and the parameters after."""
    cfg, state = _state(job)
    replicate_to_mesh(state, mesh)
    step = _step(job, cfg, state, mesh)
    metrics = []
    for _ in range(job["steps"]):
        local = shard_batch(job["batch"], mesh)
        if job.get("local_rows"):  # this rank's rows padded further, masked
            from dsrg_tpu_torch.parallel.mesh import pad_batch_to_rows

            local = pad_batch_to_rows({k: v.numpy() for k, v in local.items()}, job["local_rows"])
        metrics.append({k: v.item() for k, v in step(local).items()})
    params = _params(state)
    return {"metrics": metrics, "digest": digest(params), "params": params if mesh.rank == 0 else None}


def _resume(job, mesh):
    """Two steps straight, against one, a snapshot (rank 0), a fresh state
    restored from it on every rank, and one more."""
    cfg, state = _state(job)
    step = _step(job, cfg, state, mesh)
    for _ in range(2):
        step(shard_batch(job["batch"], mesh))
    straight = _params(state)
    cfg, state = _state(job)
    step = _step(job, cfg, state, mesh)
    step(shard_batch(job["batch"], mesh))
    if mesh.rank == 0:
        ckpt.save_checkpoint(job["dir"], state, 1)
    dist.barrier()
    snap_generator = state.generator.get_state()
    cfg, state = _state(job)
    ckpt.restore_checkpoint(os.path.join(job["dir"], "step_1"), state)
    replicate_to_mesh(state, mesh)
    _step(job, cfg, state, mesh)(shard_batch(job["batch"], mesh))
    return {"straight": digest(straight), "resumed": digest(_params(state)),
            "snap_generator": snap_generator}


def _from_mesh(job, mesh):
    """A data-parallel step and a snapshot (rank 0); then on rank 0, one
    step of the plain, one-process kind from the state in memory and one
    from a fresh state restored from the snapshot."""
    cfg, state = _state(job)
    _step(job, cfg, state, mesh)(shard_batch(job["batch"], mesh))
    if mesh.rank != 0:
        return {}
    path = ckpt.save_checkpoint(job["dir"], state, state.step)
    saved = {"params": digest(_params(state)), "velocity": digest(state.optimizer.velocity)}
    _step(job, cfg, state)(job["batch"])
    cfg, restored = _state(job)
    ckpt.restore_checkpoint(path, restored)
    _step(job, cfg, restored)(job["batch"])
    return {"saved": saved, "direct": digest(_params(state)), "restored": digest(_params(restored))}


def _to_mesh(job, mesh):
    """A one-process run's snapshot (rank 0 alone: a plain step) restored on
    every rank for one data-parallel step, against a plain step on each
    rank and the same data-parallel step without the round trip."""
    if mesh.rank == 0:
        cfg, state = _state(job)
        _step(job, cfg, state)(job["batch"])
        ckpt.save_checkpoint(job["dir"], state, state.step)
    dist.barrier()
    cfg, state = _state(job)
    ckpt.restore_checkpoint(os.path.join(job["dir"], "step_1"), state)
    replicate_to_mesh(state, mesh)
    _step(job, cfg, state, mesh)(shard_batch(job["batch"], mesh))
    restored = digest(_params(state))
    cfg, state = _state(job)
    _step(job, cfg, state)(job["batch"])
    _step(job, cfg, state, mesh)(shard_batch(job["batch"], mesh))
    return {"restored": restored, "direct": digest(_params(state))}


def _geometry(job, mesh):
    m = distributed.make_global_mesh()
    return {"slices": [distributed.local_batch_slice(b) for b in job["batches"]],
            "mesh": (m.rank, m.world_size, m.size, str(m.device), m.axis)}


JOBS = {"steps": _run_steps, "resume": _resume, "from_mesh": _from_mesh, "to_mesh": _to_mesh,
        "geometry": _geometry}


def run_jobs(coordinator, world_size, rank, spec_path, out_path):
    torch.set_num_threads(2)
    distributed.init_group(coordinator, world_size, rank, device="cpu")
    try:
        mesh = make_mesh()
        spec = torch.load(spec_path, weights_only=False)
        results = {name: JOBS[job["kind"]](job, mesh) for name, job in spec.items()}
        torch.save(results, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


# what ``cli`` sets in tools/train.py: no mirroring and no dropout
CLI_PATCHES = {"Stage1Config": functools.partial(Stage1Config, mirror=False),
               "Stage2Config": functools.partial(Stage2Config, mirror=False),
               "FAMILIES": {"vgg16": functools.partial(DeepLabLargeFOV, dropout_rate=0.0)}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_cli(argv):
    from dsrg_tpu_torch.tools import train

    for name, value in CLI_PATCHES.items():
        setattr(train, name, value)
    torch.set_num_threads(2)
    train.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        run_cli(sys.argv[2:])
    else:
        run_jobs(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
