"""The port's data parallelism (``dsrg_tpu_torch/parallel``) held against the
JAX package on the CPU.

* ``pad_batch_to_multiple``, ``pad_batch_to_rows``, ``tools/train.py``'s
  ``_process_geometry`` and ``local_batch_slice`` give JAX's results bit for
  bit;
* two gloo ranks (``tests/_torch_dist_worker.py``, spawned once for the
  module) run the stage-1 and stage-2 steps through ``data_parallel_step``
  on an uneven batch of 5 padded to 6, from the port's initial weights,
  which ``models/convert.py`` carries to JAX's ``data_parallel_step``
  on a 2-device sub-mesh: loss within 1e-5, parameters within 2e-5 / 1e-7
  (dropout 0 and mirror off, as JAX's own DP tests run); both ranks end
  with the same parameters and metrics;
* within the port: one rank against two at batch 4, and two with each
  rank's rows padded further; snapshots written at world size 2 restore at
  world size 1 and the reverse, continuing bit for bit
  (``tests/test_checkpoint_topology.py``); with dropout and mirroring on, a
  resume at world size 2 continues every rank's random stream exactly;
* ``Predictor(mesh=...)`` over two CPU shards writes
  ``predict_masks_device``'s masks.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsrg_tpu.config import Stage1Config as JStage1Config, Stage2Config as JStage2Config
from dsrg_tpu.models import DeepLabLargeFOV as JaxLargeFOV
from dsrg_tpu.parallel import data_parallel_step as j_data_parallel_step
from dsrg_tpu.parallel import distributed as jdistributed
from dsrg_tpu.parallel import make_mesh as j_make_mesh
from dsrg_tpu.parallel import mesh as jmesh
from dsrg_tpu.parallel import shard_batch as j_shard_batch
from dsrg_tpu.tools import train as jtrain
from dsrg_tpu.train import stage1 as jstage1
from dsrg_tpu.train import stage2 as jstage2
from dsrg_tpu.train.train_state import TrainState as JaxTrainState
from dsrg_tpu_torch import inference as tinf
from dsrg_tpu_torch.config import Stage1Config, Stage2Config
from dsrg_tpu_torch.models import DeepLabLargeFOV
from dsrg_tpu_torch.models.convert import flax_from_params
from dsrg_tpu_torch.parallel import distributed, make_mesh, mesh as tmesh
from dsrg_tpu_torch.parallel.mesh import Mesh
from dsrg_tpu_torch.tools import train as ttrain
from dsrg_tpu_torch.train import checkpoint as ckpt
from dsrg_tpu_torch.train.stage1 import init_stage1, make_stage1_step, rank_streams
from dsrg_tpu_torch.train.stage2 import init_stage2
from tests._torch_dist_worker import digest, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
NC, CROP, CUE, HEADS = 5, 41, 6, (2, 4)
MODEL = dict(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
S1 = dict(num_classes=NC, crop_size=CROP, cue_size=CUE, crf_iters=2, mirror=False)
S2 = dict(num_classes=NC, crop_size=CROP, mirror=False)


# -- pure functions against JAX's ------------------------------------------------------


def _batch(rng, b):
    return {"images": rng.normal(size=(b, 3, 4, 3)).astype(np.float32),
            "labels": rng.integers(0, 255, (b, 3, 4)).astype(np.int32)}


@pytest.mark.parametrize("b,multiple", [(5, 2), (6, 2), (20, 8), (10, 4), (3, 1)])
def test_pad_batch_to_multiple_matches_jax(b, multiple):
    batch = _batch(np.random.default_rng(b), b)
    for inp in (batch, {**batch, "pad_mask": np.arange(b, dtype=np.float32) % 2}):
        got, ref = tmesh.pad_batch_to_multiple(inp, multiple), jmesh.pad_batch_to_multiple(inp, multiple)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("b,rows,n_valid", [(1, 3, 0), (2, 3, None), (3, 3, 2), (2, 5, 7)])
def test_pad_batch_to_rows_matches_jax(b, rows, n_valid):
    batch = _batch(np.random.default_rng(rows), b)
    got, ref = tmesh.pad_batch_to_rows(batch, rows, n_valid), jmesh.pad_batch_to_rows(batch, rows, n_valid)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_process_geometry_and_local_slice_match_jax():
    for b in (1, 5, 10, 20, 24):
        for n_proc in (1, 2, 4, 8):
            for pid in range(n_proc):
                for n_dev in (n_proc, 2 * n_proc):
                    assert ttrain._process_geometry(b, n_proc, pid, n_dev) == jtrain._process_geometry(
                        b, n_proc, pid, n_dev)
    for b in (1, 4, 20):  # one process: both take the whole batch
        assert distributed.local_batch_slice(b) == jdistributed.local_batch_slice(b)


def test_rank_streams_fold_in_the_rank():
    """One rank draws from the shared stream itself; with several, each
    rank's stream differs and the shared one advances alike on every rank."""
    g = torch.Generator().manual_seed(3)
    assert rank_streams(g, None)() is g
    assert rank_streams(g, Mesh((torch.device("cpu"),)))() is g
    draws, states = [], []
    for rank in (0, 1):
        shared = torch.Generator().manual_seed(3)
        stream = rank_streams(shared, Mesh((torch.device("cpu"),), rank=rank, world_size=2))
        draws.append([torch.rand(4, generator=stream()) for _ in range(2)])
        states.append(shared.get_state())
    assert not torch.equal(draws[0][0], draws[1][0]) and not torch.equal(draws[0][0], draws[0][1])
    assert torch.equal(states[0], states[1])
    with pytest.raises(ValueError, match="generator"):
        rank_streams(None, Mesh((torch.device("cpu"),), world_size=2))


def test_data_parallel_step_needs_a_step_of_its_mesh():
    mesh = make_mesh(["cpu"])
    model = DeepLabLargeFOV(**MODEL)
    cfg = Stage1Config(**S1)
    state = init_stage1(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="axis_name=mesh"):
        tmesh.data_parallel_step(make_stage1_step(model, cfg, state.optimizer, state.generator), mesh)
    two = make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="one process per device"):
        tmesh.data_parallel_step(make_stage1_step(model, cfg, state.optimizer, state.generator, axis_name=two),
                                 two)


# -- two gloo ranks ----------------------------------------------------------------------


def _stage1_batch(rng, b):
    labels = np.zeros((b, NC), np.float32)
    labels[:, 0] = labels[:, 2] = 1.0
    labels[1::2, 3] = 1.0
    return {"images": rng.normal(size=(b, CROP, CROP, 3)).astype(np.float32) * 20,
            "labels": labels,
            "cues": (rng.uniform(size=(b, CUE, CUE, NC)) < 0.1).astype(np.float32) * labels[:, None, None, :]}


def _stage2_batch(rng, b):
    gt = rng.integers(0, NC, size=(b, CROP, CROP)).astype(np.int32)
    gt[0, :20] = 255
    gt[3, :, :15] = 255  # the ranks hold different valid pixel counts
    return {"images": rng.normal(size=(b, CROP, CROP, 3)).astype(np.float32) * 20, "labels": gt}


def _port_model(stage, batch_size):
    """The port's initial weights of a stage (what each rank's init makes)."""
    if stage == 1:
        return init_stage1(DeepLabLargeFOV(**MODEL), Stage1Config(batch_size=batch_size, **S1), device="cpu").model
    return init_stage2(DeepLabLargeFOV(**MODEL), Stage2Config(batch_size=batch_size, **S2), device="cpu").model


def _spawn(args):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return [subprocess.Popen([sys.executable, WORKER, *a], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, cwd=REPO, env=env) for a in args]


def _wait(procs, timeout=600):
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


class DistRun:
    """Every two-rank job of this module, started once; :meth:`results`
    waits for both ranks (the JAX side computes meanwhile)."""

    def __init__(self, base):
        self.base = base
        rng = np.random.default_rng(5)
        self.uneven1, self.uneven2 = _stage1_batch(rng, 5), _stage2_batch(rng, 5)
        self.even, pair = _stage1_batch(rng, 4), _stage1_batch(rng, 2)
        padded = tmesh.pad_batch_to_multiple
        spec = {
            "s1_uneven": dict(kind="steps", stage=1, cfg=dict(batch_size=5, **S1), model=MODEL,
                              batch=padded(self.uneven1, 2), steps=1),
            "s2_uneven": dict(kind="steps", stage=2, cfg=dict(batch_size=5, **S2), model=MODEL,
                              batch=padded(self.uneven2, 2), steps=1),
            "s1_even": dict(kind="steps", stage=1, cfg=dict(batch_size=4, **S1), model=MODEL, batch=self.even,
                            steps=1),
            "s1_even_padded": dict(kind="steps", stage=1, cfg=dict(batch_size=4, **S1), model=MODEL,
                                   batch=self.even, steps=1, local_rows=3),
            "resume": dict(kind="resume", stage=1, cfg=dict(batch_size=2, **{**S1, "mirror": True}),
                           model={**MODEL, "dropout_rate": 0.5}, batch=pair, dir=str(base / "resume")),
            "from_mesh": dict(kind="from_mesh", stage=1, cfg=dict(batch_size=2, **S1), model=MODEL, batch=pair,
                              dir=str(base / "from_mesh")),
            "to_mesh": dict(kind="to_mesh", stage=1, cfg=dict(batch_size=2, **S1), model=MODEL, batch=pair,
                            dir=str(base / "to_mesh")),
            "geometry": dict(kind="geometry", batches=[4, 6, 12]),
        }
        torch.save(spec, base / "spec")
        coord = f"127.0.0.1:{free_port()}"
        self._procs = _spawn([["jobs", coord, "2", str(r), str(base / "spec"), str(base / "out")]
                              for r in range(2)])
        self._results = None

    def results(self) -> list:
        if self._results is None:
            _wait(self._procs)
            self._results = [torch.load(self.base / f"out.{r}", weights_only=False) for r in range(2)]
        return self._results

    def kill(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    run = DistRun(tmp_path_factory.mktemp("dist"))
    yield run
    run.kill()


def _same_on_both_ranks(dist_run, name):
    """Rank 0's result, after checking that rank 1 ended with the same
    metrics and parameter bits."""
    a, b = (r[name] for r in dist_run.results())
    assert a["metrics"] == b["metrics"] and a["digest"] == b["digest"] == digest(a["params"])
    return a


def _assert_params_match_jax(params, jparams):
    got = flax_from_params(params)
    for name, p in jparams.items():
        for kind in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][kind], np.asarray(p[kind]), rtol=2e-5, atol=1e-7,
                                       err_msg=f"{name}.{kind}")


def _jax_dp(stage, batch):
    """JAX's ``data_parallel_step`` on a 2-device sub-mesh of the 8 virtual
    CPU devices, from the port's initial weights (``models/convert.py``)."""
    jm = JaxLargeFOV(num_classes=NC, head_dilations=HEADS, dropout_rate=0.0)
    if stage == 1:
        cfg, module = JStage1Config(batch_size=5, **S1), jstage1
        make = jstage1.make_stage1_step
    else:
        cfg, module = JStage2Config(batch_size=5, **S2), jstage2
        make = jstage2.make_stage2_step
    tx = module.make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, flax_from_params(_port_model(stage, 5).state_dict()))
    state = JaxTrainState.create(params, tx, jax.random.PRNGKey(7))
    mesh = j_make_mesh(jax.devices()[:2])
    dp = j_data_parallel_step(make(jm, cfg, tx, axis_name="data"), mesh, donate_state=False)
    return dp(state, j_shard_batch(jmesh.pad_batch_to_multiple(batch, mesh.size), mesh))


def test_two_rank_stage1_step_on_an_uneven_batch_matches_jax(dist_run):
    jstate, jm = _jax_dp(1, dist_run.uneven1)
    got = _same_on_both_ranks(dist_run, "s1_uneven")
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    for key in ("loss_seed", "loss_constrain", "grad_norm"):
        np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-4, err_msg=key)
    assert m["seed_pixels"] == float(jm["seed_pixels"])
    _assert_params_match_jax(got["params"], jstate.params)


def test_two_rank_stage2_step_on_an_uneven_batch_matches_jax(dist_run):
    jstate, jm = _jax_dp(2, dist_run.uneven2)
    got = _same_on_both_ranks(dist_run, "s2_uneven")
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["accuracy"], float(jm["accuracy"]), rtol=1e-6)
    np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    _assert_params_match_jax(got["params"], jstate.params)


def test_one_rank_and_two_ranks_padded_or_not_agree(dist_run):
    """Batch 4: one process (the plain step), two ranks of 2 rows, and two
    ranks whose 2 rows each pad to 3 masked ones: the same step."""
    model = DeepLabLargeFOV(**MODEL)
    cfg = Stage1Config(batch_size=4, **S1)
    state = init_stage1(model, cfg, device="cpu")
    step = make_stage1_step(model, cfg, state.optimizer, state.generator)
    ref = [{k: v.item() for k, v in step(dist_run.even).items()}]
    for name in ("s1_even", "s1_even_padded"):
        got = _same_on_both_ranks(dist_run, name)
        for m, r in zip(got["metrics"], ref):
            assert m["seed_pixels"] == r["seed_pixels"]
            for key in ("loss", "loss_seed", "loss_constrain", "grad_norm"):
                np.testing.assert_allclose(m[key], r[key], rtol=1e-5, err_msg=(name, key))
        for k, t in model.state_dict().items():
            np.testing.assert_allclose(got["params"][k].numpy(), t.numpy(), rtol=2e-5, atol=1e-7,
                                       err_msg=(name, k))


def test_world_size_two_snapshot_resumes_in_one_process(dist_run):
    """A data-parallel step, the snapshot rank 0 wrote: read here, it
    holds rank 0's state; restored for one plain step, it continues as the
    state in memory does (``tests/test_checkpoint_topology.py``'s contract;
    both plain steps ran in rank 0's process: a process's thread count can
    change a CPU convolution's rounding)."""
    got = dist_run.results()[0]["from_mesh"]
    model = DeepLabLargeFOV(**MODEL)
    state = init_stage1(model, Stage1Config(batch_size=2, **S1), device="cpu")
    ckpt.restore_checkpoint(str(dist_run.base / "from_mesh" / "step_1"), state)
    assert state.step == 1
    assert digest(model.state_dict()) == got["saved"]["params"]
    assert digest(state.optimizer.velocity) == got["saved"]["velocity"]
    assert got["restored"] == got["direct"]


def test_one_process_snapshot_resumes_at_world_size_two(dist_run):
    got = [r["to_mesh"] for r in dist_run.results()]
    assert got[0]["restored"] == got[0]["direct"] == got[1]["restored"] == got[1]["direct"]


def test_resume_at_world_size_two_continues_every_rank_stream(dist_run):
    """Mirror and dropout on: each rank draws its own stream, yet one step,
    a snapshot and a restore, then a second step, equal two steps straight
    on both ranks; the snapshot's stream is the same on both ranks."""
    results = [r["resume"] for r in dist_run.results()]
    assert results[0]["straight"] == results[0]["resumed"] == results[1]["straight"] == results[1]["resumed"]
    assert torch.equal(results[0]["snap_generator"], results[1]["snap_generator"])


def test_local_batch_slice_and_global_mesh_per_rank(dist_run):
    for rank, r in enumerate(dist_run.results()):
        assert r["geometry"]["slices"] == [slice(rank * b // 2, (rank + 1) * b // 2) for b in (4, 6, 12)]
        assert r["geometry"]["mesh"] == (rank, 2, 2, "cpu", "data")


# -- Predictor over a mesh ----------------------------------------------------------------


@pytest.mark.parametrize("mode", [{"sizes": [41, 57]}, {"scales": [0.75, 1.0]}])
def test_predictor_over_two_cpu_shards_equals_one(mode):
    rng = np.random.default_rng(2)
    images = []
    for h, w in ((40, 50), (37, 44), (45, 41)):  # three images: the chunk pads to 4
        img = np.zeros((h, w, 3), np.uint8)
        img[:, : w // 2] = [200, 60, 50]
        img[:, w // 2:] = [30, 180, 190]
        images.append(np.clip(img + rng.integers(-8, 8, img.shape), 0, 255).astype(np.uint8))
    model = DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS)
    init_stage1(model, Stage1Config(num_classes=NC), device="cpu")
    params = {k: v.clone() for k, v in model.state_dict().items()}
    plain = tinf.Predictor(DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS), params, num_classes=NC,
                           device="cpu")
    meshed = tinf.Predictor(DeepLabLargeFOV(num_classes=NC, head_dilations=HEADS), params, num_classes=NC,
                            mesh=make_mesh(["cpu", "cpu"]))
    want = plain.predict_masks_device(images, smooth=True, **mode)
    got = meshed.predict_masks_device(images, smooth=True, **mode)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)
