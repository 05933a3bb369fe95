"""Recipe configurations: the port's own copies of
``dsrg_tpu/config.py::Stage1Config`` and ``Stage2Config``, with the same
fields and defaults (``solver-s.prototxt`` + ``train-s.prototxt`` for stage
1, ``solver-f.prototxt`` + ``train-f.prototxt`` for stage 2)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    """DSRG training (seed + constrain losses), solver-s + train-s parity.

    ``fast_dropout_rng`` is kept so the dataclass matches the JAX package's;
    it has no effect in the port, whose dropout bytes come from torch's
    Philox generator, which is already cheap on the card.
    """

    num_classes: int = 21
    batch_size: int = 20             # train-s.prototxt:17
    crop_size: int = 321             # train-s.prototxt:18-19
    cue_size: int = 41               # AnnotationLayer top shape (pylayers.py:366)
    th1: float = 0.99                # DSRG param_str (train-s.prototxt:784)
    th2: float = 0.85
    crf_scale_factor: float = 12.0   # pylayers.py:82,335
    crf_iters: int = 10
    crf_true_grad: bool = False      # True: autograd through the mean field
                                     # instead of the heuristic (1-Q)*g backward
    crf_fast: bool = False           # bf16-rounded CRF kernel operands
    fast_dropout_rng: bool = True    # no effect in the port (see above)
    mirror: bool = True              # AnnotationLayer param_str

    base_lr: float = 5e-4            # solver-s.prototxt:4-8
    gamma: float = 0.33
    stepsize: int = 1000
    momentum: float = 0.9
    weight_decay: float = 5e-4
    clip_gradients: float = 0.0      # Caffe solver clip_gradients (0 = off)
    max_iter: int = 8000
    snapshot_every: int = 8000
    seed: int = 0                    # solver random_seed

    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    """Retraining on pseudo ground truth, solver-f + train-f parity.

    ``fast_dropout_rng`` has no effect in the port, as in ``Stage1Config``.
    """

    num_classes: int = 21
    batch_size: int = 10             # train-f.prototxt:11
    crop_size: int = 321
    ignore_label: int = 255
    shrink_factor: int = 8           # Interp layer (train-f.prototxt:727)
    mirror: bool = True

    base_lr: float = 1e-3            # solver-f.prototxt:5-7
    power: float = 0.9
    momentum: float = 0.9
    weight_decay: float = 5e-4
    clip_gradients: float = 0.0      # Caffe solver clip_gradients (0 = off)
    max_iter: int = 20000
    snapshot_every: int = 10000
    seed: int = 0

    compute_dtype: str = "float32"
    fast_dropout_rng: bool = True    # no effect in the port (see Stage1Config)
