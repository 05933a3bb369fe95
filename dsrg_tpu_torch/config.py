"""Stage-1 recipe configuration: the port's own copy of
``dsrg_tpu/config.py::Stage1Config``, with the same fields and defaults
(``solver-s.prototxt`` + ``train-s.prototxt``)."""

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
