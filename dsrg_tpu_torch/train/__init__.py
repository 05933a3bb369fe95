# the JAX package's caffe_sgd (an optax transformation) is the class CaffeSGD here
from dsrg_tpu_torch.train.optimizer import CaffeSGD, lr_poly, lr_step, vgg_param_mults  # noqa: F401
from dsrg_tpu_torch.train.train_state import TrainState  # noqa: F401
