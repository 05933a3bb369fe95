from dsrg_tpu_torch.losses.constrain import constrain_loss, constrain_loss_per_sample  # noqa: F401
from dsrg_tpu_torch.losses.seed import (  # noqa: F401
    balanced_seed_loss,
    balanced_seed_loss_per_sample,
    seed_loss,
)
from dsrg_tpu_torch.losses.softmax_ce import (  # noqa: F401
    softmax_cross_entropy_ignore,
    softmax_cross_entropy_ignore_sums,
)
