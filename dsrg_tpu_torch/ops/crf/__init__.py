from dsrg_tpu_torch.ops.crf.api import (  # noqa: F401
    CRF,
    DenseCRF,
    crf_log_refine,
    crf_refine_probs,
    crf_refine_with_log,
    crf_refine_with_log_truegrad,
)
from dsrg_tpu_torch.ops.crf.exact import mean_field_exact  # noqa: F401
