from dsrg_tpu_torch.ops.interp import caffe_interp_shrink, zoom_bilinear, zoom_matrix  # noqa: F401
from dsrg_tpu_torch.ops.softmax import floored_softmax  # noqa: F401
