from dsrg_tpu_torch.utils.confusion import ConfusionMatrix, confusion_matrix_np  # noqa: F401
from dsrg_tpu_torch.utils.palette import VOC_PALETTE, read_mask_png, write_palette_png, write_png  # noqa: F401
