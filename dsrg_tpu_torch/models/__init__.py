from dsrg_tpu_torch.models.vgg16_largefov import DeepLabLargeFOV  # noqa: F401
