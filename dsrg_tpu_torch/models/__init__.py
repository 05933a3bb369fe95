from dsrg_tpu_torch.models.resnet101_deeplab import ResNet101DeepLab  # noqa: F401
from dsrg_tpu_torch.models.vgg16_largefov import DeepLabLargeFOV  # noqa: F401

# the CLIs' --model / --model-name choices
FAMILIES = {"vgg16": DeepLabLargeFOV, "resnet101": ResNet101DeepLab}
