"""PASCAL VOC constants used by the serving path."""

import numpy as np

# Caffe VGG16 per-channel mean, BGR order (the reference's test-ms.py)
BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)
