"""PyTorch + CUDA port of ``dsrg_tpu`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package module for module.  Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas for the TPU is a CUDA
kernel written by hand under ``csrc/``, built at first use by ``_build.py``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from dsrg_tpu_torch._device import resolve_device  # noqa: F401
