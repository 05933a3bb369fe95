"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for (explicitly or
    by default) and absent: there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def kernel_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} take CPU or CUDA tensors, got {x.device}")


def disable_tf32() -> None:
    """Run fp32 convolutions and matmuls in full fp32 on the card, as the JAX
    package computes them: PyTorch lets cuDNN convolve in TF32 by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
