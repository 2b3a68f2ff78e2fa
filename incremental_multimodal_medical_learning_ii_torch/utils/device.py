"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Nothing
falls back: asking for CUDA on a host without it raises.  On CUDA, TF32 is
turned off for matmuls and cuDNN convolutions, because the JAX package
computes float32 at ``Precision.HIGHEST`` (cuDNN convolutions default to
TF32, which keeps about three decimal digits).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
