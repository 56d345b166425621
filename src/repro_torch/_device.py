"""Device resolution and host conversion shared by the port's modules.

Every entry point of the port runs on the card unless the caller asks for
another device: ``resolve_device(None)`` is ``cuda`` and raises where
CUDA is missing, instead of carrying on quietly on the CPU. The tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU by "
                "default; pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


def as_tensor(x: Any, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (tensor, numpy array, list or scalar) as a tensor on
    ``device``; a tensor already there with the right dtype is returned
    as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def to_numpy(x: Any) -> np.ndarray:
    """Host numpy copy of a tensor on any device (or of array-likes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def raw_stream(device: torch.device) -> int:
    """The current CUDA stream's handle on ``device``, for a kernel's C
    entry point (the binding that PyTorch's own generated kernel launchers
    call: a ``Stream`` object costs several microseconds of host time a
    launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
