"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names another device
(the CPU tests pass ``device="cpu"``). Without a device and without CUDA they
raise: a serving or measurement path never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises if CUDA is absent);
    anything else -> ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter or buffer (None if it has none)."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return None
