"""Device resolution for the port's entry points.

``None`` means the CUDA card. There is no quiet fallback: asking for CUDA
on a machine without it raises and names the way to run on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given. Raises RuntimeError
    when the result is a CUDA device and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available here; pass device='cpu' to run on the CPU")
    return dev
