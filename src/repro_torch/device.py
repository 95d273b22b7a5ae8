"""Device resolution for the port's entry points.

Every entry point (``ContinualTrainer``, ``make_cl_step``, ``init_carry``, the
kernel wrappers' callers) runs on ``cuda`` unless the caller asks for the CPU
with ``device="cpu"``. Without a card and without that request they raise:
the port never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is visible; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
