"""The device an entry point was asked for."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device(name)``; raises where a CUDA device is asked for and
    none is there, instead of moving the work to the CPU. Entry points run on
    the card by default and on the CPU only when asked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name}: no CUDA device is available; ask for the CPU "
            f"explicitly (--device cpu, device='cpu') to run there")
    return device
