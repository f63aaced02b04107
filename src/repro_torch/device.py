"""Where the port's entry points run.

They run on ``cuda`` unless the caller asks for the CPU; asking for a GPU on
a host without one raises instead of moving the work to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch finds no CUDA device; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
