"""Where the port's entry points run: the card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device.  Raises when the
    card is asked for (or defaulted to) and PyTorch sees none: nothing
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run on the CPU, with the kernels' plain versions")
    return dev
