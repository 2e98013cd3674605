"""The device the port's entry points build on."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device.  The entry points default to the card;
    asking for it where torch sees none raises, so a run meant for the GPU
    never goes quietly to the CPU.  Pass device="cpu" to run there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default and torch sees none: "
            "pass device='cpu' to run on the CPU"
        )
    return device


def multi_processor_count(device) -> int:
    """The SM count of a CUDA device (132 on an H100 SXM, 114 on an H100
    PCIe), which the kernels' launch policies size their grids by."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count
