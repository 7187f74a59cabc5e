"""The one device rule of the port: entry points run on the CUDA device
unless the caller asks for another one. There is no silent fallback — with
no card and no explicit device, `resolve_device` raises."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> the current CUDA device (raises when there is none);
    anything else is taken as given, a bare "cuda" pinned to the current
    device so that equal devices compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
