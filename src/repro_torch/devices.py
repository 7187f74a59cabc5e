"""The one device rule of the port: entry points run on the CUDA device
unless the caller asks for another one. There is no silent fallback — with
no card and no explicit device, `resolve_device` raises. Host data reaches
the card through `host_to_device`, a copy that does not wait."""
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


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of host tensor `t` on `device` that does not wait for the
    device: staged in page-locked memory on the card, whose block the
    caching host allocator keeps until the copy has run (a copy from
    pageable memory may wait for the stream)."""
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
