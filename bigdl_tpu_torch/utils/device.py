"""Device selection for the port's entry points, and placing one tensor
on several devices."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device``. ``None`` means the card
    (``cuda``): without CUDA that raises instead of falling back to the
    CPU, so a run that was meant for the GPU never measures the CPU by
    mistake. Callers who want the CPU say ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def broadcast(x, devices):
    """``x`` on each of ``devices`` (one per tensor-parallel shard): one
    copy per distinct device, and ``x`` itself where it already lives."""
    copies = {x.device: x}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = x.to(d)
        out.append(copies[d])
    return out
