"""Device resolution for the port's entry points.

The port runs on a CUDA card unless the caller asks for the CPU. There
is no silent fallback: asking for ``"cuda"`` on a machine without one
raises, and the message says how to run on the CPU instead.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``"cuda"`` (the default), ``"cuda:N"`` or ``"cpu"`` → a
    ``torch.device``; raises ``RuntimeError`` for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False here; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
