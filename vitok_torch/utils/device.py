"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a host without a card.

    The entry points default to ``"cuda"``; without a card they raise rather
    than carry on on the CPU. Callers ask for the host with ``"cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass device='cpu' to run on the host"
        )
    return device


__all__ = ["resolve_device"]
