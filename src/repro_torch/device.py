"""The one place a config's ``device`` string becomes a `torch.device`."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a `torch.device`; no run moves to the CPU on its own.

    Raises `RuntimeError` when a CUDA device is asked for and none is
    visible — pass ``device="cpu"`` explicitly to run on the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host"
        )
    return dev
