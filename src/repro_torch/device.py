"""The one place a config's ``device`` string becomes a `torch.device`,
and the one test that routes a tensor to a kernel or its plain version."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "on_cuda"]


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


def on_cuda(t: torch.Tensor) -> bool:
    """Kernel dispatch: True for a CUDA tensor (launch the kernel or raise),
    False for a CPU tensor (take the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernel for device {t.device} (cuda | cpu)")
