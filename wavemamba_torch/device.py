"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device. Asking for CUDA where there is none raises:
    the port never moves to the CPU unless the caller passes device='cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    return dev
