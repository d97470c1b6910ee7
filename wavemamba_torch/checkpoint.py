"""Loading network weights (`.pth` only). The counterpart of
`wavemamba_tpu/train/checkpoint.py:load_network`."""

from __future__ import annotations

from wavemamba_torch.convert import load_pth
from wavemamba_torch.device import resolve_device


def load_network(path: str, device="cuda") -> dict:
    """A reference-format `.pth`/`.pt` -> its state dict on `device`.

    Orbax directories and `.wmx` deployment artifacts belong to the JAX
    package and are not read by the port."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: the port loads .pth/.pt weights only; Orbax directories and "
                         ".wmx artifacts wait for ROADMAP queue 1, items 8 (checkpoints) and "
                         "10 (deployment)")
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in load_pth(path).items()}
