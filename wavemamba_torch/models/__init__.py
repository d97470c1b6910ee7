"""Model factory (`type: WaveMamba` only)."""

from __future__ import annotations

import dataclasses

import torch

from wavemamba_torch.device import resolve_device
from wavemamba_torch.models.wavemamba import (
    WaveMamba,
    WaveMambaConfig,
    param_count,
    wavemamba_apply,
)


def build_network(opt: dict, state_dict: dict, device="cuda") -> WaveMamba:
    """opt: {'type': 'WaveMamba', **architecture fields} (keys that are not
    architecture fields, such as the JAX package's execution knobs, are
    ignored) -> the model with `state_dict` loaded strictly, in eval mode on
    `device`."""
    opt = dict(opt)
    name = opt.pop("type")
    if name != "WaveMamba":
        raise KeyError(f"unknown arch type {name!r}; the port builds 'WaveMamba' only")
    known = {f.name for f in dataclasses.fields(WaveMambaConfig)}
    cfg = WaveMambaConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in opt.items() if k in known})
    dev = resolve_device(device)
    with torch.device("meta"):
        model = WaveMamba(cfg)
    model = model.to_empty(device=dev).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


__all__ = ["WaveMamba", "WaveMambaConfig", "build_network", "param_count", "wavemamba_apply"]
