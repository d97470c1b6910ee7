"""Model factory (`type: WaveMamba` only): `build_network` for weights that
exist, `init_network` for a fresh model to train."""

from __future__ import annotations

import dataclasses

import torch

from wavemamba_torch.device import resolve_device
from wavemamba_torch.models.wavemamba import (
    WaveMamba,
    WaveMambaConfig,
    init_wavemamba,
    param_count,
    wavemamba_apply,
    wavemamba_forward,
)


def _config(opt: dict) -> WaveMambaConfig:
    opt = dict(opt)
    name = opt.pop("type")
    if name != "WaveMamba":
        raise KeyError(f"unknown arch type {name!r}; the port builds 'WaveMamba' only")
    known = {f.name for f in dataclasses.fields(WaveMambaConfig)}
    return WaveMambaConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in opt.items() if k in known})


def build_network(opt: dict, state_dict: dict, device="cuda") -> WaveMamba:
    """opt: {'type': 'WaveMamba', **architecture fields} (keys that are not
    fields of `WaveMambaConfig`, such as the JAX package's other execution
    knobs, are ignored) -> the model with `state_dict` loaded strictly, in eval
    mode on `device`."""
    cfg = _config(opt)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = WaveMamba(cfg)
    model = model.to_empty(device=dev).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


def init_network(opt: dict, generator: torch.Generator, device="cuda") -> WaveMamba:
    """A fresh model for training: built on the CPU, filled from `generator`
    by `init_wavemamba`, moved to `device`, in train mode."""
    dev = resolve_device(device)
    return init_wavemamba(WaveMamba(_config(opt)), generator).to(dev).train()


__all__ = ["WaveMamba", "WaveMambaConfig", "build_network", "init_network", "init_wavemamba",
           "param_count", "wavemamba_apply", "wavemamba_forward"]
