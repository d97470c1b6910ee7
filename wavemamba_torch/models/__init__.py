"""Model factory (`type: WaveMamba` only): `build_network` for weights that
exist, `init_network` for a fresh model to train (or, with train=False, to
evaluate).

One rule for every key of a `network_g` dict, whoever passes it (the inference
CLI, the trainer, the yml pipelines): a field of `WaveMambaConfig` is honoured
(the architecture, `scan_impl`, `scan_chunk`, `scan_sub`, `remat`,
`remat_policy`, `conv_impl`, `compute_dtype`, `scan_dtype`); an execution knob of the JAX
package that the port does not run yet is accepted at the value of the path
the port does run and raises `NotImplementedError`, naming where it waits in
ROADMAP.md, at any other; any other key raises `KeyError`. Nothing is dropped
silently.

`conv_impl: fused` is inference only, as in the JAX package (its chains have no
VJP): `build_network` and `init_network(..., train=False)` build it, and a
model to train (`init_network`, the trainer, `pipelines.train`) refuses it. It
runs under either `compute_dtype`: in bf16 the chains take and return bf16
activations.

`remat` (on by default) recomputes the blocks in the backward pass under
`remat_policy`, the JAX package's default 'save_scan' or 'full'
(`models/wavemamba.py`), as the shipped train ymls train."""

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


# The JAX package's execution knobs that the port does not run yet: the values
# it accepts (what the port does anyway) and where the others wait.
_NOT_PORTED = {
    "conv1x1_as_conv": (((), []), "queue 1, item 15 (a TPU layout policy for the 1x1 convs)"),
    "scan_mesh": ((None,), "queue 1, item 9 (multi-GPU)"),
    "scan_mesh_axis": (("data",), "queue 1, item 9 (multi-GPU)"),
}


def config_from_opt(opt: dict) -> WaveMambaConfig:
    """A `network_g` dict -> the config, by the module docstring's rule."""
    opt = dict(opt)
    name = opt.pop("type")
    if name == "ART":
        raise NotImplementedError("the ART network waits for ROADMAP queue 1, item 11")
    if name != "WaveMamba":
        raise KeyError(f"unknown arch type {name!r}; the port builds 'WaveMamba' only")
    known = {f.name for f in dataclasses.fields(WaveMambaConfig)}
    kw = {}
    for key, value in opt.items():
        if key in known:
            kw[key] = tuple(value) if isinstance(value, list) else value
        elif key in _NOT_PORTED:
            accepted, where = _NOT_PORTED[key]
            if value not in accepted:
                raise NotImplementedError(f"network_g.{key}={value!r} is not ported: it waits "
                                          f"for ROADMAP {where}; the port runs {accepted[0]!r}")
        else:
            raise KeyError(f"unknown network_g key {key!r}")
    return WaveMambaConfig(**kw)


def build_network(opt: dict, state_dict: dict, device="cuda") -> WaveMamba:
    """opt: {'type': 'WaveMamba', **fields} (see the module docstring for the
    keys) -> the model with `state_dict` loaded strictly, in eval mode on
    `device`."""
    cfg = config_from_opt(opt)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = WaveMamba(cfg)
    model = model.to_empty(device=dev).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


def refuse_training(cfg: WaveMambaConfig) -> None:
    """Raise for a config that cannot train: `conv_impl='fused'`."""
    if cfg.conv_impl == "fused":
        raise NotImplementedError("conv_impl='fused' is inference only: the fused conv chains have "
                                  "no backward, as in the JAX package; train with conv_impl='xla' "
                                  "(the same weights serve both)")


def init_network(opt: dict, generator: torch.Generator, device="cuda", train=True) -> WaveMamba:
    """A fresh model: built on the CPU, filled from `generator` by
    `init_wavemamba`, moved to `device`, in train mode, or in eval mode with
    `train=False` (which alone takes `conv_impl: fused`)."""
    dev = resolve_device(device)
    cfg = config_from_opt(opt)
    if train:
        refuse_training(cfg)
    return init_wavemamba(WaveMamba(cfg), generator).to(dev).train(train)


__all__ = ["WaveMamba", "WaveMambaConfig", "build_network", "config_from_opt", "init_network",
           "init_wavemamba", "param_count", "refuse_training", "wavemamba_apply",
           "wavemamba_forward"]
