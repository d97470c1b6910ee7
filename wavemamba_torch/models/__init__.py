"""Model factory: `config_from_opt` for a `network_g` dict, `build_network`
for weights that exist, `init_network` for a fresh model to train (or, with
train=False, to evaluate). The counterpart of `wavemamba_tpu/models/__init__.py`:
`type:` resolves through the built-in factories (`register_arch`: 'WaveMamba'
and 'ART'), then through the user-extensible `utils.registry.ARCH_REGISTRY`;
the config's type picks the module and its init (`module_for`, `init_for`),
as the JAX package's `init_for` / `apply_for` do. A custom arch's config can
carry `module_fn(cfg) -> nn.Module` and `init_fn(model, generator)`.

One rule for every key of a `network_g` dict, whoever passes it (the inference
CLI, the trainer, the yml pipelines): a field of the arch's config is honoured
(for WaveMamba the architecture, `scan_impl`, `scan_chunk`, `scan_sub`,
`scan_mesh`, `scan_mesh_axis`, `remat`, `remat_policy`, `conv_impl`,
`compute_dtype`, `scan_dtype`, `conv1x1_as_conv`; for ART its `ARTConfig`
fields); any other key raises `KeyError`. Every execution knob of the JAX
package is a field of the port's config. Nothing is dropped silently (the JAX
package's ART factory drops unknown keys; the execution knobs `remat`,
`scan_impl`, ... are WaveMamba's only).

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
from wavemamba_torch.models.art import ART, ARTConfig, art_apply, art_forward, init_art
from wavemamba_torch.models.wavemamba import (
    WaveMamba,
    WaveMambaConfig,
    init_wavemamba,
    param_count,
    wavemamba_apply,
    wavemamba_forward,
)


_ARCHS = {}


def register_arch(name):
    """Register a built-in factory `fn(**network_g keys) -> config`."""
    def deco(fn):
        _ARCHS[name] = fn
        return fn

    return deco


def _strict_fields(config_type, opt: dict) -> dict:
    """The keys of `opt` that are fields of `config_type` (lists as tuples);
    any other key raises `KeyError`."""
    known = {f.name for f in dataclasses.fields(config_type)}
    kw = {}
    for key, value in opt.items():
        if key in known:
            kw[key] = tuple(value) if isinstance(value, list) else value
        else:
            raise KeyError(f"unknown network_g key {key!r} for {config_type.__name__}")
    return kw


@register_arch("WaveMamba")
def _build_wavemamba(**kw):
    return WaveMambaConfig(**_strict_fields(WaveMambaConfig, kw))


@register_arch("ART")
def _build_art(**kw):
    return ARTConfig(**_strict_fields(ARTConfig, kw))


def config_from_opt(opt: dict):
    """A `network_g` dict -> the config, by the module docstring's rule:
    the built-in factories, then `ARCH_REGISTRY`."""
    from wavemamba_torch.utils.registry import ARCH_REGISTRY

    opt = dict(opt)
    name = opt.pop("type")
    if name in _ARCHS:
        return _ARCHS[name](**opt)
    if name in ARCH_REGISTRY:
        return ARCH_REGISTRY.get(name)(**opt)
    raise KeyError(f"Unknown arch type {name!r}; known: "
                   f"{sorted(_ARCHS) + sorted(ARCH_REGISTRY.keys())}")


def module_for(cfg):
    """Config -> the module class (or factory) that builds it from `cfg`."""
    if isinstance(cfg, WaveMambaConfig):
        return WaveMamba
    if isinstance(cfg, ARTConfig):
        return ART
    if hasattr(cfg, "module_fn"):
        return cfg.module_fn
    raise TypeError(f"no module for config type {type(cfg).__name__}")


def init_for(cfg):
    """Config -> the init function (model, generator) -> model."""
    if isinstance(cfg, WaveMambaConfig):
        return init_wavemamba
    if isinstance(cfg, ARTConfig):
        return init_art
    if hasattr(cfg, "init_fn"):
        return cfg.init_fn
    raise TypeError(f"no init for config type {type(cfg).__name__}")


def build_network(opt: dict, state_dict: dict, device="cuda"):
    """opt: {'type': 'WaveMamba' | 'ART' | a registered arch, **fields} (see
    the module docstring for the keys) -> the model with `state_dict` loaded
    strictly, in eval mode on `device`."""
    cfg = config_from_opt(opt)
    dev = resolve_device(device)
    with torch.device("meta"):
        model = module_for(cfg)(cfg)
    model = model.to_empty(device=dev).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


def refuse_training(cfg) -> None:
    """Raise for a config that cannot train: a WaveMamba with
    `conv_impl='fused'` (the chains have no backward). Other archs have no
    such knob."""
    if isinstance(cfg, WaveMambaConfig) and cfg.conv_impl == "fused":
        raise NotImplementedError("conv_impl='fused' is inference only: the fused conv chains have "
                                  "no backward, as in the JAX package; train with conv_impl='xla' "
                                  "(the same weights serve both)")


def seq_sharded(cfg) -> bool:
    """Whether `cfg`'s scan splits its token axis over the ranks of a mesh
    (`scan_impl='seq_sharded'`): every rank must then run the same rows."""
    return isinstance(cfg, WaveMambaConfig) and cfg.scan_impl == "seq_sharded"


def init_network(opt: dict, generator: torch.Generator, device="cuda", train=True):
    """A fresh model: built on the CPU, filled from `generator` by its arch's
    init (`init_wavemamba`, `init_art`), moved to `device`, in train mode, or
    in eval mode with `train=False` (which alone takes `conv_impl: fused`)."""
    dev = resolve_device(device)
    cfg = config_from_opt(opt)
    if train:
        refuse_training(cfg)
    return init_for(cfg)(module_for(cfg)(cfg), generator).to(dev).train(train)


__all__ = ["ART", "ARTConfig", "WaveMamba", "WaveMambaConfig", "art_apply", "art_forward",
           "build_network", "config_from_opt", "init_art", "init_for", "init_network",
           "init_wavemamba", "module_for", "param_count", "refuse_training", "register_arch",
           "seq_sharded", "wavemamba_apply", "wavemamba_forward"]
