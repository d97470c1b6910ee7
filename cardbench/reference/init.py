"""The benchmark's own weights: a state dict under the upstream `.pth` keys,
drawn from a seed on the device in a few large calls.

The distributions are those the program's `init_wavemamba` uses, frozen
here so that a change to the program cannot change the benchmark's weights:
convolutions and linear layers U(+-1/sqrt(fan_in)) for weight and bias
(torch's default), SS2D's x_proj U(+-1/sqrt(d_inner)) and dt_projs
U(+-1/sqrt(dt_rank)), the dt bias the inverse softplus of a log-uniform draw
in [0.001, 0.1] floored at 1e-4, A_logs = log(1..N), Ds = 1, norms,
skip scales and the attention temperature 1 (biases 0), PReLU 0.25.

Every uniform number comes from one `torch.rand` call on the generator's
device, and the dt biases from a second; the slices are handed out in the
state dict's key order. The same seed and device give the same weights.
"""

from __future__ import annotations

import math

import torch


def _fan_in(name: str, shape: tuple, module_of: dict) -> int | None:
    """fan_in of a uniformly drawn parameter, None for a fixed one."""
    mod = module_of[name.rsplit(".", 1)[0]]
    leaf = name.rsplit(".", 1)[1]
    if isinstance(mod, torch.nn.Conv2d):
        return (mod.in_channels // mod.groups) * mod.kernel_size[0] * mod.kernel_size[1]
    if isinstance(mod, torch.nn.Linear):
        return mod.in_features
    if leaf == "x_proj_weight":
        return shape[2]
    if leaf == "dt_projs_weight":
        return shape[2]
    return None


def _fixed(name: str, shape: tuple) -> torch.Tensor:
    """The value of a parameter that is not drawn."""
    leaf = name.rsplit(".", 1)[1]
    if leaf == "A_logs":
        return torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32)).expand(shape)
    if name.endswith("conv_du.1.weight"):  # PReLU
        return torch.full(shape, 0.25)
    if leaf == "bias":  # LayerNorm
        return torch.zeros(shape)
    return torch.ones(shape)  # LayerNorm weight, Ds, skip scales, temperature


def make_state_dict(model: torch.nn.Module, seed: int, device) -> dict:
    """{key: float32 tensor on `device`} for `model` (the reference module,
    whose keys are the `.pth` keys), from `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    module_of = dict(model.named_modules())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    drawn = {k: f for k, s in shapes.items() if (f := _fan_in(k, s, module_of)) is not None}
    total = sum(math.prod(shapes[k]) for k in drawn)
    unit = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if k in drawn:
            size = math.prod(s)
            bound = 1.0 / math.sqrt(drawn[k])
            out[k] = (unit[at:at + size] * (2 * bound) - bound).view(s)
            at += size
        elif k.endswith("dt_projs_bias"):
            u = torch.rand(s, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
            dt = dt.clamp_min(1e-4)
            out[k] = dt + torch.log(-torch.expm1(-dt))
        else:
            out[k] = _fixed(k, s).to(device).contiguous()
    return out
