"""VGG19 feature extractor for the perceptual and style losses. The
counterpart of `wavemamba_tpu/models/vgg.py`.

`VGG19` is torchvision's VGG19 `features` trunk (its module indices, so a
torchvision state dict loads as it is), read at named taps (conv1_1 ...
conv5_4, reluX_Y, poolX). Pretrained weights come from a torchvision
state-dict `.pth` through `load_vgg19_params` (nothing is downloaded);
`init_vgg19_params` gives weights of the right shapes for tests.

Inputs are NHWC RGB in [0, 1] (or [-1, 1] with `range_norm`), normalised
with ImageNet's mean and std, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# VGG19: channels of each conv, 'M' a 2x2 max-pool.
_VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def layer_names():
    """Ordered tap names: conv and relu of each conv, poolN after each block."""
    names = []
    block, conv = 1, 1
    for v in _VGG19:
        if v == "M":
            names.append(f"pool{block}")
            block += 1
            conv = 1
        else:
            names.append(f"conv{block}_{conv}")
            names.append(f"relu{block}_{conv}")
            conv += 1
    return names


class VGG19(nn.Module):
    """torchvision's `vgg19().features` (conv, ReLU, ..., max-pool at the same
    indices); `tap_names[i]` names the output of `features[i]`."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _VGG19:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        self.tap_names = layer_names()
        self.register_buffer("mean", torch.from_numpy(_MEAN.copy()).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.from_numpy(_STD.copy()).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x, layer_name_list, use_input_norm=True, range_norm=False):
        """x: NCHW RGB. Returns {name: NCHW feature} for the requested taps,
        stopping at the last one asked for."""
        if range_norm:
            x = (x + 1.0) / 2.0
        if use_input_norm:
            x = (x - self.mean) / self.std
        wanted = set(layer_name_list)
        out = {}
        for name, layer in zip(self.tap_names, self.features):
            x = layer(x)  # out of place: a conv's tap survives the ReLU after it
            if name in wanted:
                out[name] = x
                if len(out) == len(wanted):
                    break
        return out


def init_vgg19_params(generator: torch.Generator) -> VGG19:
    """Weights of the right shapes (tests): the JAX package's distributions,
    conv weights N(0, 0.02^2) and zero biases, drawn from `generator`."""
    net = VGG19()
    with torch.no_grad():
        for m in net.features:
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                m.bias.zero_()
    return net


def load_vgg19_params(path) -> VGG19:
    """A torchvision vgg19 state dict (``features.N.weight`` OIHW; the
    classifier's keys, if any, are not read) -> `VGG19`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    net = VGG19()
    net.features.load_state_dict({k[len("features."):]: v for k, v in sd.items()
                                  if k.startswith("features.")}, strict=True)
    return net


def vgg19_features(net: VGG19, x, layer_name_list, use_input_norm=True, range_norm=False):
    """x: NHWC RGB. Returns {name: NHWC feature} for the requested taps."""
    feats = net(x.permute(0, 3, 1, 2), layer_name_list, use_input_norm, range_norm)
    return {k: v.permute(0, 2, 3, 1) for k, v in feats.items()}


def _gram(f):
    """f: NCHW -> (B, C, C) Gram matrix over the pixels, divided by c*h*w."""
    b, c, h, w = f.shape
    m = f.reshape(b, c, h * w)
    return torch.bmm(m, m.transpose(1, 2)) / (c * h * w)


def perceptual_loss(vgg: VGG19, pred, target, layer_weights, criterion="l1",
                    perceptual_weight=1.0, style_weight=0.0, use_input_norm=True,
                    range_norm=False):
    """Perceptual loss and, with `style_weight` > 0, the style (Gram) loss
    of NHWC `pred` against `target` (no gradient to the target). Each term
    is None where its weight is 0. `criterion`: 'l1', 'l2' / 'mse', or 'fro'
    (the Frobenius norm of the whole difference)."""
    names = list(layer_weights)
    fx = vgg(pred.permute(0, 3, 1, 2), names, use_input_norm, range_norm)
    fy = vgg(target.detach().permute(0, 3, 1, 2), names, use_input_norm, range_norm)

    def crit(a, b):
        if criterion == "l1":
            return (a - b).abs().mean()
        if criterion in ("l2", "mse"):
            return ((a - b) ** 2).mean()
        if criterion == "fro":
            return torch.linalg.vector_norm(a - b)
        raise NotImplementedError(criterion)

    percep = 0.0
    style = 0.0
    for name, wgt in layer_weights.items():
        percep = percep + crit(fx[name], fy[name]) * wgt
        if style_weight > 0:
            style = style + crit(_gram(fx[name]), _gram(fy[name])) * wgt
    out_p = percep * perceptual_weight if perceptual_weight > 0 else None
    out_s = style * style_weight if style_weight > 0 else None
    return out_p, out_s
