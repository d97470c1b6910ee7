"""LPIPS with the AlexNet backbone. The counterpart of
`wavemamba_tpu/metrics/lpips.py`.

The reference scores LPIPS with torchmetrics' AlexNet variant on [-1, 1]
inputs. `LPIPS` is that graph as a module: the scaling layer, the five
AlexNet convolutions with their ReLUs (a 3x3 / stride-2 max-pool after the
first two), and at each of the five taps the channel-normalised squared
difference weighted by a linear head and averaged over the pixels.
`load_lpips_params` reads the released weights from a torch state dict in
each layout the standard packages save; nothing is downloaded.
`init_lpips_params` gives weights of the right shapes for tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# AlexNet's feature convolutions: (out_ch, kernel, stride, pad); taps after each ReLU.
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # max-pool(3, stride 2) after stages 0 and 1
_FEATURE_INDEX = [0, 3, 6, 8, 10]  # torchvision AlexNet's `features` index of each conv

# The scaling layer of inputs in [-1, 1] (the JAX package's constants).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """The AlexNet LPIPS graph: `convs` (five `nn.Conv2d`), `lins` (the five
    heads' per-channel weights) and the scaling layer's `shift` / `scale`."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, k, stride, pad in _ALEX_CONVS:
            convs.append(nn.Conv2d(cin, cout, k, stride=stride, padding=pad))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c, *_ in _ALEX_CONVS])
        self.register_buffer("shift", torch.from_numpy(_SHIFT.copy()))
        self.register_buffer("scale", torch.from_numpy(_SCALE.copy()))

    def features(self, x):
        """x: NCHW in [-1, 1] -> the five taps, NCHW."""
        x = (x - self.shift.view(1, -1, 1, 1)) / self.scale.view(1, -1, 1, 1)
        feats = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    def forward(self, x, y):
        """x, y: NCHW in [-1, 1] -> the distance of each pair, (B,)."""
        total = 0.0
        for f1, f2, lin in zip(self.features(x), self.features(y), self.lins):
            n1 = f1 / torch.sqrt((f1**2).sum(1, keepdim=True) + 1e-10)
            n2 = f2 / torch.sqrt((f2**2).sum(1, keepdim=True) + 1e-10)
            d = (n1 - n2) ** 2
            total = total + (d * lin.view(1, -1, 1, 1)).sum(1).mean(dim=(1, 2))
        return total


def init_lpips_params(generator: torch.Generator) -> LPIPS:
    """Weights of the right shapes (tests, or no weights at hand): the
    distributions of the JAX package's init (conv weights N(0, 0.05^2), zero
    biases, heads |N(0, 0.1^2)|), drawn from `generator`."""
    net = LPIPS()
    draw = lambda *shape: torch.randn(shape, generator=generator)  # noqa: E731
    with torch.no_grad():
        for conv, lin in zip(net.convs, net.lins):
            conv.weight.copy_(draw(*conv.weight.shape) * 0.05)
            conv.bias.zero_()
            lin.copy_(draw(*lin.shape).abs() * 0.1)
    return net


def load_lpips_params(path) -> LPIPS:
    """AlexNet-LPIPS weights from a torch state dict (.pth), in each layout
    the standard packages save:
      * torchvision AlexNet: ``features.{0,3,6,8,10}.weight/bias`` (with or
        without a leading ``net.``) + ``lin{i}.model.1.weight``
      * the `lpips` package's ``LPIPS(net='alex').state_dict()``:
        ``net.slice{s}.{fi}.weight`` (the slices keep torchvision's indices)
        + ``lin{i}.model.1.weight`` + ``scaling_layer.shift/scale``
      * torchmetrics' ``LearnedPerceptualImagePatchSimilarity``: the lpips
        layout with one more ``net.`` on every key
    ``scaling_layer.shift/scale``, where the file has them, take the place
    of the built-in constants (the released weights hold the same values)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if any(k.startswith("net.net.slice") or k.startswith("net.lin0.") for k in sd):
        sd = {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")}
    net = LPIPS()
    with torch.no_grad():
        for i, fi in enumerate(_FEATURE_INDEX):
            w = b = None
            for key in (f"net.features.{fi}.weight", f"features.{fi}.weight",
                        f"net.slice{i + 1}.{fi}.weight"):
                if key in sd:
                    w, b = sd[key], sd[key.replace("weight", "bias")]
            if w is None:
                raise KeyError(f"AlexNet conv {fi} not found in {path}")
            net.convs[i].weight.copy_(w)
            net.convs[i].bias.copy_(b)
            lw = None
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if key in sd:
                    lw = sd[key].reshape(-1)
            if lw is None:
                raise KeyError(f"LPIPS linear head {i} not found in {path}")
            net.lins[i].copy_(lw)
        if "scaling_layer.shift" in sd:
            net.shift.copy_(sd["scaling_layer.shift"].reshape(-1))
            net.scale.copy_(sd["scaling_layer.scale"].reshape(-1))
    return net


def lpips(net: LPIPS, x, y):
    """LPIPS distance between NHWC images in [-1, 1]: (B,)."""
    return net(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
