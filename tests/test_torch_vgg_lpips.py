"""The port's VGG19 perceptual / style loss (`wavemamba_torch/models/vgg.py`)
and AlexNet LPIPS (`wavemamba_torch/metrics/lpips.py`, the `lpips` metric)
against `wavemamba_tpu` on the CPU.

No pretrained weights are in the repository: both sides load one fabricated
state dict, seeded with numpy, in torchvision's layout (VGG19), and in each
of the three layouts the LPIPS loader reads (torchvision features, the
`lpips` package, torchmetrics), as `tests/test_vgg_lpips_oracle.py` makes
them. Tolerances: each VGG tap within 1e-5 of its largest magnitude (its
convolutions sum in another order than XLA's, so a value near 0 may differ
by more than 1e-5 of itself), the losses rtol 1e-5, LPIPS 1e-6 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavemamba_torch.metrics import build_metric
from wavemamba_torch.metrics import lpips as tlp
from wavemamba_torch.models import vgg as tvgg
from wavemamba_tpu.metrics import build_metric as jbuild_metric
from wavemamba_tpu.metrics import lpips as jlp
from wavemamba_tpu.models import vgg as jvgg

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

RTOL = 1e-5
TAPS = ["conv1_1", "relu1_2", "pool1", "conv2_2", "relu3_4", "pool3", "relu4_2", "conv5_4",
        "pool5"]
_VGG_CONVS = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def _vgg_state_dict(seed=11):
    """torchvision's `vgg19()` state dict: `features.N` convs (He-scaled, so
    deep taps stay of order 1) and a classifier that the loaders skip."""
    rs = np.random.RandomState(seed)
    sd, idx, cin = {}, 0, 3
    for v in _VGG_CONVS:
        if v == "M":
            idx += 1
            continue
        w = rs.randn(v, cin, 3, 3).astype(np.float32) * np.float32(np.sqrt(2.0 / (9 * cin)))
        sd[f"features.{idx}.weight"] = torch.from_numpy(w)
        sd[f"features.{idx}.bias"] = torch.from_numpy(rs.randn(v).astype(np.float32) * 0.01)
        idx, cin = idx + 2, v
    sd["classifier.0.weight"] = torch.zeros(4, 25088)
    return sd


@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("vgg") / "vgg19.pth"
    torch.save(_vgg_state_dict(), path)
    return jvgg.load_vgg19_params(str(path)), tvgg.load_vgg19_params(str(path))


def _images(seed, b=2, h=32, w=40):
    rs = np.random.RandomState(seed)
    return rs.rand(b, h, w, 3).astype(np.float32), rs.rand(b, h, w, 3).astype(np.float32)


def test_layer_names_match():
    assert tvgg.layer_names() == jvgg.layer_names()
    assert len(tvgg.VGG19().features) == len(tvgg.layer_names())


@pytest.mark.parametrize("norm", [(True, False), (False, False), (True, True)],
                         ids=["imagenet", "raw", "range_norm"])
def test_vgg19_taps_match(vgg_pair, norm):
    jparams, net = vgg_pair
    x, _ = _images(0)
    if norm[1]:
        x = x * 2.0 - 1.0
    want = jvgg.vgg19_features(jparams, jnp.asarray(x), TAPS, *norm)
    with torch.no_grad():
        got = tvgg.vgg19_features(net, torch.from_numpy(x), TAPS, *norm)
    assert set(got) == set(want) == set(TAPS)
    for name in TAPS:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), (name, np.abs(g - w).max())


def test_vgg19_stops_at_the_last_tap(vgg_pair):
    """Only the requested taps come back, and the trunk stops after the last
    of them (no layer past it runs)."""
    _, net = vgg_pair
    ran = []
    hooks = [m.register_forward_hook(lambda m, i, o, k=k: ran.append(k))
             for k, m in enumerate(net.features)]
    try:
        with torch.no_grad():
            got = net(torch.rand(1, 3, 16, 16), ["relu2_1", "conv1_1"])
    finally:
        for h in hooks:
            h.remove()
    assert set(got) == {"conv1_1", "relu2_1"}
    assert ran == list(range(tvgg.layer_names().index("relu2_1") + 1))


@pytest.mark.parametrize("criterion", ["l1", "l2", "mse", "fro"])
@pytest.mark.parametrize("weights", [(1.0, 0.7), (0.5, 0.0), (0.0, 2.0)],
                         ids=["both", "perceptual", "style"])
def test_perceptual_and_style_loss_match(vgg_pair, criterion, weights):
    """Every criterion, with each term's weight 0 giving None on both sides."""
    jparams, net = vgg_pair
    pred, target = _images(1)
    layer_weights = {"relu1_2": 0.5, "conv2_2": 1.0, "relu3_4": 2.0, "pool4": 0.3}
    kw = dict(criterion=criterion, perceptual_weight=weights[0], style_weight=weights[1])
    want = jvgg.perceptual_loss(jparams, jnp.asarray(pred), jnp.asarray(target), layer_weights,
                                **kw)
    got = tvgg.perceptual_loss(net, torch.from_numpy(pred), torch.from_numpy(target),
                               layer_weights, **kw)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(float(g.detach()), float(w), rtol=RTOL)


def test_perceptual_loss_trains_pred_only(vgg_pair):
    _, net = vgg_pair
    pred, target = (torch.from_numpy(a).requires_grad_(True) for a in _images(2))
    p, s = tvgg.perceptual_loss(net, pred, target, {"relu2_2": 1.0}, style_weight=1.0)
    (p + s).backward()
    assert pred.grad is not None and float(pred.grad.abs().sum()) > 0 and target.grad is None
    with pytest.raises(NotImplementedError):
        tvgg.perceptual_loss(net, pred, target, {"relu1_1": 1.0}, criterion="huber")


def test_vgg_init_shapes():
    net = tvgg.init_vgg19_params(torch.Generator().manual_seed(0))
    convs = [m for m in net.features if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 16 and convs[-1].weight.shape == (512, 512, 3, 3)
    assert all(float(c.bias.abs().sum()) == 0 for c in convs)


# --------------------------------------------------------------------- LPIPS


def _lpips_arrays(seed=3, shift=None):
    """Seeded AlexNet-LPIPS weights: five convs (OIHW), five heads, and the
    scaling layer (`shift` in place of the built-in one, where given)."""
    rs = np.random.RandomState(seed)
    convs, cin = [], 3
    for cout, k, _, _ in tlp._ALEX_CONVS:
        w = rs.randn(cout, cin, k, k).astype(np.float32) * np.float32(np.sqrt(2.0 / (k * k * cin)))
        convs.append((w, rs.randn(cout).astype(np.float32) * 0.01))
        cin = cout
    lins = [np.abs(rs.randn(c).astype(np.float32)) * 0.1 for c, *_ in tlp._ALEX_CONVS]
    shift = tlp._SHIFT if shift is None else np.asarray(shift, np.float32)
    return convs, lins, shift, tlp._SCALE


def _lpips_state_dict(layout, arrays):
    """The state dict of one of the three layouts the loaders read."""
    convs, lins, shift, scale = arrays
    t = torch.from_numpy
    sd = {}
    for i, (fi, (w, b)) in enumerate(zip(tlp._FEATURE_INDEX, convs)):
        key = {"torchvision": f"net.features.{fi}", "lpips": f"net.slice{i + 1}.{fi}",
               "torchmetrics": f"net.slice{i + 1}.{fi}"}[layout]
        sd[f"{key}.weight"], sd[f"{key}.bias"] = t(w), t(b)
    for i, lw in enumerate(lins):
        sd[f"lin{i}.model.1.weight"] = t(lw).view(1, -1, 1, 1)
    if layout != "torchvision":
        sd["scaling_layer.shift"] = t(shift).view(1, 3, 1, 1)
        sd["scaling_layer.scale"] = t(scale).view(1, 3, 1, 1)
    if layout == "torchmetrics":
        sd = {f"net.{k}": v for k, v in sd.items()}
    return sd


def _pair(seed=4, b=2, h=64, w=64):
    rs = np.random.RandomState(seed)
    x = rs.rand(b, h, w, 3).astype(np.float32) * 2 - 1
    y = np.clip(x + rs.randn(b, h, w, 3).astype(np.float32) * 0.1, -1, 1)
    return x, y


@pytest.mark.parametrize("layout", ["torchvision", "lpips", "torchmetrics"])
def test_lpips_matches_jax_in_every_layout(layout, tmp_path):
    """Both loaders read the layout; the distances agree within 1e-6 and do
    not depend on the layout."""
    path = tmp_path / f"{layout}.pth"
    torch.save(_lpips_state_dict(layout, _lpips_arrays()), path)
    x, y = _pair()
    want = np.asarray(jlp.lpips(jlp.load_lpips_params(str(path)), jnp.asarray(x), jnp.asarray(y)))
    net = tlp.load_lpips_params(str(path))
    with torch.no_grad():
        got = tlp.lpips(net, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_lpips_scaling_layer_from_the_file_wins(tmp_path):
    path = tmp_path / "shifted.pth"
    torch.save(_lpips_state_dict("lpips", _lpips_arrays(shift=[0.1, -0.2, 0.05])), path)
    x, y = _pair(5)
    want = np.asarray(jlp.lpips(jlp.load_lpips_params(str(path)), jnp.asarray(x), jnp.asarray(y)))
    net = tlp.load_lpips_params(str(path))
    assert np.allclose(net.shift.numpy(), [0.1, -0.2, 0.05])
    with torch.no_grad():
        got = tlp.lpips(net, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_lpips_loader_names_what_is_missing(tmp_path):
    sd = _lpips_state_dict("torchvision", _lpips_arrays())
    for drop, match in (("net.features.6.weight", "AlexNet conv 6"),
                        ("lin2.model.1.weight", "linear head 2")):
        bad = {k: v for k, v in sd.items() if k != drop}
        path = tmp_path / f"{drop}.pth"
        torch.save(bad, path)
        with pytest.raises(KeyError, match=match):
            tlp.load_lpips_params(str(path))


def test_lpips_metric_matches_jax(tmp_path):
    """`build_metric({'type': 'lpips', ...})` on uint8 BGR images (the
    reference's protocol: RGB in [-1, 1]) against the JAX metric; without
    `weights_path` it raises JAX's error."""
    path = tmp_path / "w.pth"
    torch.save(_lpips_state_dict("torchvision", _lpips_arrays()), path)
    rs = np.random.RandomState(6)
    a = rs.randint(0, 256, (48, 56, 3), np.uint8)
    b = np.clip(a.astype(int) + rs.randint(-20, 20, a.shape), 0, 255).astype(np.uint8)
    opt = {"type": "lpips", "weights_path": str(path)}
    got = build_metric(opt, device="cpu")(a, b)
    want = jbuild_metric(opt)(a, b)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="weights_path"):
        build_metric({"type": "lpips"}, device="cpu")


def test_lpips_init_shapes():
    net = tlp.init_lpips_params(torch.Generator().manual_seed(0))
    assert [c.weight.shape[0] for c in net.convs] == [64, 192, 384, 256, 256]
    assert all(float(lin.min()) >= 0 for lin in net.lins)
    with torch.no_grad():
        d = net(torch.rand(1, 3, 64, 64) * 2 - 1, torch.rand(1, 3, 64, 64) * 2 - 1)
    assert d.shape == (1,) and bool(torch.isfinite(d).all())
