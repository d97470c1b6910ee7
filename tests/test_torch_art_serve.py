"""ART served through the inference CLI's path (`-opt`, `load_model`,
`enhance` with the bucket ladder) against the benchmark's plain float32
reference (`cardbench/reference/art.py`), and the fused attention of
`wavemamba_torch/models/art.py` against the formula that builds the scores,
on the CPU at small sizes.

The reference and the port share no code; both take the benchmark's seeded
weights (`cardbench/reference/init.py`). Tolerances: the float output 1e-5
absolute, as `tests/test_torch_art.py` holds the port to JAX (sums over a
few hundred terms a value, taken in another order); the fused attention
against the formula 1e-5 forward, and its gradients rtol 1e-4 (atol 1e-6),
float32 sums of up to 64 terms in another order.
"""


import cv2
import numpy as np
import pytest
import torch
import yaml

from cardbench.reference import art as ref_art
from cardbench.reference.init import make_state_dict
from wavemamba_torch import inference as tinf
from wavemamba_torch.models import art as tart
from wavemamba_torch.models.buckets import BucketLadder, pad_to_shape

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

# A 40x56 image pads to the 128x128 bucket: a 32x32 token grid. Window 6 and
# interval 12 leave pads in both attentions; window 4 and interval 8 none.
LIVE = {"type": "ART", "dim": 16, "n_blocks": 2, "num_heads": 2, "window_size": 6, "interval": 12}
ABSENT = {**LIVE, "window_size": 4, "interval": 8}


def _opt_yml(tmp_path, network_g):
    path = tmp_path / "art.yml"
    path.write_text(yaml.safe_dump({"name": "art", "network_g": network_g}))
    return str(path)


def _weights(network_g, seed=3):
    model = ref_art.from_config({"network_g": network_g}).eval()
    weights = make_state_dict(model, seed, "cpu")
    model.load_state_dict(weights, strict=True)
    return model, weights


@pytest.mark.parametrize("network_g", [LIVE, ABSENT], ids=["pads-live", "pads-absent"])
def test_port_through_the_cli_loader_matches_the_reference(tmp_path, network_g):
    """The model `-opt` builds, through `enhance` and the bucket ladder,
    against the reference on the same padded input."""
    ref, weights = _weights(network_g)
    args = tinf.parse_args(["-i", "x", "-w", "w.pth", "-opt", _opt_yml(tmp_path, network_g)])
    model = tinf.load_model(tinf.network_g_of(args), weights, torch.device("cpu"))
    assert isinstance(model, tart.ART) and model.cfg.window_size == network_g["window_size"]
    batch = (np.random.RandomState(0).rand(1, 40, 56, 3) * 0.2).astype(np.float32)
    before = tart.fused_attention.calls
    got = tinf.enhance(model, batch, BucketLadder())
    calls = tart.fused_attention.calls - before
    x = torch.from_numpy(pad_to_shape(batch, 128, 128)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref(x)[:, :, :40, :56].permute(0, 2, 3, 1).numpy()
    assert got.shape == batch.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want - batch).max() > 1e-2  # the network does something
    # pads live: four pad classes in each attention; absent: one call each
    assert calls == network_g["n_blocks"] * (8 if network_g is LIVE else 2)


def test_cli_serves_an_art_yml(tmp_path, capsys):
    """`python -m wavemamba_torch.inference -opt <ART yml> -w <.pth> -i <png>`
    writes the enhanced frame: imread, img2batch, enhance, batch2img."""
    from wavemamba_torch.utils.img_util import batch2img, img2batch

    _, weights = _weights(ABSENT, seed=5)
    pth = tmp_path / "art.pth"
    torch.save({"params": weights}, pth)
    img = np.random.RandomState(1).randint(0, 60, (36, 52, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    tinf.main(["-opt", _opt_yml(tmp_path, ABSENT), "-w", str(pth), "-i", str(tmp_path / "a.png"),
               "-o", str(tmp_path / "out"), "--device", "cpu"])
    assert "a.png:" in capsys.readouterr().out
    written = cv2.imread(str(tmp_path / "out" / "a.png"))
    model = tinf.load_model(ABSENT, weights, torch.device("cpu"))
    want = batch2img(tinf.enhance(model, img2batch(img), BucketLadder()))
    assert written.shape == img.shape and np.array_equal(written, want)


@pytest.mark.parametrize("flags", [["--fast"], ["--wf", "16"], ["--n_l_blocks", "1", "1", "1"],
                                   ["--n_h_blocks", "1", "1", "1"]])
def test_cli_refuses_opt_with_wavemamba_flags(tmp_path, flags, capsys):
    argv = ["-i", "x", "-w", "w.pth", "-opt", _opt_yml(tmp_path, ABSENT)] + flags
    with pytest.raises(SystemExit) as e:
        tinf.parse_args(argv)
    assert e.value.code != 0
    assert flags[0] in capsys.readouterr().err


def test_without_opt_the_cli_serves_wavemamba_from_its_flags():
    args = tinf.parse_args(["-i", "x", "-w", "w.pth", "--fast", "--wf", "16"])
    g = tinf.network_g_of(args)
    assert g["type"] == "WaveMamba" and g["wf"] == 16 and g["compute_dtype"] == "bfloat16"
    assert (g["n_l_blocks"], g["n_h_blocks"]) == ((1, 2, 4), (1, 1, 2))


def _pad_classes(gh, gw, groups_y, groups_x):
    """(groups, N) pad marks of a groups_y x groups_x tiling where the last
    row and the last column of groups have a pad row / column of tokens:
    four classes (none, row, column, both)."""
    marks = np.zeros((groups_y, groups_x, gh, gw), bool)
    marks[-1, :, -1, :] = True
    marks[:, -1, :, -1] = True
    return marks.reshape(groups_y * groups_x, gh * gw)


@pytest.mark.parametrize("pads", ["none", "classes"])
def test_fused_attention_matches_the_scores_formula(pads):
    """Forward and every gradient (x, qkv, proj and the bias MLP) of the
    fused attention against the formula, with no pad and with all four pad
    classes; one call for each class."""
    torch.manual_seed(0)
    attn = tart.Attention(16, 2)
    gh, gw, b = 3, 4, 2
    key_pad = _pad_classes(gh, gw, 2, 3)
    if pads == "none":
        key_pad = np.zeros_like(key_pad)
    x = torch.randn(b * key_pad.shape[0], gh * gw, 16, requires_grad=True)
    before = tart.fused_attention.calls
    got = attn(x, gh, gw, None if pads == "none" else key_pad)
    assert tart.fused_attention.calls - before == (1 if pads == "none" else 4)
    want = tart.attention_by_scores(attn, x, gh, gw, key_pad)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=0)
    g = torch.randn_like(got)
    params = [x] + list(attn.parameters())
    grads = torch.autograd.grad(got, params, g)
    wants = torch.autograd.grad(want, params, g)
    for a, w in zip(grads, wants):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4, atol=1e-6)


def test_bias_rows_are_aligned_and_cached_on_the_device():
    """The bias's rows start 16 values apart (the memory-efficient kernel's
    alignment), and the index lands on the device once for each grid."""
    attn = tart.Attention(16, 2)
    rows = attn.bias_rows(3, 5, torch.device("cpu"))
    assert rows.shape == (2, 15, 16)
    assert rows[None, :, :, :15].stride()[:3] == (2 * 15 * 16, 15 * 16, 16)
    a = tart._device_index(3, 5, torch.device("cpu"))
    assert tart._device_index(3, 5, torch.device("cpu")) is a
