"""The FLOP function and the scan call shapes against independent counts."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cardbench import flops
from cardbench.reference.wavemamba import WaveMamba

NETWORK = {"in_chn": 3, "wf": 32, "n_l_blocks": [1, 2, 4], "n_h_blocks": [1, 1, 2],
           "ffn_scale": 2.0, "d_state": 16, "d_conv": 3}


@pytest.mark.parametrize("h, w", [(64, 64), (256, 256)])
def test_forward_flops_match_flop_counter(h, w):
    """Convolutions and matrix products of the reference's forward, as
    torch's FLOP counter sees them, equal `forward_flops`' (the scan's
    recurrence is elementwise: no counter sees it)."""
    model = WaveMamba().eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.rand(1, 3, h, w))
    seen = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    mine = flops.forward_flops(NETWORK, 1, h, w)
    assert seen.pop("aten.convolution") == mine["conv"]
    assert sum(seen.values()) == mine["matmul"]


def test_scan_calls_match_the_program():
    """The K1 call shapes the benchmark works out are those the program's
    fused scan receives."""
    import dataclasses

    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.wavemamba import WaveMambaConfig, set_scan, wavemamba_apply
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    cfg = WaveMambaConfig()
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in WaveMamba().state_dict().items()}
    model = build_network({"type": "WaveMamba", **dataclasses.asdict(cfg)},
                          {k: torch.rand(s) * 0.1 for k, s in shapes.items()}, device="cpu")
    seen = []

    def recording(x, wx, dtw, bias, A, dsk, **kw):
        seen.append((x.shape[0], x.shape[1], x.shape[2], A.shape[1], dtw.shape[1]))
        return ss2d_scan_pair(x, wx, dtw, bias, A, dsk, **kw)

    set_scan(model, recording)
    wavemamba_apply(model, torch.rand(1, 64, 64, 3))
    assert sorted(seen) == sorted(flops.scan_calls(NETWORK, 1, 64, 64))
