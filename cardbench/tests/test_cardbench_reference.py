"""The reference against the program's CPU route, and its scan against a
step-by-step loop, in float32 at small sizes."""

import dataclasses

import torch

from cardbench.reference.init import make_state_dict
from cardbench.reference.scan import selective_scan
from cardbench.reference.wavemamba import WaveMamba


def _loop(u, delta, A, Bs, Cs, Ds, bias):
    da = torch.nn.functional.softplus(delta + bias[None, :, None, :])
    h = u.new_zeros(u.shape[0], u.shape[1], u.shape[3], A.shape[-1])
    ys = []
    for t in range(u.shape[2]):
        h = torch.exp(da[:, :, t, :, None] * A[None]) * h \
            + (da[:, :, t] * u[:, :, t])[..., None] * Bs[:, :, t, None, :]
        ys.append((h * Cs[:, :, t, None, :]).sum(-1))
    return torch.stack(ys, 2) + Ds[None, :, None, :] * u


def test_scan_matches_a_step_by_step_loop():
    g = torch.Generator().manual_seed(0)
    b, k, length, d, n = 2, 4, 150, 8, 4  # 150: a ragged last chunk
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    args = (r(b, k, length, d), r(b, k, length, d) * 0.5, -torch.rand(k, d, n, generator=g) - 0.1,
            r(b, k, length, n), r(b, k, length, n), r(k, d), r(k, d) * 0.1)
    want = _loop(*(a.double() for a in args))
    got = selective_scan(*args, chunk=16)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)


def test_reference_matches_the_program_on_the_cpu():
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.wavemamba import WaveMambaConfig, wavemamba_apply

    ref = WaveMamba().eval()
    weights = make_state_dict(ref, 11, "cpu")
    ref.load_state_dict(weights, strict=True)
    prog = build_network({"type": "WaveMamba", **dataclasses.asdict(WaveMambaConfig())},
                         weights, device="cpu")
    x = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(1)) * 0.2
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = wavemamba_apply(prog, x)
    assert (got - want).abs().max() < 1e-5
    assert (want - x).abs().max() > 1e-2  # the network does something
