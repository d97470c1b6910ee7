"""The probes P1-P5 (`wavemamba_torch/scripts/gpu_probe.py`) against the TPU
probes of `scripts/tpu_vpu_probe.py` on the CPU.

The TPU script runs as it is, with three things swapped in for the test: its
`pallas_call` runs in interpret mode, `GRID` is 2, and `_time_call` keeps the
kernel's output instead of timing it. The port's probes take the same inputs
(`probe_inputs`, the TPU script's generators) and a CPU tensor takes their
plain versions. Tolerances, of the output's max: P1, P3 and P4 1e-5 (another
summation or rounding order, K = 48 / 16 / 24 steps deep; measured 1.2e-6,
6e-8, 2e-7), P5 1e-6 (an 8-term prefix; measured 1.3e-7). The TPU P2
reshapes its (R, N, D2) result
into (1, T, N*D2) and raises at trace time, so P2 is held against a numpy
transcription of its kernel body without that reshape. The kernels have no
CPU mode; `chip_smoke.py` holds them against the plain versions on the card.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wavemamba_torch.scripts import gpu_probe as gp

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 2


@pytest.fixture
def tpu(monkeypatch):
    """The TPU probe script with interpret-mode kernels, GRID = 2, and a
    `_time_call` that records each kernel's output: (module, outputs)."""
    spec = importlib.util.spec_from_file_location(
        "tpu_vpu_probe", os.path.join(REPO, "scripts", "tpu_vpu_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(mod, "GRID", GRID)
    outs = []
    monkeypatch.setattr(mod, "_time_call", lambda fn, *args, iters=3: outs.append(np.asarray(fn(*args))) or 1.0)
    return mod, outs


def _port(name, grid=GRID, K=None):
    args = [torch.from_numpy(a) for a in gp.probe_inputs(name, grid)]
    kw = {} if name == "mxu_seg" else {"K": gp.K_DEFAULT[name] if K is None else K}
    return gp.WRAPPERS[name](*args, **kw).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name,tol", [("flat", 1e-5), ("exp", 1e-5), ("nsum", 1e-5), ("mxu_seg", 1e-6)])
def test_plain_matches_the_tpu_probe(tpu, name, tol):
    mod, outs = tpu
    getattr(mod, f"probe_{name}")()  # at its default K
    (want,) = outs
    before = gp.WRAPPERS[name].launches
    got = _port(name)
    assert got.shape == want.shape == (GRID, gp.T, gp.ND)
    assert _rel(got, want) <= tol, _rel(got, want)
    assert gp.WRAPPERS[name].launches == before  # a CPU tensor takes the plain version


def _shaped_numpy(x, K):
    """`probe_shaped`'s kernel body (`scripts/tpu_vpu_probe.py:96-104`) per
    block, without the reshape that fails: (G, R, N*D2)."""
    out = []
    for g in range(x.shape[0]):
        x4 = x[g].reshape(gp.R, gp.S, gp.N, gp.D2)
        pa = x4[:, 0]
        pb = x4[:, 0]
        for _ in range(K):
            for i in range(1, gp.S):
                ai = x4[:, i]
                pa = pa * ai
                pb = ai * pb + x4[:, i]
        out.append((pa + pb).reshape(gp.R, gp.N * gp.D2))
    return np.stack(out)


@pytest.mark.parametrize("K", [6, 12])
def test_shaped_plain_matches_the_tpu_kernel_body(K):
    (x,) = gp.probe_inputs("shaped", GRID)
    got = _port("shaped", K=K)
    assert got.shape == (GRID, gp.R, gp.ND)
    np.testing.assert_allclose(got, _shaped_numpy(x, K), rtol=1e-6, atol=0)


def test_the_tpu_shaped_probe_cannot_run(tpu):
    """Why P2 has no TPU output to compare with: its (R, N, D2) result does
    not reshape into (1, T, N*D2), at trace time."""
    mod, _ = tpu
    with pytest.raises(TypeError, match="reshape"):
        mod.probe_shaped()


def test_library_calls_compute_the_probes_functions():
    """P4's einsum and P5's cumsum, the `library_ms` yardsticks, compute the
    plain versions' functions (P4 before its broadcast over n)."""
    for name in ("nsum", "mxu_seg"):
        args = [torch.from_numpy(a) for a in gp.probe_inputs(name, 1)]
        K = gp.K_DEFAULT.get(name)
        lib = gp.library_call(name, args, K)().numpy()
        plain = _port(name, grid=1)
        if name == "nsum":
            plain = plain.reshape(1, gp.T, gp.N, gp.D2)[:, :, 0]
        assert lib.reshape(plain.shape).shape == plain.shape
        assert _rel(lib.reshape(plain.shape), plain) <= 1e-5
    for name in ("flat", "shaped", "exp"):
        assert gp.library_call(name, (), 1) is None


def test_bounds_and_op_counts():
    """At the TPU probes' K the card's bytes bound P1, P2, P4 and P5 and the
    SFU bounds P3; at `K_COMPUTE` each of P1-P4 is bound by its pipe, by at
    least twice the bytes' time. The op counts are the TPU script's."""
    for name in gp.NAMES:
        ms, by, unit = gp.bound(name, gp.GRID, gp.K_DEFAULT.get(name))
        assert (by, unit) == (("operations", "sfu") if name == "exp" else ("bytes", "hbm")), name
    for name, K in gp.K_COMPUTE.items():
        ms, by, unit = gp.bound(name, gp.GRID, K)
        bytes_ms = gp.bound(name, gp.GRID, 0)[0]  # no operations: the bytes' time
        assert by == "operations" and ms >= 2 * bytes_ms, (name, ms, bytes_ms)
    assert gp.ops("flat", 128, 48) == 128 * 512 * 16 * 128 * 48 * 2
    assert gp.ops("shaped", 128, 6) == 128 * 64 * 7 * 16 * 128 * 6 * 3
    assert gp.ops("mxu_seg", 128) == 128 * 512 * 16 * 128


def test_kernels_need_a_card(monkeypatch):
    """The kernels' loader raises without CUDA, a tensor on another device is
    refused, and the script exits non-zero without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gp._library.__wrapped__()
    meta = torch.empty(1, gp.T, gp.ND, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gp.probe_mxu_seg(meta)
    with pytest.raises(SystemExit):
        gp.main()
