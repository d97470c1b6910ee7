"""Block recompute in the port (`WaveMambaConfig.remat` / `remat_policy`,
`models/wavemamba.py:_run_block`) against no recompute and against the JAX
package's `_maybe_remat`, on the CPU.

'save_scan', the default of both packages, keeps the outputs of the fused
scan's op (`scan_cuda.ss2d_scan_pair_fwd`) across the recompute; 'full'
recomputes whole blocks. Neither may change a bit of the loss or of a
gradient. The JAX side runs `remat=True` with `scan_impl='pallas_fused'`, its
Pallas kernels in interpret mode, from the same weights through
`convert.state_dict_from_jax`; the bounds are `test_torch_train.py`'s.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from wavemamba_torch import convert
from wavemamba_torch.models import WaveMambaConfig, build_network, config_from_opt
from wavemamba_torch.models import wavemamba as twm
from wavemamba_torch.ops import scan as tscan
from wavemamba_torch.ops import scan_cuda
from wavemamba_torch.train import trainer as ttrain
from wavemamba_tpu.models import wavemamba as jwm
from wavemamba_tpu.train import trainer as jtrain

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SMALL = dict(wf=16, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
N_SS2D = 2 * sum(SMALL["n_l_blocks"])  # an LFSS block, and its SS2D, in each down and up group
TCFG = dict(pixel_weight=1.0, fft_weight=0.1)


@functools.lru_cache(maxsize=None)
def _params():
    return jwm.init_wavemamba(jax.random.PRNGKey(0), jwm.WaveMambaConfig(**SMALL))


def _batch(seed=20, b=2, h=32, w=32):
    """gt uniform, lq = gt * 0.12 + noise: a seeded low-light pair, NHWC."""
    rs = np.random.RandomState(seed)
    gt = rs.rand(b, h, w, 3).astype(np.float32)
    lq = np.clip(gt * 0.12 + rs.randn(b, h, w, 3).astype(np.float32) * 0.01, 0, 1)
    return lq.astype(np.float32), gt


def _model(**net):
    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, _params()))
    return build_network({"type": "WaveMamba", **SMALL, **net}, sd, device="cpu").train()


def _loss_and_grads(monkeypatch, **net):
    """Loss and every gradient of one forward and backward of `_model(**net)`,
    with the runs of the fused scan op's implementation and the calls of
    the model's scans (fused and unfused) during it."""
    runs, calls = [0], [0]
    forward = scan_cuda._forward

    def counted_forward(*args):
        runs[0] += 1
        return forward(*args)

    def counted(scan):
        def call(*args, **kw):
            calls[0] += 1
            return scan(*args, **kw)
        return call

    monkeypatch.setattr(scan_cuda, "_forward", counted_forward)
    model = _model(**net)
    twm.set_scan(model, counted(scan_cuda.ss2d_scan_pair))
    twm.set_unfused_scan(model, counted(functools.partial(
        tscan.selective_scan, impl=model.cfg.scan_impl, chunk=model.cfg.scan_chunk,
        sub=model.cfg.scan_sub, scan_dtype=torch.float32)))
    lq, gt = map(torch.from_numpy, _batch())
    total, _ = ttrain.loss_fn(model, ttrain.TrainConfig(**TCFG), lq, gt)
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(total.detach()), grads, runs[0], calls[0]


def _assert_same_bits(a, b):
    assert a[0] == b[0]
    assert set(a[1]) == set(b[1])
    for name, g in a[1].items():
        assert torch.equal(g, b[1][name]), name


@pytest.mark.parametrize("policy", ["save_scan", "full"])
def test_recompute_gives_the_bits_of_no_recompute(monkeypatch, policy):
    """Loss and every gradient under each policy equal those without
    recompute, bit for bit."""
    plain = _loss_and_grads(monkeypatch, remat=False)
    _assert_same_bits(_loss_and_grads(monkeypatch, remat=True, remat_policy=policy), plain)


@pytest.mark.parametrize("net,runs,calls", [
    ({"remat": False}, 2 * N_SS2D, 2 * N_SS2D),
    ({"remat": True}, 2 * N_SS2D, 4 * N_SS2D),  # 'save_scan', the default
    ({"remat": True, "remat_policy": "full"}, 4 * N_SS2D, 4 * N_SS2D),
])
def test_the_scan_op_runs_once_a_step_under_save_scan(monkeypatch, net, runs, calls):
    """Each SS2D scans two direction pairs. The recompute calls the scan
    again under both policies (a `set_scan` hook sees both calls); under
    'save_scan' the op answers the second from its saved outputs, so its
    implementation (on the card, K1) runs once a pair a step, as without
    recompute, and twice under 'full'."""
    loss, grads, got_runs, got_calls = _loss_and_grads(monkeypatch, **net)
    assert (got_runs, got_calls) == (runs, calls)
    assert np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_save_scan_off_the_fused_route_recomputes_whole_blocks(monkeypatch):
    """With `scan_impl: chunked` there is no op to keep: 'save_scan'
    recomputes the whole block, scan included (two calls of the unfused scan
    a block a step, against one without recompute), as the JAX package's
    `_maybe_remat` does; the bits do not change."""
    plain = _loss_and_grads(monkeypatch, remat=False, scan_impl="chunked")
    got = _loss_and_grads(monkeypatch, remat=True, scan_impl="chunked")
    assert (plain[2:], got[2:]) == ((0, N_SS2D), (0, 2 * N_SS2D))
    _assert_same_bits(got, plain)
    blocks = _model(remat=True, scan_impl="chunked").restoration_network.down_group1
    assert (blocks.l_remat, blocks.h_remat) == ("full", "full")
    fused = _model(remat=True).restoration_network.down_group1
    assert (fused.l_remat, fused.h_remat) == ("save_scan", "full")  # HFE blocks hold no scan


def test_save_scan_replays_for_each_backward_of_a_retained_graph(monkeypatch):
    """A second backward through a retained graph recomputes each block again
    and takes the forward's scan outputs again, from the first: the same
    gradients twice over, and no further run of the op's implementation."""
    runs = [0]
    forward = scan_cuda._forward

    def counted_forward(*args):
        runs[0] += 1
        return forward(*args)

    monkeypatch.setattr(scan_cuda, "_forward", counted_forward)
    model = _model(remat=True)
    lq, gt = map(torch.from_numpy, _batch())
    total, _ = ttrain.loss_fn(model, ttrain.TrainConfig(**TCFG), lq, gt)
    total.backward(retain_graph=True)
    once = {n: p.grad.clone() for n, p in model.named_parameters()}
    total.backward()
    assert runs[0] == 2 * N_SS2D
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, 2 * once[name]), name


def test_a_recompute_that_scans_more_than_its_forward_raises():
    """The stash hands back what the forward recorded, in order; a recompute
    that asks for more is an error, not a silent launch."""
    stash = scan_cuda._ScanStash()
    out = (torch.ones(2), torch.zeros(1), torch.zeros(1))
    assert stash.take(lambda: out) is out
    stash.replaying = True
    got = stash.take(lambda: pytest.fail("a replay must not compute"))
    assert all(g is not o and torch.equal(g, o) for g, o in zip(got, out))
    with pytest.raises(RuntimeError, match="more often than the forward"):
        stash.take(lambda: out)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    cfg = jwm.WaveMambaConfig(**SMALL, remat=True, remat_policy="save_scan",
                              scan_impl="pallas_fused")
    tcfg = jtrain.TrainConfig(**TCFG)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, lq, gt: jtrain.loss_fn(p, cfg, tcfg, lq, gt), has_aux=True))(_params(), *_batch())
    return float(loss), convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def test_save_scan_matches_jax(monkeypatch):
    """The port's 'save_scan' step against the JAX package's (`remat=True`,
    `remat_policy='save_scan'`, `scan_impl='pallas_fused'`) from the same
    weights: loss rtol 1e-5, every gradient rtol 5e-4, atol 5e-5, the bounds
    of `test_torch_train.py`."""
    want_loss, want = _jax_loss_and_grads()
    loss, grads, runs, _ = _loss_and_grads(monkeypatch, remat=True, remat_policy="save_scan")
    assert runs == 2 * N_SS2D
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("where", ["config", "network_g"])
def test_an_unknown_policy_raises(where):
    """The port takes JAX's two policies and refuses any other by name."""
    with pytest.raises(ValueError, match="unknown remat_policy 'selective'"):
        if where == "config":
            WaveMambaConfig(remat_policy="selective")
        else:
            config_from_opt({"type": "WaveMamba", **SMALL, "remat_policy": "selective"})
