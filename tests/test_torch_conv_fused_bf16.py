"""The whole model with `conv_impl: fused` under the bf16 preset, the port
(plain chains and the plain scan, as CPU tensors take them) against the JAX
package (Pallas chains and scan in interpret mode), at a small size: wf=8,
blocks (1, 1, 1), 40x48. A file of its own: the JAX side's compile takes most
of a minute.

Both sides hand the chains bf16 activations, widen them to float32 inside and
round each chain's output once to bf16, as `fast()` runs the rest of the
network. They round at other places than each other (summation orders, the
plain chains' exact product sums), and a flip of a bf16 value travels through
the network, so the outputs are held as `tests/test_torch_fast.py` holds the
bf16 presets: a PSNR floor of 45 dB between the two (55.8 dB when written;
the JAX bf16 model is 55.5 dB from its float32 one) and max abs 2e-2 (6.2e-3
when written), on outputs up to 1.4.
"""

import jax
import numpy as np
import torch

from wavemamba_torch import convert
from wavemamba_torch.experimental import conv_fused as tcf
from wavemamba_torch.models import build_network
from wavemamba_torch.models import wavemamba as twm
from wavemamba_tpu.models import wavemamba as jwm

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SIZE = dict(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))
PSNR_FLOOR, MAX_ABS = 45.0, 2e-2


def test_fused_bf16_model_matches_jax(monkeypatch):
    jcfg = jwm.WaveMambaConfig.fast_tpu(conv_impl="fused", **SIZE)
    assert (jcfg.conv_impl, jcfg.compute_dtype) == ("fused", "bfloat16")
    params = jwm.init_wavemamba(jax.random.PRNGKey(0), jwm.WaveMambaConfig(**SIZE))
    x = np.random.RandomState(0).rand(1, 40, 48, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, t: jwm.wavemamba_apply(p, jcfg, t))(params, x))

    tcfg = twm.WaveMambaConfig.fast(conv_impl="fused", **SIZE)
    opt = {"type": "WaveMamba", **{k: list(v) if isinstance(v, tuple) else v
                                   for k, v in vars(tcfg).items()}}
    model = build_network(opt, convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          device="cpu")
    dtypes = []
    real = tcf.fused_chain_plain
    monkeypatch.setattr(tcf, "fused_chain_plain",
                        lambda x, s: dtypes.append(x.dtype) or real(x, s))
    got = twm.wavemamba_apply(model, torch.from_numpy(x))
    assert dtypes and set(dtypes) == {torch.bfloat16}, set(dtypes)  # every chain takes bf16
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    psnr = float(10 * np.log10(1.0 / np.mean(d.astype(np.float64) ** 2)))
    assert psnr >= PSNR_FLOOR and float(d.max()) <= MAX_ABS, (psnr, float(d.max()))
