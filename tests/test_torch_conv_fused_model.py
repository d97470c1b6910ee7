"""The whole model with `conv_impl: fused`, the port (plain chains, as a CPU
tensor takes them) against the JAX package (Pallas chains in interpret mode),
float32, at a small size: wf=8, blocks (1, 1, 1), 40x48. A file of its own:
the JAX side's compile takes most of a minute.

Every chain agrees with its JAX counterpart to float32 rounding on the same
input (`tests/test_torch_conv_fused.py`), but a last-bit difference upstream of
a bf16 rounding can move one operand by a bf16 step, and the SS2D scans carry
such a step across the whole image. So the outputs are held to max abs 3e-3
and mean abs 4e-4 (1.2e-3 and 1.6e-4 when written), and to a mean difference
under half that between the fused and the stock route of the same port model
(8e-4 when written): the port computes the fused route's function, not the
stock one's.
"""

import jax
import numpy as np
import torch

from wavemamba_torch import convert
from wavemamba_torch.models import build_network
from wavemamba_torch.models import wavemamba as twm
from wavemamba_tpu.models import wavemamba as jwm

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait, and the tiny tensors here gain nothing from them.
torch.set_num_threads(1)

SIZE = dict(wf=8, n_l_blocks=(1, 1, 1), n_h_blocks=(1, 1, 1))


def test_fused_model_matches_jax():
    cfg = jwm.WaveMambaConfig(conv_impl="fused", **SIZE)
    params = jwm.init_wavemamba(jax.random.PRNGKey(0), cfg)
    x = np.random.RandomState(0).rand(1, 40, 48, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, t: jwm.wavemamba_apply(p, cfg, t))(params, x))

    sd = convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    opt = {"type": "WaveMamba", **{k: list(v) if isinstance(v, tuple) else v for k, v in SIZE.items()}}
    fused = build_network({**opt, "conv_impl": "fused"}, sd, device="cpu")
    stock = build_network(opt, sd, device="cpu")
    got = twm.wavemamba_apply(fused, torch.from_numpy(x)).numpy()
    routes = np.abs(twm.wavemamba_apply(stock, torch.from_numpy(x)).numpy() - got)

    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    assert float(d.max()) <= 3e-3 and float(d.mean()) <= 4e-4, (float(d.max()), float(d.mean()))
    assert float(d.mean()) <= 0.5 * float(routes.mean()), (float(d.mean()), float(routes.mean()))
