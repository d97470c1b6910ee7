"""`band_h` sweep of the conv-chain band kernel (K7) against the stock modules
at 544x960 in bf16, on the card. The counterpart of `scripts/tpu_chain_tune.py`.

    python -m wavemamba_torch.scripts.chain_tune

Four chains with seeded weights: `dw_act` (SS2D's depthwise 3x3 + silu at
d_inner 64), `ffn_chain` (the LFSS FFN at C 32), `qkv_chain` (CMT's 1x1 +
depthwise 3x3) and `lfss_ffn_block` (LayerNorm + FFN + scaled residual). For
each it prints the stock modules' ms (the same computation as the model's
`conv_impl: xla` route, in bf16), then, for every `band_h`, the band
kernel's ms (`experimental/conv_fused.py:fused_chain_band`), its max |d|
from the stock modules (which differ from the chains by bf16 rounding
between the stages and the chains' tanh GELU) and from the chains' plain
version on the same input (`chain_route('plain')`): the max |d|, the share
of elements beyond one bf16 step plus 1e-5 of the largest value, and the
worst excess over one bf16 step, of that value. A `band_h` the kernel
refuses prints FAIL with the error. Last, `fast()` against
`fast(conv_impl='fused')` over a 1088x1920 forward on seeded weights, and
one JSON line of every reading. The kernel exists on the card only: the
script needs one and exits non-zero without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F

from wavemamba_torch.scripts.common import median_ms, print_launches

BF16_STEP = 2.0 ** -7
BAND_H = (8, 16, 32, 64)
CHAIN_SHAPE = (544, 960)
MODEL_SHAPE = (1088, 1920)


def _init(module, seed):
    from wavemamba_torch.models.wavemamba import init_wavemamba

    return init_wavemamba(module, torch.Generator().manual_seed(seed))


def chains(c=32):
    """(name, input channels, stock fn, chain fn(x, band_h)) with seeded weights on the card."""
    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.models.wavemamba import FFN, CMTAttention
    from wavemamba_torch.ops.nn import Conv2d, LayerNorm

    dw = _init(Conv2d(2 * c, 2 * c, 3, padding=1, groups=2 * c), 4).cuda().eval()
    ffn = _init(FFN(c), 3).cuda().eval()
    cmt = _init(CMTAttention(c), 0).cuda().eval()
    ln = LayerNorm(c, eps=1e-5).cuda()
    skip = torch.ones(c, device="cuda")
    return [
        ("dw_act", 2 * c, lambda x: F.silu(dw(x)), lambda x, bh: cf.dw_act(dw, x, "silu", band_h=bh)),
        ("ffn_chain", c, ffn, lambda x, bh: cf.ffn_chain(ffn, x, band_h=bh)),
        ("qkv_chain", c, lambda x: cmt.qkv_dwconv(cmt.qkv(x)),
         lambda x, bh: cf.qkv_chain(cmt, x, band_h=bh)),
        ("lfss_ffn_block", c, lambda x: x * skip.to(x.dtype).view(1, -1, 1, 1) + ffn(ln(x)),
         lambda x, bh: cf.lfss_ffn_block(ln, ffn, skip, x, band_h=bh)),
    ]


def against_plain(got, plain):
    """The band kernel's bf16 output against the plain chain's: max |d|, the
    share of elements beyond one bf16 step + 1e-5 of the largest value, and
    the worst excess over one bf16 step, of that value."""
    g, w = got.float(), plain.float()
    d = (g - w).abs()
    scale = float(w.abs().max())
    step = BF16_STEP * w.abs()
    return {"max_abs": float(d.max()), "scale": scale,
            "share_beyond_step": float((d > step + 1e-5 * scale).float().mean()),
            "excess_over_step": float((d - step).max()) / scale}


@torch.no_grad()
def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    from wavemamba_torch.device import resolve_device
    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.models import init_network
    from wavemamba_torch.models.wavemamba import WaveMambaConfig, wavemamba_apply

    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    rows = []
    for name, c, stock, chain in chains():
        x = torch.from_numpy(np.random.RandomState(c).rand(1, c, *CHAIN_SHAPE)
                             .astype(np.float32)).to(dev, torch.bfloat16)
        want = stock(x)
        stock_ms = median_ms(lambda: stock(x), dev)
        with cf.chain_route("plain"):
            plain = chain(x, 16)
        print(f"stock {name:<16}: {stock_ms:7.3f} ms", flush=True)
        row = {"chain": name, "shape": [1, c, *CHAIN_SHAPE], "stock_ms": stock_ms,
               "band": {}}
        for bh in BAND_H:
            try:
                got = chain(x, bh)
                ms = median_ms(lambda: chain(x, bh), dev)
                err = {"ms": ms, "max_abs_vs_stock": float((got.float() - want.float()).abs().max()),
                       "vs_plain": against_plain(got, plain)}
                print(f"band {name:<16} bh={bh:>3}: {ms:7.3f} ms  max|d| {err['max_abs_vs_stock']:.4f} "
                      f"(stock), {err['vs_plain']['max_abs']:.4f} (plain chain)", flush=True)
            except Exception as e:  # noqa: BLE001  a refused band_h is a reading, as in the JAX script
                err = {"fail": f"{type(e).__name__} {str(e)[:140]}"}
                print(f"band {name:<16} bh={bh:>3}: FAIL {err['fail']}", flush=True)
            row["band"][bh] = err
        rows.append(row)

    shape = (1, *MODEL_SHAPE, 3)
    xx = torch.from_numpy(np.random.RandomState(2).rand(*shape).astype(np.float32)).to(dev)
    forwards = {}
    for label, cfg in (("fast", WaveMambaConfig.fast()),
                       ("fast_fused", WaveMambaConfig.fast(conv_impl="fused"))):
        model = init_network({"type": "WaveMamba", **dataclasses.asdict(cfg)},
                             torch.Generator().manual_seed(0), device=dev, train=False)
        try:
            ms = median_ms(lambda: wavemamba_apply(model, xx), dev, reps=3, iters=5)
            forwards[label] = {"ms": ms}
            print(f"{label} {shape[1]}x{shape[2]}: {ms:.1f} ms", flush=True)
        except Exception as e:  # noqa: BLE001
            forwards[label] = {"fail": f"{type(e).__name__} {str(e)[:200]}"}
            print(f"{label} {shape[1]}x{shape[2]} FAIL: {forwards[label]['fail']}", flush=True)
        del model
    print(json.dumps({"chain_tune": rows, "forward": forwards}), flush=True)
    print_launches()
    return rows, forwards


if __name__ == "__main__":
    main()
