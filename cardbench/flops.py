"""Model FLOPs of a WaveMamba forward, and the shapes of its scan calls,
worked out from a configuration's `network_g` and the input's shape alone,
not from any implementation.

A multiply-add counts two FLOPs, as `torch.utils.flop_counter` counts them;
biases, norms, activations and other elementwise work are not counted.
`forward_flops` splits the count three ways: 'conv' (every convolution),
'matmul' (linear layers, SS2D's projections, channel matching and the
channel attention, which a library counter sees as mm or bmm depending on
how they are evaluated), and 'scan' (the
selective scan's recurrence, which no library counter sees: per token,
direction, channel and state 6, da*A, the multiply-add of h, du*B and the
multiply-add of C.h; per token, direction and channel 3, du and the skip's
multiply-add).
"""

from __future__ import annotations

import math


def _dims(g: dict):
    c = g["wf"]
    d = int(g["ffn_scale"] * c)
    return c, d, g["d_state"], math.ceil(c / 16), g.get("d_conv", 3)


def level_tokens(h: int, w: int, level: int) -> int:
    """Tokens of the feature map at wavelet level `level` (1, 2, 3) of an
    h x w input."""
    return (h >> level) * (w >> level)


def scan_calls(g: dict, batch: int, h: int, w: int):
    """[(B, L, D, N, R)] of one forward's fused scan calls (K1): each LFSS
    block scans its tokens as two direction pairs (rows and columns)."""
    c, d, n, r, _ = _dims(g)
    calls = []
    for level, nl in enumerate(g["n_l_blocks"], start=1):
        calls += [(batch, level_tokens(h, w, level), d, n, r)] * (2 * 2 * nl)  # down + up
    return calls


def forward_flops(g: dict, batch: int, h: int, w: int) -> dict:
    """{'conv', 'matmul', 'scan'} FLOPs of one forward of `batch` images of
    h x w (multiples of 8)."""
    c, d, n, r, k = _dims(g)
    ic = g["in_chn"]
    f = {"conv": 0, "matmul": 0, "scan": 0}

    def conv(cin, cout, ks, groups, tokens):
        f["conv"] += 2 * batch * tokens * cout * (cin // groups) * ks * ks

    def mm(m, kk, nn):
        f["matmul"] += 2 * m * kk * nn

    full = h * w
    conv(ic, c, 3, 1, full)  # conv_01
    conv(c, ic, 3, 1, full)  # last
    for level, factor in ((1, 2), (2, 4), (3, 8)):  # ps_down: unshuffle + 1x1
        conv(ic * factor * factor, c, 1, 1, level_tokens(h, w, level))

    def lfss(t):
        mm(batch * t, c, 2 * d)  # in_proj
        conv(d, d, k, d, t)  # depthwise conv
        mm(batch * 4 * t, d, r + 2 * n)  # x_proj, four directions
        mm(batch * 4 * t, r, d)  # dt_projs
        f["scan"] += batch * 4 * t * (6 * d * n + 3 * d)
        mm(batch * t, d, c)  # out_proj
        conv(c, 2 * c, 1, 1, t)  # FFN conv1
        conv(2 * c, 2 * c, 3, 2 * c, t)  # FFN conv2, depthwise
        conv(c, c, 1, 1, t)  # FFN conv3

    def matching_transformation(t):
        mm(batch * c, t, c)  # channel distances
        conv(2 * c, 2 * c, 1, 1, t)  # PAConv k2
        conv(2 * c, 2 * c, 3, 1, t)  # k3
        conv(2 * c, c, 3, 1, t)  # k4

    def hfe(t):
        conv(c, 3 * c, 1, 1, t)  # qkv
        conv(3 * c, 3 * c, 3, 3 * c, t)  # qkv_dwconv
        matching_transformation(t)
        mm(batch * c, t, c)  # q k^T (one head)
        mm(batch * c, c, t)  # attn v
        conv(c, c, 1, 1, t)  # project_out
        conv(c, c, 1, 1, t)  # ffn project_in 1x1
        conv(c, c, 3, c, t)  # ffn project_in depthwise
        matching_transformation(t)
        conv(c, c, 3, c, t)  # ffn project_out depthwise
        conv(c, c, 1, 1, t)  # ffn project_out 1x1

    red = max(c // 8, 4)
    for level, (nl, nh) in enumerate(zip(g["n_l_blocks"], g["n_h_blocks"]), start=1):
        t = level_tokens(h, w, level)
        conv(2 * c, c, 3, 1, t)  # DownFRG l_conv
        conv(c, red, 1, 1, 1)  # SKFF conv_du on the pooled map
        for _ in range(3):
            conv(red, c, 1, 1, 1)  # SKFF fcs
        conv(c, 3 * c, 3, 1, t)  # UpFRG h_out_conv
        for _ in range(2 * nl):
            lfss(t)
        for _ in range(2 * nh):
            hfe(t)
    return f


def model_flops(g: dict, batch: int, h: int, w: int) -> int:
    """All three parts of `forward_flops`: the forward's model FLOPs."""
    return sum(forward_flops(g, batch, h, w).values())
