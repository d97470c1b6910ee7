"""Selective scan (Mamba S6 recurrence) in plain PyTorch.

The counterpart of `wavemamba_tpu/ops/scan.py`. With
``da_t = softplus(delta_t + delta_bias)``:

    h_t = exp(da_t * A) * h_{t-1} + da_t * B_t * u_t        (h: (D, N))
    y_t = sum_n C_t[n] * h_t[:, n] + D_skip * u_t

with h_0 = 0 and all state math in float32.

Layouts (K = number of direction streams):
    u, delta           : (B, K, L, D)
    A                  : (K, D, N)   (already negative: A = -exp(A_log))
    Bs, Cs             : (B, K, L, N)
    D_skip, delta_bias : (K, D)
    returns y          : (B, K, L, D)

`ss2d_scan_pair_plain` is the plain version of kernel K1
(`ops/scan_cuda.py:ss2d_scan_pair`): it runs on CPU tensors and is the
kernel's oracle on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def selective_scan_ref(u, delta, A, Bs, Cs, D_skip, delta_bias):
    """Step-by-step reference. Small L only."""
    u = u.float()
    da = F.softplus(delta.float() + delta_bias[None, :, None, :])
    b, k, length, d = u.shape
    h = u.new_zeros(b, k, d, A.shape[-1])
    ys = []
    for t in range(length):
        a = torch.exp(da[:, :, t, :, None] * A[None])
        h = a * h + (da[:, :, t] * u[:, :, t])[..., None] * Bs[:, :, t, None, :]
        ys.append(torch.einsum("bkdn,bkn->bkd", h, Cs[:, :, t]))
    return torch.stack(ys, 2) + D_skip[None, :, None, :] * u


def selective_scan_chunked(u, delta, A, Bs, Cs, D_skip, delta_bias, chunk=64):
    """Sequential over chunks of `chunk` tokens; inside a chunk, a log-depth
    (Hillis-Steele) scan of the per-token transitions, vectorised over
    (B, K, T, D, N)."""
    u = u.float()
    da = F.softplus(delta.float() + delta_bias[None, :, None, :])
    dau = da * u
    b, k, length, d = u.shape
    h = u.new_zeros(b, k, d, A.shape[-1])
    ys = []
    for l0 in range(0, length, chunk):
        sl = slice(l0, l0 + chunk)
        a = torch.exp(da[:, :, sl, :, None] * A[None, :, None])  # (B, K, T, D, N)
        s_b = dau[:, :, sl, :, None] * Bs[:, :, sl, None, :]
        t = a.shape[2]
        s = 1
        while s < t:
            s_b = torch.cat([s_b[:, :, :s], a[:, :, s:] * s_b[:, :, :-s] + s_b[:, :, s:]], 2)
            a = torch.cat([a[:, :, :s], a[:, :, s:] * a[:, :, :-s]], 2)
            s *= 2
        hs = a * h[:, :, None] + s_b
        ys.append(torch.einsum("bktdn,bktn->bktd", hs, Cs[:, :, sl]))
        h = hs[:, :, -1]
    return torch.cat(ys, 2) + D_skip[None, :, None, :] * u


def ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, chunk=64):
    """Projection + scan of one SS2D direction pair (the plain version of K1).

    x: (B, L, D) token stream; wx: (2, D, R+2N) projection weights of
    [forward, reverse]; dtw: (2, R, D); bias, dsk: (2, D); A: (2, N, D),
    negative. Member 0 scans forward, member 1 in reverse; both outputs come
    back in token order: y (B, 2, L, D) float32.
    """
    r = dtw.shape[1]
    n = A.shape[1]
    x = x.float()
    xd = torch.einsum("bld,kdc->bklc", x, wx)
    dts = torch.einsum("bklr,krd->bkld", xd[..., :r], dtw)

    def pair(t):  # member 1 runs over the reversed stream
        return torch.stack([t[:, 0], t[:, 1].flip(1)], 1)

    u = torch.stack([x, x.flip(1)], 1)
    y = selective_scan_chunked(u, pair(dts), A.transpose(1, 2), pair(xd[..., r:r + n]),
                               pair(xd[..., r + n:]), dsk, bias, chunk=chunk)
    return pair(y)
