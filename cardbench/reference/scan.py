"""The selective scan (Mamba's S6 recurrence) in plain float32 PyTorch.

With ``da_t = softplus(delta_t + delta_bias)``, for each stream k:

    h_t = exp(da_t * A) * h_{t-1} + da_t * u_t * B_t      (h: (D, N), h_0 = 0)
    y_t = C_t . h_t + Ds * u_t

Layouts: u, delta (B, K, L, D); A (K, D, N), already negative; Bs, Cs
(B, K, L, N); Ds, delta_bias (K, D). Returns y (B, K, L, D).

Evaluated in two passes over chunks of `chunk` tokens, every chunk at once:
the first runs each chunk from a zero state and keeps its last state, a
log-depth scan over the chunks turns those into the state entering each
chunk, and the second runs each chunk again from its entering state and
reads y. Every step is the recurrence as written above, so the only
departure from a step-by-step loop over L is the order in which the chunks'
contributions are summed. That keeps a 2176x3840 frame (2,088,960 tokens at
level 1) to a few hundred whole-tensor operations.

Under autograd each group of `GROUP` steps runs under
`torch.utils.checkpoint`: the backward pass recomputes a group's states
from the state entering it, so memory holds a state per group, not per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

GROUP = 8


def _chunk_states(decay, local):
    """Inclusive scan S_c = decay_c * S_{c-1} + local_c over axis 2 (S_{-1} =
    0), by doubling; returns the state entering each chunk, S_{c-1}."""
    a, b = decay, local
    step = 1
    while step < a.shape[2]:
        b = torch.cat([b[:, :, :step], a[:, :, step:] * b[:, :, :-step] + b[:, :, step:]], 2)
        a = torch.cat([a[:, :, :step], a[:, :, step:] * a[:, :, :-step]], 2)
        step *= 2
    return torch.cat([torch.zeros_like(b[:, :, :1]), b[:, :, :-1]], 2)


def selective_scan(u, delta, A, Bs, Cs, Ds, delta_bias, chunk=64):
    """y (B, K, L, D), float32; see the module docstring."""
    u, delta, Bs, Cs = (t.float() for t in (u, delta, Bs, Cs))
    b, k, length, d = u.shape
    n = A.shape[-1]
    da = F.softplus(delta + delta_bias[None, :, None, :].float())
    pad = (-length) % chunk
    if pad:  # da = 0 on the padding: exp(0) = 1 and no input, the state passes through
        u, da, Bs, Cs = (F.pad(t, (0, 0, 0, pad)) for t in (u, da, Bs, Cs))
    nc = (length + pad) // chunk
    split = lambda t: t.reshape(b, k, nc, chunk, t.shape[-1])  # noqa: E731
    u, da, Bs, Cs = split(u), split(da), split(Bs), split(Cs)
    A = A.float()[None, :, None]  # (1, K, 1, D, N)

    def steps(h, t0, emit):
        ys = []
        for t in range(t0, min(t0 + GROUP, chunk)):
            dat = da[:, :, :, t, :, None]
            h = torch.exp(dat * A) * h + (dat * u[:, :, :, t, :, None]) * Bs[:, :, :, t, None, :]
            if emit:
                ys.append((h * Cs[:, :, :, t, None, :]).sum(-1))
        return (h, torch.stack(ys, 3)) if emit else (h,)

    def run(h, emit):
        ys = []
        for t0 in range(0, chunk, GROUP):
            if torch.is_grad_enabled():
                out = checkpoint(steps, h, t0, emit, use_reentrant=False)
            else:
                out = steps(h, t0, emit)
            h = out[0]
            ys += out[1:]
        return h, ys

    zero = u.new_zeros(b, k, nc, d, n)
    local, _ = run(zero, emit=False)
    entry = _chunk_states(torch.exp(da.sum(3)[..., None] * A), local)
    del local, zero
    _, ys = run(entry, emit=True)
    y = torch.cat(ys, 3).reshape(b, k, nc * chunk, d)[:, :, :length]
    return y + Ds.float()[None, :, None, :] * u.reshape(b, k, nc * chunk, d)[:, :, :length]
