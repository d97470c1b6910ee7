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

Implementations behind the `selective_scan` dispatcher:
  * ``ref``     step by step; exact, small L only. The tests' anchor.
  * ``chunked`` sequential over chunks, a log-depth scan inside each.
  * ``par``     no sequential chunk loop: subsegment transitions, a doubling
                scan over them, a replay.
  * ``pallas``  the kernel pair K3 / K4 (`ops/scan_cuda.py:selective_scan_cuda`,
                hand-written CUDA) behind `SelectiveScan`; the name is the
                JAX package's, whose option files select it.
The first three are plain torch ops on either device. `scan_dtype=bfloat16`
runs 'chunked' and 'par' on bf16 working arrays (state included; da is
computed in float32 first), as the JAX package does, and they return y in
bf16; 'ref' and 'pallas' compute in float32 whatever `scan_dtype` says, as
there (K3 / K4 take bf16 inputs and widen them).

`selective_scan_plain` / `selective_scan_plain_bwd` are the plain versions of
kernels K3 / K4, and `ss2d_scan_pair_plain` / `ss2d_scan_pair_plain_bwd` of
K1 / K2 (`ops/scan_cuda.py`): they run on CPU tensors and are the kernels'
oracles on the card. All four work in float32, or in float64 when every input
is float64 (for `gradcheck`). K1's and K2's take a bf16 token stream (and
dy) too, widened on entry: K1's writes y in `out_dtype`, rounded once from
float32; K2's dx in x's dtype, each member's rounded and the two added in
it, as the TPU kernel does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(t):
    """float32 unless `t` is float64 already."""
    return t if t.dtype == torch.float64 else t.float()


def selective_scan_ref(u, delta, A, Bs, Cs, D_skip, delta_bias):
    """Step-by-step reference. Small L only."""
    u = _f32(u)
    da = F.softplus(_f32(delta) + delta_bias[None, :, None, :])
    b, k, length, d = u.shape
    h = u.new_zeros(b, k, d, A.shape[-1])
    ys = []
    for t in range(length):
        a = torch.exp(da[:, :, t, :, None] * A[None])
        h = a * h + (da[:, :, t] * u[:, :, t])[..., None] * Bs[:, :, t, None, :]
        ys.append(torch.einsum("bkdn,bkn->bkd", h, Cs[:, :, t]))
    return torch.stack(ys, 2) + D_skip[None, :, None, :] * u


def _linscan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t along axis 2, h_{-1} = h0; every h_t.

    a, b: (B, K, T, ., .); h0: (B, K, ., .). A log-depth (Hillis-Steele) scan
    of the transitions."""
    t = a.shape[2]
    s = 1
    while s < t:
        b = torch.cat([b[:, :, :s], a[:, :, s:] * b[:, :, :-s] + b[:, :, s:]], 2)
        a = torch.cat([a[:, :, :s], a[:, :, s:] * a[:, :, :-s]], 2)
        s *= 2
    return a * h0[:, :, None] + b


def _working(scan_dtype, *ts):
    """The tensors in bf16 for `scan_dtype=torch.bfloat16`, else as they are."""
    return ts if scan_dtype != torch.bfloat16 else tuple(t.to(scan_dtype) for t in ts)


def selective_scan_chunked(u, delta, A, Bs, Cs, D_skip, delta_bias, chunk=64,
                           h0=None, return_final=False, scan_dtype=torch.float32):
    """Sequential over chunks of `chunk` tokens; inside a chunk, `_linscan`,
    vectorised over (B, K, T, D, N).

    h0: optional entry state (B, K, D, N), for a scan that continues another.
    With `return_final` also the exit state (B, K, D, N). The last chunk may
    be short: that equals padding it with identity transitions. With
    `scan_dtype=torch.bfloat16` every working array is bf16 and so is y."""
    u = _f32(u)
    da = F.softplus(_f32(delta) + delta_bias[None, :, None, :])
    u, da, A, Bs, Cs, D_skip = _working(scan_dtype, u, da, A, Bs, Cs, D_skip)
    dau = da * u
    b, k, length, d = u.shape
    h = u.new_zeros(b, k, d, A.shape[-1]) if h0 is None else h0.to(u.dtype)
    ys = []
    for l0 in range(0, length, chunk):
        sl = slice(l0, l0 + chunk)
        a = torch.exp(da[:, :, sl, :, None] * A[None, :, None])  # (B, K, T, D, N)
        hs = _linscan(a, dau[:, :, sl, :, None] * Bs[:, :, sl, None, :], h)
        ys.append(torch.einsum("bktdn,bktn->bktd", hs, Cs[:, :, sl]))
        h = hs[:, :, -1]
    y = torch.cat(ys, 2) + D_skip[None, :, None, :] * u
    return (y, h) if return_final else y


def selective_scan_par(u, delta, A, Bs, Cs, D_skip, delta_bias, sub=16,
                       scan_dtype=torch.float32):
    """No sequential chunk loop. The sequence is cut into R = ceil(L / sub)
    subsegments: `sub` steps vectorised over (B, K, R, N, D) give every
    subsegment's transition, a doubling scan over R the entering states, and
    `sub` more steps replay them and emit y. L is padded to whole subsegments
    with identity transitions (da = 0, u = 0). With
    `scan_dtype=torch.bfloat16` every working array is bf16 and so is y."""
    u = _f32(u)
    da = F.softplus(_f32(delta) + delta_bias[None, :, None, :])
    u, da, A, Bs, Cs, D_skip = _working(scan_dtype, u, da, A, Bs, Cs, D_skip)
    b, k, length, d = u.shape
    n = A.shape[-1]
    pad = (-length) % sub
    if pad:
        u, da, Bs, Cs = (F.pad(t, (0, 0, 0, pad)) for t in (u, da, Bs, Cs))
    r = (length + pad) // sub
    u5, da5 = u.view(b, k, r, sub, d), da.view(b, k, r, sub, d)
    b5, c5 = Bs.reshape(b, k, r, sub, n), Cs.reshape(b, k, r, sub, n)
    At = A.transpose(1, 2)[None, :, None]  # (1, K, 1, N, D)

    def step_ab(i):
        dai = da5[:, :, :, i, None, :]  # (B, K, R, 1, D)
        return torch.exp(dai * At), (dai * u5[:, :, :, i, None, :]) * b5[:, :, :, i, :, None]

    pa, pb = step_ab(0)
    for i in range(1, sub):
        ai, bi = step_ab(i)
        pa, pb = pa * ai, ai * pb + bi
    # Inclusive doubling scan over R; h_0 = 0, so only the b part matters.
    s = 1
    while s < r:
        pb = torch.cat([pb[:, :, :s], pb[:, :, s:] + pa[:, :, s:] * pb[:, :, :-s]], 2)
        pa = torch.cat([pa[:, :, :s], pa[:, :, s:] * pa[:, :, :-s]], 2)
        s *= 2
    h = torch.cat([torch.zeros_like(pb[:, :, :1]), pb[:, :, :-1]], 2)
    ys = []
    for i in range(sub):
        ai, bi = step_ab(i)
        h = ai * h + bi
        ys.append(torch.einsum("bkrnd,bkrn->bkrd", h, c5[:, :, :, i])
                  + D_skip[None, :, None, :] * u5[:, :, :, i])
    return torch.stack(ys, 3).reshape(b, k, r * sub, d)[:, :, :length]


def _padded_streams(u, delta, delta_bias, Bs, Cs, chunk):
    """The streams zero-padded to whole chunks, as kernels K3 / K4 see a
    ragged last chunk: u, z = delta + bias, da = softplus(z) (0 on the padding,
    so a padded token passes the state through), the validity mask, Bs, Cs."""
    u = _f32(u)
    length = u.shape[2]
    pad = (-length) % chunk
    z = _f32(delta) + delta_bias[None, :, None, :]
    if pad:
        u, z, Bs, Cs = (F.pad(t, (0, 0, 0, pad)) for t in (u, z, _f32(Bs), _f32(Cs)))
    valid = (torch.arange(length + pad, device=u.device) < length).to(u.dtype)[None, None, :, None]
    return u, z, F.softplus(z) * valid, valid, Bs, Cs


def selective_scan_plain(u, delta, A, Bs, Cs, D_skip, delta_bias, chunk=64,
                         return_carries=False):
    """The selective scan on the chunking of kernel K3 (its plain version).

    Layouts as the module docstring. With `return_carries`, also what the
    backward needs: `state` (B, K, nc, N, D), the state entering each chunk of
    `chunk` tokens, and `sumda` (B, K, nc, D), each chunk's sum of da (its
    decay is exp(A * sumda)).
    """
    length = u.shape[2]
    u, _, da, _, Bs, Cs = _padded_streams(u, delta, delta_bias, Bs, Cs, chunk)
    dau = da * u
    At = A.transpose(1, 2)  # (K, N, D): the kernels' state layout
    h = u.new_zeros(u.shape[0], u.shape[1], At.shape[1], u.shape[-1])
    ys, states = [], []
    for l0 in range(0, u.shape[2], chunk):
        sl = slice(l0, l0 + chunk)
        a = torch.exp(da[:, :, sl, None, :] * At[None, :, None])  # (B, K, T, N, D)
        hs = _linscan(a, dau[:, :, sl, None, :] * Bs[:, :, sl, :, None], h)
        ys.append(torch.einsum("bktnd,bktn->bktd", hs, Cs[:, :, sl]))
        states.append(h)
        h = hs[:, :, -1]
    y = (torch.cat(ys, 2) + D_skip[None, :, None, :] * u)[:, :, :length]
    if not return_carries:
        return y
    sumda = da.view(da.shape[0], da.shape[1], -1, chunk, da.shape[-1]).sum(3)
    return y, torch.stack(states, 2), sumda


def selective_scan_plain_bwd(u, delta, A, Bs, Cs, D_skip, delta_bias, state, dy, chunk=64):
    """Backward of `selective_scan_plain` (the plain version of K4), written
    out by hand in the kernel's arithmetic, not `torch.autograd`.

    `state`: the forward's chunk-entry states at the same `chunk`; dy:
    (B, K, L, D). Per chunk, from the last to the first: recompute h from the
    entering state, run the adjoint g_t = a_{t+1} g_{t+1} + C_t dy_t in
    reverse (it crosses a chunk boundary multiplied by the later chunk's first
    a), then
        common = g_t a_t h_{t-1},  gB = sum_n g_t B_t
        du = da gB + D_skip dy,  ddelta = (sum_n common A + gB u) sigmoid(z)
        dB_t = sum_d g_t da_t u_t,  dC_t = sum_d dy_t h_t
        dA = sum common da,  dD_skip = sum dy u,  ddelta_bias = sum ddelta.
    Returns (du, ddelta, dA, dBs, dCs, dD_skip, ddelta_bias) in the inputs'
    layouts; ddelta is the gradient before the softplus.
    """
    length = u.shape[2]
    u, z, da, valid, Bs, Cs = _padded_streams(u, delta, delta_bias, Bs, Cs, chunk)
    dyp = F.pad(_f32(dy), (0, 0, 0, u.shape[2] - length))
    sig = torch.sigmoid(z) * valid
    dau = da * u
    At = A.transpose(1, 2)  # (K, N, D)
    g_carry = torch.zeros_like(state[:, :, 0], dtype=u.dtype)
    dA = torch.zeros_like(At, dtype=u.dtype)
    dD, dbias = torch.zeros_like(D_skip, dtype=u.dtype), torch.zeros_like(D_skip, dtype=u.dtype)
    dus, ddeltas, dBs, dCs = [], [], [], []
    for p in reversed(range(u.shape[2] // chunk)):
        sl = slice(p * chunk, (p + 1) * chunk)
        uc, dac, dyc, Bc = u[:, :, sl], da[:, :, sl], dyp[:, :, sl], Bs[:, :, sl, :, None]
        a = torch.exp(dac[:, :, :, None, :] * At[None, :, None])  # (B, K, T, N, D)
        h = _linscan(a, dau[:, :, sl, None, :] * Bc, state[:, :, p])
        a_next = torch.cat([a[:, :, 1:], torch.ones_like(a[:, :, :1])], 2)
        q = Cs[:, :, sl, :, None] * dyc[:, :, :, None, :]
        g = _linscan(a_next.flip(2), q.flip(2), g_carry).flip(2)
        g_carry = a[:, :, 0] * g[:, :, 0]

        gdau = g * dau[:, :, sl, None, :]
        common = g * h - gdau * Bc  # g * a_t * h_{t-1}
        gB = (g * Bc).sum(3)
        ddelta = ((common * At[None, :, None]).sum(3) + gB * uc) * sig[:, :, sl]
        dus.append(dac * gB + D_skip[None, :, None, :] * dyc)
        ddeltas.append(ddelta)
        dBs.append(gdau.sum(4))
        dCs.append((dyc[:, :, :, None, :] * h).sum(4))
        dA += (common * dac[:, :, :, None, :]).sum((0, 2))
        dD += (dyc * uc).sum((0, 2))
        dbias += ddelta.sum((0, 2))
    du, ddelta, dB, dC = (torch.cat(t[::-1], 2)[:, :, :length] for t in (dus, ddeltas, dBs, dCs))
    return du, ddelta, dA.transpose(1, 2), dB, dC, dD, dbias


def selective_scan(u, delta, A, Bs, Cs, D_skip, delta_bias, impl="chunked",
                   chunk=256, sub=16, scan_dtype=torch.float32):
    """Dispatch to an implementation; layouts as the module docstring.
    `chunk` serves 'chunked' and `sub` serves 'par'; 'pallas' (kernels K3 / K4)
    has its own chunk, `scan_cuda.CHUNK`. `scan_dtype` (torch.float32 or
    torch.bfloat16) serves 'chunked' and 'par'. Differentiable on every
    route."""
    if scan_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scan_dtype={scan_dtype}: float32 or bfloat16")
    args = (u, delta, A, Bs, Cs, D_skip, delta_bias)
    if impl == "ref":
        return selective_scan_ref(*args)
    if impl == "chunked":
        return selective_scan_chunked(*args, chunk=chunk, scan_dtype=scan_dtype)
    if impl == "par":
        return selective_scan_par(*args, sub=sub, scan_dtype=scan_dtype)
    if impl == "pallas":
        from wavemamba_torch.ops.scan_cuda import selective_scan_cuda

        return selective_scan_cuda(*args)
    raise ValueError(f"unknown selective_scan impl: {impl!r}")


def _flip1(t, axis):
    """Member 1 of a pair reversed along `axis`, member 0 as it is."""
    return torch.stack([t[:, 0], t[:, 1].flip(axis - 1)], 1)


def _pair_streams(x, wx, dtw, bias, chunk):
    """Both members' streams in their own processing order, zero-padded to
    whole chunks: u, z (before the softplus), da (0 on the padding, so a
    padded token passes the state through), x_dbl, all (B, 2, Lp, .).

    Member 1 runs over the reversed stream, so its padding comes first and
    its processing chunk p is the stream's chunk nc-1-p: the chunking of the
    kernels."""
    r = dtw.shape[1]
    x = _f32(x)
    length = x.shape[1]
    xp = F.pad(x, (0, 0, 0, (-length) % chunk))
    xd = torch.einsum("bld,kdc->bklc", xp, wx)
    z = torch.einsum("bklr,krd->bkld", xd[..., :r], dtw) + bias[None, :, None, :]
    valid = (torch.arange(xp.shape[1], device=x.device) < length).to(x.dtype)
    da = F.softplus(z) * valid[None, None, :, None]
    u = torch.stack([xp, xp], 1)
    return tuple(_flip1(t, 2) for t in (u, z, da, xd))


def ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, chunk=64, return_carries=False,
                         variant="twopass", sub=8, out_dtype=None):
    """Projection + scan of one SS2D direction pair (the plain version of K1,
    and with variant='ssd' of K5).

    x: (B, L, D) token stream; wx: (2, D, R+2N) projection weights of
    [forward, reverse]; dtw: (2, R, D); bias, dsk: (2, D); A: (2, N, D),
    negative. Member 0 scans forward, member 1 in reverse; both outputs come
    back in token order: y (B, 2, L, D), float32 or `out_dtype` (rounded once
    from float32). x may be bf16: it is widened on entry.

    With `return_carries`, also what the backward needs: `state`
    (B, 2, nc, N, D), the state entering each chunk of `chunk` tokens, indexed
    by the chunk's place in the stream for both members (member 1 enters chunk
    c after chunks nc-1 .. c+1), and `sumda` (B, 2, nc, D), each chunk's sum of
    da (its decay is exp(A * sumda)).

    variant='ssd' evaluates the same recurrence in segments of `sub` tokens by
    K5's factorization (`_scan_pair_ssd`); 'twopass' is K1's step by step.
    """
    if variant == "ssd":
        out = _scan_pair_ssd(x, wx, dtw, bias, A, dsk, chunk, sub, return_carries)
    elif variant == "twopass":
        out = _scan_pair_twopass(x, wx, dtw, bias, A, dsk, chunk, return_carries)
    else:
        raise ValueError(f"unknown variant {variant!r}; known: 'twopass', 'ssd'")
    if out_dtype is None:
        return out
    return (out[0].to(out_dtype),) + out[1:] if return_carries else out.to(out_dtype)


def _scan_pair_twopass(x, wx, dtw, bias, A, dsk, chunk, return_carries):
    """`ss2d_scan_pair_plain(..., variant='twopass')`: K1's recurrence, chunk
    by chunk, float32."""
    r, n = dtw.shape[1], A.shape[1]
    length = x.shape[1]
    u, _, da, xd = _pair_streams(x, wx, dtw, bias, chunk)
    dau = da * u
    Bs, Cs = xd[..., r:r + n], xd[..., r + n:]
    h = u.new_zeros(u.shape[0], 2, n, u.shape[-1])
    ys, states = [], []
    for l0 in range(0, u.shape[2], chunk):
        sl = slice(l0, l0 + chunk)
        a = torch.exp(da[:, :, sl, None, :] * A[None, :, None])  # (B, 2, T, N, D)
        hs = _linscan(a, dau[:, :, sl, None, :] * Bs[:, :, sl, :, None], h)
        ys.append(torch.einsum("bktnd,bktn->bktd", hs, Cs[:, :, sl]))
        states.append(h)
        h = hs[:, :, -1]
    y = _flip1(torch.cat(ys, 2) + dsk[None, :, None, :] * u, 2)[:, :, :length]
    if not return_carries:
        return y
    sumda = da.view(da.shape[0], 2, -1, chunk, da.shape[-1]).sum(3)
    return y, _flip1(torch.stack(states, 2), 2).contiguous(), _flip1(sumda, 2).contiguous()


def _scan_pair_ssd(x, wx, dtw, bias, A, dsk, chunk, sub, return_carries):
    """`ss2d_scan_pair_plain(..., variant='ssd')`: K5's segment-local form.

    Per chunk of `chunk` tokens in processing order, per segment of `sub`:
    clocal the inclusive cumsum of da, G = exp(clocal * A), bhat = da*u*B / G,
    cums the inclusive cumsum of bhat, h_t = G_t * (H + cums_t) with H the
    state entering the segment; a segment acts on H as H -> G_last * H +
    G_last * cums_last, and `_linscan` chains the segments of a chunk.
    Segments start at a chunk's first processed token, as in the kernel: the
    padding of member 1's first chunk (which `_pair_streams` puts before its
    tokens) is moved behind them, where, as identity steps, it changes nothing.
    """
    if chunk % sub:
        raise ValueError(f"sub={sub} must divide chunk={chunk}")
    r, n = dtw.shape[1], A.shape[1]
    length = x.shape[1]
    pad = (-length) % chunk
    u, _, da, xd = _pair_streams(x, wx, dtw, bias, chunk)
    if pad:  # member 1: [pad | tc tokens] -> [tc tokens | pad] in its first chunk
        head = lambda t: torch.cat([t[:, 1:, pad:chunk], t[:, 1:, :pad], t[:, 1:, chunk:]], 2)
        u, da, xd = (torch.cat([t[:, :1], head(t)], 1) for t in (u, da, xd))
    b_, _, lp, d = u.shape
    seg = lambda t: t.reshape(b_, 2, lp // sub, sub, *t.shape[3:])  # (B, 2, nseg, sub, ...)
    w = seg(da * u)
    Bs, Cs = seg(xd[..., r:r + n]), seg(xd[..., r + n:])
    clocal = torch.cumsum(seg(da), 3)
    per = chunk // sub  # segments per chunk
    H = u.new_zeros(b_, 2, n, d)
    ys, states = [], []
    for g0 in range(0, lp // sub, per):
        sl = slice(g0, g0 + per)
        G = torch.exp(clocal[:, :, sl, :, None, :] * A[None, :, None, None])  # (B, 2, per, sub, N, D)
        cums = torch.cumsum(w[:, :, sl, :, None, :] * Bs[:, :, sl, :, :, None] / G, 3)
        states.append(H)
        g_last = G[:, :, :, -1]
        exits = _linscan(g_last, g_last * cums[:, :, :, -1], H)  # (B, 2, per, N, D)
        enter = torch.cat([H[:, :, None], exits[:, :, :-1]], 2)
        hs = G * (enter[:, :, :, None] + cums)  # (B, 2, per, sub, N, D)
        ys.append(torch.einsum("bkjtnd,bkjtn->bkjtd", hs, Cs[:, :, sl]))
        H = exits[:, :, -1]
    y = torch.cat(ys, 2).reshape(b_, 2, lp, d) + dsk[None, :, None, :] * u
    if pad:  # undo the move of member 1's padding, then as K1's plain version
        y = torch.cat([y[:, :1], torch.cat([y[:, 1:, chunk - pad:chunk], y[:, 1:, :chunk - pad],
                                            y[:, 1:, chunk:]], 2)], 1)
    y = _flip1(y, 2)[:, :, :length]
    if not return_carries:
        return y
    sumda = da.view(b_, 2, -1, chunk, d).sum(3)
    return y, _flip1(torch.stack(states, 2), 2).contiguous(), _flip1(sumda, 2).contiguous()


def ss2d_scan_pair_plain_bwd(x, wx, dtw, bias, A, dsk, state, dy, chunk=64):
    """Backward of `ss2d_scan_pair_plain` (the plain version of K2), written
    out by hand in the kernel's arithmetic, not `torch.autograd`.

    `state` is the forward's chunk-entry states at the same `chunk`; dy:
    (B, 2, L, D). Per chunk, from the last processed to the first: recompute
    h from the entering state, run the adjoint g_t = a_{t+1} g_{t+1} + C_t dy_t
    in reverse, then the gradients of da, z, u, B and C, the projection
    backward, and the sums for the weights. Returns (dx, dwx, ddtw, dbias, dA,
    ddsk): dx (B, L, D) in x's dtype, each member's dx rounded to it and the
    two added in it, as the TPU kernel does (a bf16 add rounds the float32
    sum once more); the others float32 in the layouts of wx, dtw, bias, A and
    dsk. x and dy may be bf16: they are widened on entry.
    """
    r, n = dtw.shape[1], A.shape[1]
    length = x.shape[1]
    u, z, da, xd = _pair_streams(x, wx, dtw, bias, chunk)
    dyp = _flip1(F.pad(_f32(dy), (0, 0, 0, u.shape[2] - length)), 2)
    h_in = _flip1(state, 2)  # processing order
    sig = torch.sigmoid(z)
    dau = da * u
    Bs, Cs = xd[..., r:r + n], xd[..., r + n:]
    g_carry = u.new_zeros(u.shape[0], 2, n, u.shape[-1])
    dwx, ddtw = torch.zeros_like(wx, dtype=u.dtype), torch.zeros_like(dtw, dtype=u.dtype)
    dbias, ddsk = torch.zeros_like(bias, dtype=u.dtype), torch.zeros_like(dsk, dtype=u.dtype)
    dA = torch.zeros_like(A, dtype=u.dtype)
    dxs = []
    for p in reversed(range(u.shape[2] // chunk)):
        sl = slice(p * chunk, (p + 1) * chunk)
        uc, dac, dyc, Bc = u[:, :, sl], da[:, :, sl], dyp[:, :, sl], Bs[:, :, sl, :, None]
        a = torch.exp(dac[:, :, :, None, :] * A[None, :, None])  # (B, 2, T, N, D)
        h = _linscan(a, dau[:, :, sl, None, :] * Bc, h_in[:, :, p])
        # The carry from the chunk processed after this one arrives already
        # multiplied by that chunk's first a.
        a_next = torch.cat([a[:, :, 1:], torch.ones_like(a[:, :, :1])], 2)
        q = Cs[:, :, sl, :, None] * dyc[:, :, :, None, :]
        g = _linscan(a_next.flip(2), q.flip(2), g_carry).flip(2)
        g_carry = a[:, :, 0] * g[:, :, 0]

        gdau = g * dau[:, :, sl, None, :]
        common = g * h - gdau * Bc  # g * a_t * h_{t-1}
        gB = (g * Bc).sum(3)
        dda = (common * A[None, :, None]).sum(3) + gB * uc
        ddr = dda * sig[:, :, sl]  # gradient of z
        du = dac * gB + dsk[None, :, None, :] * dyc
        dxr = torch.einsum("bktd,krd->bktr", ddr, dtw)
        dxd = torch.cat([dxr, gdau.sum(4), (dyc[:, :, :, None, :] * h).sum(4)], -1)
        dxs.append(torch.einsum("bktj,kdj->bktd", dxd, wx) + du)
        dwx += torch.einsum("bktd,bktj->kdj", uc, dxd)
        ddtw += torch.einsum("bktr,bktd->krd", xd[:, :, sl, :r], ddr)
        dbias += ddr.sum((0, 2))
        dA += (common * dac[:, :, :, None, :]).sum((0, 2))
        ddsk += (dyc * uc).sum((0, 2))
    dxp = _flip1(torch.cat(dxs[::-1], 2), 2)
    dx = (dxp[:, 0].to(x.dtype) + dxp[:, 1].to(x.dtype))[:, :length]
    return dx, dwx, ddtw, dbias, dA, ddsk
