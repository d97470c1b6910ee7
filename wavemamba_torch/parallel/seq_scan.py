"""Sequence-sharded selective scan over a process group. The counterpart of
`wavemamba_tpu/parallel/seq_scan.py`.

The recurrence h_t = a_t h_{t-1} + b_t composes over segments, so the token
axis L can be split over ranks, in the JAX package's two passes:

  pass 1  every rank scans its segment of L from h0 = 0
          (`ops/scan.py:selective_scan_chunked`), giving its exit state
          h_seg and its decay a_seg = exp((sum_t da_t) * A), each
          (B, K, D, N), whatever L is.
  gather  (a_seg, h_seg) of every rank, in rank order.
  prefix  each rank combines the segments before its own into its entry
          state, in the fixed order j = 0 ... n-1.
  pass 2  every rank scans its segment again from that state.

Every rank holds the whole inputs and returns the whole y (the segments
gathered), as the rest of the model consumes it. The gathers run through
`parallel/mesh.py`, so NCCL and gloo take them alike.

The backward (`_SeqShardedScan`, where an input requires grad) recomputes
both passes of this rank's segment and transposes the three gathers. It
takes dy to be the same on every rank, as it is when every rank runs the
model above the scan on the same rows (the trainer's rule for this scan,
`train/trainer.py`):

  output gather   this rank's y_seg gets its own rows of dy: no collective
                  (summing dy over the ranks would give n times the gradient).
  (a, h) gathers  rank i reads row j of both for every j < i, so row j's
                  gradient is the sum over the ranks after j: a
                  reduce-scatter (`mesh.reduce_rows`), then back through
                  pass 1.
  results         u, delta, Bs and Cs have gradients on this rank's segment
                  only: gathered, so every rank holds the whole gradient;
                  A, D_skip and delta_bias summed over the ranks. Every rank
                  ends with the same gradients, which the replicated layers
                  above the scan need.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wavemamba_torch.ops.scan import selective_scan_chunked
from wavemamba_torch.parallel.mesh import (
    all_reduce_sum_,
    axis_rank,
    axis_size,
    gather_rows,
    reduce_rows,
)


def _segment(mesh, axis, length):
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    return slice(r * (length // n), (r + 1) * (length // n))


def _pass1(u_s, dlt_s, A, b_s, c_s, D_skip, delta_bias, chunk, scan_dtype):
    """The segment from zero: (its exit state in float32, its decay a_seg)."""
    _, h_seg = selective_scan_chunked(u_s, dlt_s, A, b_s, c_s, D_skip, delta_bias, chunk=chunk,
                                      return_final=True, scan_dtype=scan_dtype)
    da_sum = F.softplus(dlt_s.float() + delta_bias[None, :, None, :]).sum(2)  # (B, K, D)
    return h_seg.float(), torch.exp(da_sum[..., None] * A[None].float())


def _entry_state(a_all, h_all, r):
    """The exclusive prefix: h0_r = sum_{j<r} (prod_{j<k<r} a_k) h_j."""
    h0 = torch.zeros_like(h_all[0])
    for j in range(r):
        h0 = a_all[j] * h0 + h_all[j]
    return h0


def _whole(mesh, axis, seg_rows, shape):
    """Every rank's segment rows (B, K, L / n, C), gathered and laid end to
    end: (B, K, L, C)."""
    g = gather_rows(mesh, seg_rows, axis)  # (n, B, K, L / n, C)
    return g.permute(1, 2, 0, 3, 4).reshape(shape)


def _forward(u, delta, A, Bs, Cs, D_skip, delta_bias, mesh, axis, chunk, scan_dtype):
    r = axis_rank(mesh, axis)
    seg = _segment(mesh, axis, u.shape[2])
    u_s, dlt_s, b_s, c_s = (t[:, :, seg] for t in (u, delta, Bs, Cs))
    h_seg, a_seg = _pass1(u_s, dlt_s, A, b_s, c_s, D_skip, delta_bias, chunk, scan_dtype)
    h0 = _entry_state(gather_rows(mesh, a_seg, axis), gather_rows(mesh, h_seg, axis), r)
    y_seg = selective_scan_chunked(u_s, dlt_s, A, b_s, c_s, D_skip, delta_bias, chunk=chunk,
                                   h0=h0.to(scan_dtype), scan_dtype=scan_dtype)
    return _whole(mesh, axis, y_seg, u.shape[:3] + (y_seg.shape[-1],))


class _SeqShardedScan(torch.autograd.Function):
    """`_forward` with the backward of the module docstring."""

    @staticmethod
    def forward(ctx, mesh, axis, chunk, scan_dtype, *inputs):
        ctx.mesh, ctx.axis, ctx.chunk, ctx.scan_dtype = mesh, axis, chunk, scan_dtype
        ctx.save_for_backward(*inputs)
        return _forward(*inputs, mesh, axis, chunk, scan_dtype)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, chunk, scan_dtype = ctx.mesh, ctx.axis, ctx.chunk, ctx.scan_dtype
        u, delta, A, Bs, Cs, D_skip, delta_bias = ctx.saved_tensors
        r = axis_rank(mesh, axis)
        seg = _segment(mesh, axis, u.shape[2])
        with torch.enable_grad():
            leaves = [t.detach()[:, :, seg].requires_grad_() for t in (u, delta, Bs, Cs)]
            leaves += [t.detach().requires_grad_() for t in (A, D_skip, delta_bias)]
            u_s, dlt_s, b_s, c_s, A_, dk, bias = leaves
            args = (u_s, dlt_s, A_, b_s, c_s, dk, bias)
            h_seg, a_seg = _pass1(*args, chunk, scan_dtype)
            a_all = gather_rows(mesh, a_seg.detach(), axis).requires_grad_()
            h_all = gather_rows(mesh, h_seg.detach(), axis).requires_grad_()
            y_seg = selective_scan_chunked(*args, chunk=chunk, scan_dtype=scan_dtype,
                                           h0=_entry_state(a_all, h_all, r).to(scan_dtype))
            # pass 2, from this rank's own rows of dy (the output gather's transpose)
            g2 = torch.autograd.grad(y_seg, leaves + [a_all, h_all], dy[:, :, seg].to(y_seg.dtype),
                                     allow_unused=True)
            da_all, dh_all = (torch.zeros_like(t) if g is None else g
                              for t, g in zip((a_all, h_all), g2[-2:]))
            # the (a, h) gathers' transpose, then pass 1
            g1 = torch.autograd.grad([h_seg, a_seg], leaves,
                                     [reduce_rows(mesh, dh_all, axis), reduce_rows(mesh, da_all, axis)],
                                     allow_unused=True)
        # pass 2 reads every input; pass 1 neither Cs nor D_skip
        grads = [b if a is None else a + b for a, b in zip(g1, g2)]
        # the segments' gradients gathered (one all_gather of their float32
        # concatenation), the replicated inputs' summed over the ranks
        seg_grads, rep_grads = grads[:4], grads[4:]
        flat = _whole(mesh, axis, torch.cat([g.float() for g in seg_grads], -1),
                      u.shape[:3] + (sum(g.shape[-1] for g in seg_grads),))
        whole = [c.to(g.dtype) for c, g in zip(flat.split([g.shape[-1] for g in seg_grads], -1),
                                               seg_grads)]
        summed = all_reduce_sum_(mesh, torch.cat([g.float().reshape(-1) for g in rep_grads]), axis)
        rep = [c.view_as(g).to(g.dtype) for c, g in zip(summed.split([g.numel() for g in rep_grads]),
                                                        rep_grads)]
        du, ddelta, dBs, dCs = whole
        dA, dD, dbias = rep
        return (None,) * 4 + (du, ddelta, dA, dBs, dCs, dD, dbias)


def selective_scan_seq_sharded(u, delta, A, Bs, Cs, D_skip, delta_bias, mesh, axis="data",
                               chunk=256, scan_dtype=torch.float32):
    """The selective scan with L split over `mesh[axis]`.

    u, delta: (B, K, L, D); Bs, Cs: (B, K, L, N); A: (K, D, N); D_skip,
    delta_bias: (K, D). L must divide by the axis size. Returns y (B, K, L,
    D) on every rank, in `scan_dtype` as `selective_scan_chunked` gives it.
    Differentiable where an input requires grad (see the module docstring:
    dy must be the same on every rank); the forward is the same either way."""
    length = u.shape[2]
    if length % axis_size(mesh, axis):
        raise ValueError(f"L={length} must divide by mesh axis size {axis_size(mesh, axis)}")
    inputs = (u, delta, A, Bs, Cs, D_skip, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _SeqShardedScan.apply(mesh, axis, chunk, scan_dtype, *inputs)
    return _forward(*inputs, mesh, axis, chunk, scan_dtype)
