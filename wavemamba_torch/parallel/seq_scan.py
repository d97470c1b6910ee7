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

Forward only: the gathers are not differentiated, so a call that would need
a gradient raises. The JAX package uses the route for frames beyond one
chip's memory, and no shipped option trains with it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wavemamba_torch.ops.scan import selective_scan_chunked
from wavemamba_torch.parallel.mesh import axis_rank, axis_size, gather_rows


def selective_scan_seq_sharded(u, delta, A, Bs, Cs, D_skip, delta_bias, mesh, axis="data",
                               chunk=256, scan_dtype=torch.float32):
    """The selective scan with L split over `mesh[axis]`.

    u, delta: (B, K, L, D); Bs, Cs: (B, K, L, N); A: (K, D, N); D_skip,
    delta_bias: (K, D). L must divide by the axis size. Returns y (B, K, L,
    D) on every rank, in `scan_dtype` as `selective_scan_chunked` gives it."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    length = u.shape[2]
    if length % n:
        raise ValueError(f"L={length} must divide by mesh axis size {n}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, delta, A, Bs, Cs, D_skip,
                                                                   delta_bias)):
        raise NotImplementedError("the sequence-sharded scan runs the forward only: call it "
                                  "under torch.no_grad() (inference), or train with another "
                                  "scan_impl")
    seg = slice(r * (length // n), (r + 1) * (length // n))
    u_s, dlt_s, b_s, c_s = (t[:, :, seg] for t in (u, delta, Bs, Cs))
    # pass 1: the segment from zero, and its transition
    _, h_seg = selective_scan_chunked(u_s, dlt_s, A, b_s, c_s, D_skip, delta_bias, chunk=chunk,
                                      return_final=True, scan_dtype=scan_dtype)
    da_sum = F.softplus(dlt_s.float() + delta_bias[None, :, None, :]).sum(2)  # (B, K, D)
    a_seg = torch.exp(da_sum[..., None] * A[None].float())
    a_all = gather_rows(mesh, a_seg, axis)  # (n, B, K, D, N)
    h_all = gather_rows(mesh, h_seg.float(), axis)
    # exclusive prefix: h0_r = sum_{j<r} (prod_{j<k<r} a_k) h_j
    h0 = torch.zeros_like(h_all[0])
    for j in range(r):
        h0 = a_all[j] * h0 + h_all[j]
    # pass 2: the segment again from its true entry state
    y_seg = selective_scan_chunked(u_s, dlt_s, A, b_s, c_s, D_skip, delta_bias, chunk=chunk,
                                   h0=h0.to(scan_dtype), scan_dtype=scan_dtype)
    y = gather_rows(mesh, y_seg, axis)  # (n, B, K, L / n, D)
    return y.permute(1, 2, 0, 3, 4).reshape(u.shape[:3] + (y.shape[-1],))
