"""Device mesh, batch sharding and the collectives the port runs over them.
The counterpart of `wavemamba_tpu/parallel/mesh.py`.

Parallelism model, as in the JAX package: a 'data' axis with the batch
sharded over it and the parameters replicated; gradients are averaged over
it. Where JAX puts one global array across the devices of one process
(`NamedSharding`), the port runs one process a card and each rank holds its
own tensors: `shard_batch` gives this rank its rows of a global batch,
`replicate` makes every rank hold rank 0's tensors. JAX's `batch_sharding`
and `replicated` (sharding objects for `device_put` and `jit`) have no
tensor-level counterpart in PyTorch, and the port defines none.

The collectives are broadcasts, all_reduces and one all_gather into a flat
tensor (`gather_rows`, and `reduce_rows`, its transpose, through an
all_reduce), which NCCL and gloo both run on the rank's device (the card's torch
ran each under gloo on CUDA tensors, so two ranks can share one card). A
collective that the backend refuses raises; nothing is moved through the
host instead.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from wavemamba_torch.parallel.dist import rank_device


def make_mesh(n_devices: int | None = None, axis_names: Sequence[str] = ("data",)):
    """A `DeviceMesh` over the process group's ranks, its first axis as long
    as the world (the others 1), on this rank's device type. One process
    without a group has no mesh: None, the mesh-less path of every function
    that takes one. `n_devices` may only name the world size: every rank
    takes part in every step."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}) without a process group: one process "
                             "drives one device; start the ranks with torchrun")
        return None
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a group of {world} ranks: the mesh spans "
                         "the whole group")
    shape = (world,) + (1,) * (len(axis_names) - 1)
    return DeviceMesh((rank_device() or torch.device("cpu")).type, torch.arange(world).view(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis="data") -> int:
    """Ranks along `axis`: 1 without a mesh."""
    return 1 if mesh is None else dist.get_world_size(mesh.get_group(axis))


def axis_rank(mesh, axis="data") -> int:
    """This rank's index along `axis`: 0 without a mesh."""
    return 0 if mesh is None else dist.get_rank(mesh.get_group(axis))


def _device(group):
    """Where a host value takes part in a collective: the rank's card under
    NCCL (which reduces device memory only), else the CPU."""
    if dist.get_backend(group) == "nccl":
        return rank_device() or torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(mesh, batch, axis="data"):
    """This rank's rows of a global batch: a tensor or numpy array, or each
    of those in a dict (other values, such as paths, as they are), split
    along its first dimension into `axis_size` equal parts, part
    `axis_rank`. A first dimension that does not divide raises. Without a
    mesh, `batch` itself."""
    if mesh is None:
        return batch
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not shard over {n} ranks")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return take(batch)


def _tensors(tree):
    """Every tensor of a tree of dicts, lists, tuples, modules (their state
    dict: parameters and buffers) and optimizers (their state)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.state_dict(keep_vars=True).values()
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            yield from _tensors(state)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate(mesh, tree, axis="data"):
    """Every tensor of `tree` (see `_tensors`) overwritten in place with the
    first rank's of `axis`: every rank then starts from the same parameters
    and state. Returns `tree`."""
    if mesh is None:
        return tree
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)
    dev = _device(group)
    for t in _tensors(tree):
        t = t.data if isinstance(t, torch.nn.Parameter) else t
        if dist.get_backend(group) == "nccl" and t.device.type != "cuda":
            staged = t.to(dev)  # NCCL moves device memory only: a host scalar (Adam's step)
            dist.broadcast(staged, src, group=group)
            t.copy_(staged)
        else:
            dist.broadcast(t, src, group=group)
    return tree


def all_reduce_sum_(mesh, t, axis="data"):
    """`t` summed over `axis` in place; `t` itself without a mesh."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def gather_rows(mesh, t, axis="data"):
    """(n, *t.shape): every rank's `t` along `axis`, in rank order, on every
    rank (one all_gather). `t[None]` without a mesh."""
    if mesh is None:
        return t[None]
    n = axis_size(mesh, axis)
    out = t.new_empty(n * t.numel())  # flat: gloo takes no (n, ...) output
    dist.all_gather_into_tensor(out, t.contiguous().view(-1), group=mesh.get_group(axis))
    return out.view((n,) + tuple(t.shape))


def reduce_rows(mesh, t, axis="data"):
    """The transpose of `gather_rows`: t (n, *shape) on every rank -> the sum
    over the ranks of row `axis_rank` (a reduce-scatter, taken as one
    all_reduce of the rows: the backward of the sequence-sharded scan sends
    rows the size of a scan state, where the n-fold bytes cost nothing that
    counts). `t[0]` without a mesh."""
    if mesh is None:
        return t[0]
    total = all_reduce_sum_(mesh, t.clone(memory_format=torch.contiguous_format), axis)
    return total[axis_rank(mesh, axis)]


def world_sum(values):
    """Host values as a float64 numpy array summed over the whole process
    group (on the CPU under gloo, on the rank's card under NCCL); as they
    are without a group."""
    values = np.array(values, np.float64)
    if not (dist.is_available() and dist.is_initialized()):
        return values
    t = torch.from_numpy(values).to(_device(None))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def mean_(mesh, tensors, axis="data"):
    """Each tensor of the list replaced in place by its mean over `axis`, in
    one all_reduce of their concatenation. Unchanged without a mesh."""
    if mesh is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum_(mesh, flat, axis).div_(axis_size(mesh, axis))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors
