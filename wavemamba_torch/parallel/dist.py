"""Process-group helpers. The counterpart of `wavemamba_tpu/parallel/dist.py`.

One process drives one card, as the reference's DDP does: `initialize()`
joins the `torch.distributed` process group (NCCL for CUDA devices, gloo for
the CPU) and returns this rank's device. Without a group every helper here
answers for one process, rank 0 of 1, as the JAX package's do in a single
process.
"""

from __future__ import annotations

import functools
import os
import socket

import torch
import torch.distributed as dist

from wavemamba_torch.device import resolve_device

# The launcher's variables (torchrun sets them all) that turn the group on.
_LAUNCHER_ENV = ("WORLD_SIZE", "RANK")
# The device `initialize()` gave this rank.
_DEVICE = {"device": None}


def initialize(init_method=None, world_size=None, rank=None, backend=None, device="cuda"):
    """Join the process group; return this rank's device (a `torch.device`).

    A single process (no arguments and no launcher environment) joins
    nothing and gets `resolve_device(device)`, as JAX's `initialize` is a
    no-op there. The group is joined when the caller passes `init_method`,
    `world_size` and `rank`, or under a launcher (torchrun: `WORLD_SIZE` and
    `RANK` in the environment, at any world size, so that
    `--nproc_per_node=1` runs NCCL at world size 1). A second call in a
    process that has joined returns the device again.

    `device='cuda'` under a group is `cuda:LOCAL_RANK` (0 without
    `LOCAL_RANK`) and raises where that card does not exist; `'cuda:i'` is
    taken as given (two ranks may share one card), `'cpu'` is the CPU. The
    backend is NCCL for a CUDA device and gloo for the CPU; `backend='gloo'`
    on a CUDA device keeps the tensors on the card and runs gloo's
    collectives on them (NCCL refuses two ranks on one card). The device is
    made current before the group is joined."""
    if dist.is_initialized():
        return _DEVICE["device"] or _rank_device(device)
    launched = all(k in os.environ for k in _LAUNCHER_ENV)
    if init_method is None and world_size is None and rank is None and not launched:
        return resolve_device(device)
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of torch")
    dev = _rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device; the CPU takes backend='gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()  # a device mesh made later keeps this device
    kw = {} if init_method is None else {"init_method": init_method}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend=backend, **kw)
    _DEVICE["device"] = dev
    return dev


def local_init_method() -> str:
    """`tcp://127.0.0.1:<a free port>`: an `init_method` for ranks that the
    caller starts on this host itself."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local} but this host has {torch.cuda.device_count()} "
                               "CUDA device(s); name the card (device='cuda:0') to share one")
        dev = torch.device("cuda", local)
    return dev


def rank_device():
    """The device `initialize()` gave this rank; None without a group."""
    return _DEVICE["device"] if dist.is_initialized() else None


def get_dist_info():
    """(rank, world_size) in process terms: (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_master() -> bool:
    return get_dist_info()[0] == 0


def master_only(fn):
    """`fn` runs on rank 0 only; other ranks get None."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_master():
            return fn(*args, **kwargs)

    return wrapper


def barrier():
    """Wait for every rank; nothing to wait for without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src=0):
    """`obj` as rank `src` holds it, on every rank (itself without a group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shutdown():
    """Leave the process group, where there is one (the end of a run)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE["device"] = None
