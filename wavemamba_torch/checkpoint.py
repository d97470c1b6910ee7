"""Network weights and training states on disk, `torch.save` files. The
counterpart of `wavemamba_tpu/train/checkpoint.py` (Orbax there).

  * Network weights: `save_network` writes the reference's `.pth` layout,
    `{'params': state_dict}`, as `<net_label>_<iter>.pth` plus a
    `<net_label>_latest.pth` copy; `load_network` reads any such file, the
    shipped checkpoints included, and so does the JAX package's
    `convert/torch_import.py`.
  * Training state: `save_training_state` writes a `TrainState.state_dict()`
    (step, parameters, Adam's moments, EMA) as `<states_dir>/<iter>.state`;
    `find_resume_state` picks the highest iteration.

Writes go to a temporary file that is renamed into place.
"""

from __future__ import annotations

import os
import re

import torch

from wavemamba_torch.convert import load_pth
from wavemamba_torch.device import resolve_device


def _save(obj, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_network(model, models_dir: str, net_label: str, current_iter) -> str:
    """Save a model's (or a state dict's) weights as `<net_label>_<iter>.pth`
    and refresh `<net_label>_latest.pth`. current_iter -1 means 'latest'."""
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    obj = {"params": {k: v.detach().cpu() for k, v in sd.items()}}
    if current_iter == -1:
        current_iter = "latest"
    root = os.path.abspath(models_dir)
    path = _save(obj, os.path.join(root, f"{net_label}_{current_iter}.pth"))
    if current_iter != "latest":
        _save(obj, os.path.join(root, f"{net_label}_latest.pth"))
    return path


def load_network(path: str, device="cuda") -> dict:
    """A reference-format `.pth`/`.pt` -> its state dict on `device`.

    Orbax directories and `.wmx` deployment artifacts belong to the JAX
    package and are not read by the port: the JAX package's
    `wavemamba_tpu/convert/torch_export.py:params_to_state_dict` turns an
    Orbax checkpoint's params into a state dict to save as a `.pth`. The
    port's own deployment artifacts (`.wmt`) hold programs, and are served by
    `wavemamba_torch.deploy.load_exported`."""
    if path.endswith(".wmx"):
        raise ValueError(f"{path}: .wmx deployment artifacts belong to the JAX package; the port's "
                         "own are .wmt files (wavemamba_torch/deploy.py)")
    if path.endswith(".wmt"):
        raise ValueError(f"{path}: a .wmt deployment artifact holds programs, not a state dict; "
                         "serve it with wavemamba_torch.deploy.load_exported")
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: the port reads .pth/.pt weights only; for an Orbax directory, "
                         "make a state dict with the JAX package's "
                         "wavemamba_tpu/convert/torch_export.py:params_to_state_dict and save it "
                         "as a .pth")
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in load_pth(path).items()}


def save_training_state(state, states_dir: str, current_iter: int) -> str:
    """Save a `TrainState` as `<states_dir>/<iter>.state`."""
    sd = state.state_dict()
    cpu = lambda d: None if d is None else {k: v.cpu() for k, v in d.items()}
    obj = {**sd, **{k: cpu(sd[k]) for k in ("params", "exp_avg", "exp_avg_sq", "ema")}}
    return _save(obj, os.path.join(os.path.abspath(states_dir), f"{current_iter}.state"))


def restore_training_state(path: str, state):
    """Load a saved training state into `state` (a fresh `TrainState` of the
    same model and `TrainConfig`); returns it."""
    state.load_state_dict(torch.load(os.path.abspath(path), map_location="cpu",
                                     weights_only=True))
    return state


def find_resume_state(states_dir: str):
    """The state file of the highest iteration, or None."""
    if not os.path.isdir(states_dir):
        return None
    iters = [int(m.group(1)) for name in os.listdir(states_dir)
             if (m := re.fullmatch(r"(\d+)\.state", name))]
    if not iters:
        return None
    return os.path.join(states_dir, f"{max(iters)}.state")
