"""Checkpoint layouts: reference `.pth` files and the JAX package's trees.

The port's module names are the `.pth` keys, so a reference checkpoint needs
no conversion (`load_pth`). `state_dict_from_jax` carries a parameter tree of
the JAX package (`wavemamba_tpu`, NHWC/HWIO, given as numpy arrays) over to
the port's state dict: the exact inverse of the JAX package's `.pth`
importer, and the port's own copy of its `convert/torch_export.py`.
`train_state_from_jax` does the same for a whole JAX train state, so that
both trainers can continue from one state.
"""

from __future__ import annotations

import numpy as np
import torch


def load_pth(path: str, param_key: str = "params") -> dict:
    """Deserialize a `.pth` into {name: CPU tensor}. Takes the state dict
    under `param_key`, else `params_ema`, `params` or `state_dict`, and strips
    a DDP `module.` prefix."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in (param_key, "params_ema", "params", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k.removeprefix("module."): v for k, v in obj.items()}


def _emit(out: dict, prefix: list[str], tree) -> None:
    if isinstance(tree, list):
        for i, sub in enumerate(tree):
            # FeedForward.project_out is Sequential(dwconv, GELU, conv).
            idx = {0: "0", 1: "2"}[i] if prefix[-1] == "project_out" else str(i)
            _emit(out, prefix + [idx], sub)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _emit(out, prefix + [k], v)
        return

    v = np.asarray(tree)
    toks = list(prefix)
    leaf = toks[-1]
    parent = toks[-2] if len(toks) >= 2 else ""
    base = toks[:-1]

    if leaf in ("x_proj_w", "dt_projs_w", "dt_projs_b"):
        name = {"x_proj_w": "x_proj_weight", "dt_projs_w": "dt_projs_weight",
                "dt_projs_b": "dt_projs_bias"}[leaf]
        out[".".join(base + [name])] = v
    elif leaf == "A_logs":  # (4, D, N) -> (4D, N)
        out[".".join(toks)] = v.reshape(-1, v.shape[-1])
    elif leaf == "Ds":  # (4, D) -> (4D,)
        out[".".join(toks)] = v.reshape(-1)
    elif leaf == "temperature":  # (heads,) -> (heads, 1, 1)
        out[".".join(toks)] = v.reshape(-1, 1, 1)
    elif leaf in ("skip_scale", "skip_scale2"):
        out[".".join(toks)] = v
    elif parent == "prelu" and leaf == "a":  # conv_du.prelu.a -> conv_du.1.weight
        out[".".join(toks[:-2] + ["1", "weight"])] = v
    elif parent == "conv" and len(toks) >= 3 and toks[-3] == "conv_du":  # -> conv_du.0
        arr = np.transpose(v, (3, 2, 0, 1)) if leaf == "w" and v.ndim == 4 else v
        out[".".join(toks[:-2] + ["0", {"w": "weight", "b": "bias"}[leaf]])] = arr
    elif leaf in ("w", "b"):
        if base and base[-1].startswith("ps_down"):  # Sequential(PixelUnshuffle, Conv)
            base = base + ["1"]
        if leaf == "b":
            out[".".join(base + ["bias"])] = v
        elif v.ndim == 4:  # conv HWIO -> OIHW
            out[".".join(base + ["weight"])] = np.transpose(v, (3, 2, 0, 1))
        else:  # linear (in, out) -> (out, in)
            out[".".join(base + ["weight"])] = np.transpose(v)
    elif leaf == "g":
        out[".".join(base + ["weight"])] = v
    else:
        raise ValueError(f"unrecognized leaf {'.'.join(toks)} shape {v.shape}")


def state_dict_from_jax(params) -> dict:
    """A JAX-package parameter tree (nested dicts/lists of arrays) -> the
    port's state dict {name: float32 CPU tensor}."""
    out: dict = {}
    _emit(out, [], params)
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside an optimizer state of nested tuples:
    the one entry with `mu`, `nu` and `count`."""
    if all(hasattr(opt_state, a) for a in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(state) -> dict:
    """A train state of the JAX package, arrays as numpy ({'step', 'params',
    'opt_state' (optax adamw, with or without a clip before it), 'ema'?}) ->
    what `train.trainer.TrainState.load_state_dict` takes: parameters, Adam's
    `mu`/`nu`/`count` as `exp_avg`/`exp_avg_sq`/`adam_step`, and the EMA."""
    adam = _adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in opt_state")
    return {"step": int(state["step"]), "params": state_dict_from_jax(state["params"]),
            "exp_avg": state_dict_from_jax(adam.mu), "exp_avg_sq": state_dict_from_jax(adam.nu),
            "adam_step": int(adam.count),
            "ema": state_dict_from_jax(state["ema"]) if "ema" in state else None}
