"""YAML options and CLI flags. The counterpart of
`wavemamba_tpu/utils/options.py`, with the same surface: `-opt <yml>`,
`--auto_resume`, `--debug`, `--force_yml a:b=c` overrides, the per-phase
dataset expansion and the experiment directory layout; plus `--device`, the
only way onto the CPU (`opt['device']`, 'cuda' unless asked otherwise).
`yaml` is imported by the functions that read or dump yml only, so the rest
of the port runs where PyYAML is missing."""

from __future__ import annotations

import argparse
import ast
import os
import random
import sys
from collections import OrderedDict


def ordered_yaml():
    """(Loader, Dumper) that keep the order of mappings."""
    import yaml

    try:
        from yaml import CDumper as Dumper
        from yaml import CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, dict_constructor)
    return Loader, Dumper


def yaml_load(f):
    """A yml file's path, or yml text -> ordered dict."""
    import yaml

    if os.path.isfile(f):
        with open(f, "r") as fh:
            return yaml.load(fh, Loader=ordered_yaml()[0])
    return yaml.load(f, Loader=ordered_yaml()[0])


def dict2str(opt, indent_level=1):
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg


def _postprocess_yml_value(value: str):
    """A `--force_yml` value as yml would read it."""
    if value == "~" or value.lower() == "none":
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.startswith("["):
        return list(ast.literal_eval(value))
    if value.isdigit():
        return int(value)
    if value.replace("-", "", 1).isdigit() and value.count("-") <= 1:
        return int(value)
    try:
        return float(value)
    except ValueError:
        return value


def apply_force_yml(opt: dict, force_entries):
    """Apply `train:optim_g:lr=1e-4`-style overrides."""
    for entry in force_entries or []:
        keys, value = entry.split("=", 1)
        node = opt
        parts = keys.strip().split(":")
        for k in parts[:-1]:
            node = node[k.strip()]
        node[parts[-1].strip()] = _postprocess_yml_value(value.strip())
    return opt


def parse_options(root_path, is_train=True, args=None):
    """(opt, parsed args). `root_path` is where `experiments/` and `results/`
    go."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Force to update yml files. Examples: train:ema_decay=0.999")
    parser.add_argument("--device", default=None,
                        help="'cuda' (default; raises where CUDA is missing) or 'cpu'")
    parsed = parser.parse_args(args)

    opt = yaml_load(parsed.opt)
    opt["auto_resume"] = parsed.auto_resume
    opt["is_train"] = is_train
    apply_force_yml(opt, parsed.force_yml)
    if parsed.device is not None:
        opt["device"] = parsed.device
    opt.setdefault("device", "cuda")

    if parsed.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]

    seed = opt.get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
        opt["manual_seed"] = seed

    # datasets: the phase and the scale go into each
    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        if dataset.get("dataroot_gt") is not None:
            dataset["dataroot_gt"] = os.path.expanduser(dataset["dataroot_gt"])
        if dataset.get("dataroot_lq") is not None:
            dataset["dataroot_lq"] = os.path.expanduser(dataset["dataroot_lq"])

    opt.setdefault("path", OrderedDict())
    for key, val in opt["path"].items():
        if (val is not None) and ("resume_state" in key or "pretrain_network" in key):
            opt["path"][key] = os.path.expanduser(val)
    if is_train:
        experiments_root = os.path.join(root_path, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = os.path.join(experiments_root, "models")
        opt["path"]["training_states"] = os.path.join(experiments_root, "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = os.path.join(experiments_root, "visualization")
        if parsed.debug:
            opt["train"]["total_iter"] = 24
            opt["val"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(root_path, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = os.path.join(results_root, "visualization")
    return opt, parsed


def copy_opt_file(opt_file: str, experiments_root: str):
    """Archive the yml in the experiment's root under a header with the time
    and the command line."""
    import shutil
    import time

    cmd = " ".join(sys.argv)
    filename = os.path.join(experiments_root, os.path.basename(opt_file))
    shutil.copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# {cmd}\n\n")
        f.seek(0)
        f.writelines(lines)
