"""Raw-against-EMA checkpoint evaluation of a finished training run, the
protocol to choose a checkpoint by. The counterpart of
`scripts/eval_run_ckpts.py`: the whole validation split of the run's own
yml, its network configuration, and the runner's validation metrics, so the
numbers are those of the run's own logged validations (the EMA weights are
what a run validates with when EMA is on).

    python -m wavemamba_torch.scripts.eval_run_ckpts experiments/<run>/ [--iters 8000,9000]

The experiment dir holds the yml that `pipelines.train` archived there and
the `models/net_g_<iter>.pth` / `net_g_ema_<iter>.pth` that
`checkpoint.save_network` wrote. Each is loaded strictly into the yml's
network (`runner.build_model`) and validated through the port's
`ThreadedLoader` and `device_prefetch`; the script prints each label's
metrics and the best by the yml's `key_metric`. A yml's relative dataroots
resolve against `--root` (the repository by default), as training resolves
them against its working directory. Runs on `--device` (the card by
default), in the yml's own precision.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import tempfile
import time

from wavemamba_torch.scripts.common import REPO, print_launches


def saved_iters(models_dir):
    """The iterations with a `net_g_<iter>.pth` or `net_g_ema_<iter>.pth`."""
    its = set()
    for name in os.listdir(models_dir):
        m = re.fullmatch(r"net_g(?:_ema)?_(\d+)\.pth", name)
        if m:
            its.add(int(m.group(1)))
    return sorted(its)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("exp_dir", help="experiments/<run>/ directory")
    ap.add_argument("--iters", default=None,
                    help="comma-separated iteration numbers (default: all saved)")
    ap.add_argument("--pretrain", default=None,
                    help="a .pth the network is built from before the checkpoints load (the "
                         "JAX script's restore template; each checkpoint replaces every weight)")
    ap.add_argument("--root", default=REPO, help="where the yml's relative paths resolve")
    ap.add_argument("--work_dir", default=None,
                    help="where validation may write (default: a temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.data.loader import ThreadedLoader, build_dataset, device_prefetch
    from wavemamba_torch.runner import build_model
    from wavemamba_torch.utils.options import yaml_load

    ymls = glob.glob(os.path.join(args.exp_dir, "*.yml"))
    if len(ymls) != 1:
        raise SystemExit(f"expected one yml in {args.exp_dir}, got {ymls}")
    opt = yaml_load(ymls[0])
    opt["is_train"] = False
    opt["device"] = args.device
    work = args.work_dir or tempfile.mkdtemp(prefix="eval_run_")
    opt["path"] = {"pretrain_network_g": args.pretrain,
                   "models": os.path.join(work, "models"),
                   "training_states": os.path.join(work, "states"),
                   "visualization": os.path.join(work, "vis")}
    opt["dist"] = False
    val_opt = dict(opt["datasets"]["val"], phase="val")
    for key in ("dataroot_gt", "dataroot_lq"):
        if val_opt.get(key):
            val_opt[key] = os.path.join(args.root, os.path.expanduser(val_opt[key]))

    val_set = build_dataset(val_opt)
    print(f"val images: {len(val_set)} ({val_opt['name']})", flush=True)
    model = build_model(opt)

    models_dir = os.path.join(args.exp_dir, "models")
    its = [int(x) for x in args.iters.split(",")] if args.iters else saved_iters(models_dir)
    labels = [label for it in its for label in (f"net_g_{it}", f"net_g_ema_{it}")]
    results = {}
    for label in labels:
        path = os.path.join(models_dir, f"{label}.pth")
        if not os.path.exists(path):
            print(f"{label}: missing", flush=True)
            continue
        model.model.load_state_dict(load_network(path, device=model.device), strict=True)
        loader = ThreadedLoader(val_set, batch_size=1, num_workers=2)
        t0 = time.time()
        avg, _ = model.validation(device_prefetch(loader, model.device), current_iter=label,
                                  save_img=False)
        results[label] = avg
        print(f"{label}: " + ", ".join(f"{k}={v:.4f}" for k, v in avg.items())
              + f" ({time.time() - t0:.1f}s)", flush=True)
    if results:
        key = opt.get("val", {}).get("key_metric", "psnr")
        best = max(results, key=lambda lb: results[lb].get(key, float("-inf")))
        print(f"BEST by {key}: {best} ({results[best]})", flush=True)
    print_launches()
    print("DONE", flush=True)
    return results


if __name__ == "__main__":
    main()
