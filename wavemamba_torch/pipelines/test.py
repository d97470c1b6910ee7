"""Test pipeline. The counterpart of `wavemamba_tpu/pipelines/test.py`.

    python -m wavemamba_torch.pipelines.test -opt options/test_wavemamba_uhdll.yml

Runs every dataset of the options through `RestorationModel.validation` on
the card, or on the CPU with `--device cpu`; writes the images under
`results/<name>/visualization` and returns {dataset: {metric: average}}.
Under torchrun (`--nproc_per_node=N`) the ranks share out each dataset's
images round-robin, each writes the images it enhanced, and every rank
returns the averages over all of them.
"""

from __future__ import annotations

import os
import time

from wavemamba_torch.data import ThreadedLoader, build_dataset, device_prefetch
from wavemamba_torch.parallel import barrier, initialize, is_master, make_mesh
from wavemamba_torch.parallel.dist import shutdown
from wavemamba_torch.runner import build_model
from wavemamba_torch.utils.logger import get_env_info, get_root_logger
from wavemamba_torch.utils.misc import make_exp_dirs
from wavemamba_torch.utils.options import dict2str, parse_options


def test_pipeline(root_path, args=None):
    opt, _ = parse_options(root_path, is_train=False, args=args)
    opt["device"] = str(initialize(device=opt["device"]))  # a process group under torchrun
    mesh = make_mesh()
    barrier()
    if is_master():
        make_exp_dirs(opt)
    barrier()
    log_file = os.path.join(opt["path"]["log"], f"test_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = build_dataset(dataset_opt)
        loaders.append((dataset_opt["name"], ThreadedLoader(test_set, batch_size=1, num_workers=2)))
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")

    model = build_model(opt, mesh)
    results = {}
    for name, loader in loaders:
        logger.info(f"Testing {name}...")
        avg, _ = model.validation(device_prefetch(loader, model.device), current_iter=opt["name"],
                                  save_img=opt.get("val", {}).get("save_img", True))
        results[name] = avg
    return results


if __name__ == "__main__":
    try:
        test_pipeline(os.getcwd())
    finally:
        shutdown()
