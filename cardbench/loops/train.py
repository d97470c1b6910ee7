"""Training loop: the yml's train step on device-resident data.

The system under test is `runner.RestorationModel(opt)` built from the
configuration's copy of the yml (`network_g`, `train`, `manual_seed`),
stepping through `optimize_parameters(batch)` on batches of
`data.device_cache.DeviceCachedLoader.from_arrays` over the mix's seeded
pairs, back to back as a training loop dispatches them; the window ends on
a device fence. The benchmark's weights (`reference/init.py`) are loaded
into the runner's model before the first step.

Set-up drives the runner through its first `checked_steps` steps with the
window's own call and loader, reads each step's loss, the first step's
gradient from AdamW's first moment (exp_avg = (1 - beta1) g after one
update), and the parameters after the last of them; the window then goes on
with the same runner. After the window the program is freed and the
reference (`reference/train.py`) takes the same steps from the same
weights on the same pairs.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.profiler import record_function

from cardbench import check, flops, trace, traffic_gen
from cardbench.reference import train as ref_train
from cardbench.reference import wavemamba as reference
from cardbench.reference.init import make_state_dict


def loader_seed(seed: int) -> int:
    return traffic_gen.sub_seed(seed, traffic_gen.DATA) % (2**31)


def runner_opt(cfg: dict, device) -> dict:
    """The options dict a training pipeline hands `RestorationModel`: the
    configuration's checkpoint as `pretrain_network_g`, where it names one."""
    g, t = cfg["network_g"], cfg["train"]
    return {"network_g": {**g, **cfg["program"]}, "train": t["train"], "is_train": True,
            "device": str(device), "manual_seed": t["manual_seed"],
            "path": {"pretrain_network_g": cfg.get("weights", {}).get("train")}}


def weights_for(cfg: dict, seed: int, device) -> dict:
    """The state dict the steps start from: the configuration's checkpoint
    (`weights.train`, which the runner loads itself as `pretrain_network_g`)
    where it names one, else the benchmark's seeded weights."""
    path = cfg.get("weights", {}).get("train")
    if path:
        return torch.load(path, map_location=device, weights_only=True)["params"]
    return make_state_dict(reference.from_config(cfg),
                           traffic_gen.sub_seed(seed, traffic_gen.WEIGHTS), device)


def set_precision() -> None:
    """float32 with TF32 off in cuDNN and cuBLAS, as the configuration
    states: the training pipeline has no option of its own, so the flags
    are PyTorch's (the inference CLI's `set_parity_mode` sets the same two)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def first_moment_grads(runner, beta1: float) -> dict:
    """{name: norm of the first step's gradient} from AdamW's state; a leaf
    without state (no update was taken) reads 0."""
    state = runner.state.optimizer.state
    return {n: float(state[p]["exp_avg"].norm() / (1 - beta1)) if p in state else 0.0
            for n, p in runner.model.named_parameters()}


def _epochs(loader):
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def reference_steps(cfg, weights, lq, gt, seed, steps, device, lower=None) -> dict:
    """The reference's first `steps` steps: losses, the first gradient's
    norms and the change's norms by leaf (the `check.train_gaps` layout).
    `lower` computes the forward, the loss and the backward one precision
    down (`reference.lower_precision`: the control)."""
    t, d = cfg["train"]["train"], cfg["train"]["dataset"]
    model = reference.from_config(cfg)
    model.load_state_dict(weights, strict=True)
    model.to(device).train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    optim = t["optim_g"]
    adamw = ref_train.AdamW(params, tuple(optim["betas"]), weight_decay=optim["weight_decay"])
    sched = t["scheduler"]
    size, batch = d["gt_size"], d["batch_size_per_gpu"]
    draw = ref_train.draws(len(lq), batch, size, lq.shape[1], lq.shape[2], seed,
                           d["geometric_augs"])
    out = {"losses": [], "grad": {}, "change": {}}
    reference.set_tf32(False)
    for s in range(steps):
        idx, tops, lefts, modes = next(draw)
        x, y = (torch.from_numpy(ref_train.crop(a, idx, tops, lefts, modes, size)).to(device)
                .float() / 255.0 for a in (lq, gt))
        for p in params.values():
            p.grad = None
        with (reference.lower_precision(lower, device.type) if lower
              else contextlib.nullcontext()):
            pred = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            total = ref_train.loss(pred.float(), y, t["pixel_opt"]["loss_weight"],
                                   t["fft_opt"]["loss_weight"])
            total.backward()
        out["losses"].append(float(total.detach()))
        if s == 0:
            out["grad"] = {k: float(p.grad.norm()) for k, p in params.items()}
        lr = ref_train.cyclic_cosine_lr(optim["lr"], sched["periods"], sched["restart_weights"],
                                        sched["eta_mins"], s)
        adamw.step(lr)
    out["change"] = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    return out


def run(cell) -> dict:
    from wavemamba_torch.data.device_cache import DeviceCachedLoader
    from wavemamba_torch.runner import RestorationModel

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    on_card = dev.type == "cuda"
    t, d = cfg["train"]["train"], cfg["train"]["dataset"]
    set_precision()
    runner = RestorationModel(runner_opt(cfg, dev))
    stated = {k: getattr(runner.model.cfg, k) for k in cfg["program"]}
    if stated != cfg["program"]:
        raise ValueError(f"the program runs {stated}, the configuration states {cfg['program']}")
    weights = weights_for(cfg, cell.seed, dev)
    if not cfg.get("weights", {}).get("train"):
        runner.model.load_state_dict(weights, strict=True)
    lq, gt = traffic_gen.pairs(mix, cell.seed, dev)
    batch = d["batch_size_per_gpu"]
    loader = DeviceCachedLoader.from_arrays(
        lq, gt, [{"lq_path": f"{i}", "gt_path": f"{i}"} for i in range(len(lq))],
        {"phase": "train", "gt_size": d["gt_size"], "scale": 1,
         "geometric_augs": d["geometric_augs"]},
        batch, seed=loader_seed(cell.seed), device=dev, budget_gb=mix["cache_budget_gb"])
    batches = _epochs(loader)
    waits = []

    def step():
        t0 = time.perf_counter()
        with record_function("cardbench.data"):
            b = next(batches)
        waits.append(time.perf_counter() - t0)
        with record_function("cardbench.step"):
            return runner.optimize_parameters(b)

    beta1 = t["optim_g"]["betas"][0]
    prog = {"losses": []}
    for s in range(mix["checked_steps"]):
        prog["losses"].append(float(step()["total"]))
        if s == 0:
            prog["grad"] = first_moment_grads(runner, beta1)
    prog["change"] = {n: float((p.detach() - weights[n]).norm())
                      for n, p in runner.model.named_parameters()}
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - cell.t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    from wavemamba_torch.ops import scan_cuda

    k2_before = scan_cuda.ss2d_scan_pair_bwd.launches
    waits.clear()
    steps, traced = 0, None
    w0 = time.perf_counter()
    if cell.trace:
        with trace.profiled(dev.type) as got:
            for _ in range(mix["trace_steps"]):
                step()
            if on_card:
                torch.cuda.synchronize(dev)
        traced, steps = got[0], mix["trace_steps"]
    else:
        while time.perf_counter() - w0 < cell.seconds:
            step()
            steps += 1
        if on_card:
            torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - w0
    k2_calls = scan_cuda.ss2d_scan_pair_bwd.launches - k2_before
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    del runner, loader, batches
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference_steps(cfg, weights, lq, gt, loader_seed(cell.seed), mix["checked_steps"], dev)
    numbers = check.train_gaps(prog, ref)

    g = cfg["network_g"]
    size = d["gt_size"]
    out = {"attempted": steps, "failed": 0, "setup_s": setup_s,
           "memory_peak_bytes": max(setup_peak, window_peak), "numbers": numbers}
    if not cell.trace:
        out["e2e"] = {"train_images_per_s": batch * steps / window_s}
    else:
        out["trace"] = traced
        out["layer_ctx"] = {
            "kind": "train", "trace": traced, "steps": steps, "data_wait_s": list(waits),
            "flops_per_step": 3 * flops.model_flops(g, batch, size, size),
            "k2_calls": flops.scan_calls(g, batch, size, size), "k2_launches": k2_calls,
            "stream_bytes": 2 if cfg["program"]["scan_dtype"] == "bfloat16" else 4,
            "peak_flops": cfg["peak_tflops"]["train"] * 1e12, "window_peak_bytes": window_peak}
    return out


def control(cell) -> dict:
    """The control's numbers for `cell`: the reference one precision below
    the configuration's (`config['control']['train']`) put in the program's
    place, against the reference in float32."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    weights = weights_for(cfg, cell.seed, dev)
    lq, gt = traffic_gen.pairs(mix, cell.seed, dev)
    seed, steps = loader_seed(cell.seed), mix["checked_steps"]
    lower = reference_steps(cfg, weights, lq, gt, seed, steps, dev, cfg["control"]["train"])
    return check.train_gaps(lower, reference_steps(cfg, weights, lq, gt, seed, steps, dev))
