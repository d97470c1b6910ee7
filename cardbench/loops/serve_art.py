"""Serving loop for ART, built by the CLI from an options yml (`-opt`):
whole frames through the inference CLI's per-image path. It serves ART
alone: it reads ART's attention counter and counts ART's FLOPs, so another
architecture takes a loop of its own.

As `loops/serve.py`, whose `reference_answer` and `weights_for` it uses:
each request is `img2batch`, `enhance(model, batch, BucketLadder())`,
`batch2img`, in the CLI's float32 parity mode, one client in a closed loop,
timed from its start to its uint8 answer on the host. The model is built by
the CLI's own `load_model` from the configuration's `network_g`, and must
have the configuration's `program` fields. The reference is the module the
configuration's `reference` names (`from_config`, `set_tf32`,
`lower_precision`).

The layer context of a traced run carries the model FLOPs a request
(`flops_art.py`), the shapes of a request's attention calls
(`flops_art.attention_calls`, for `roofline_art.py`) and the calls the
program counted in the traced window (`models/art.py:fused_attention.calls`).
"""

from __future__ import annotations

import gc
import importlib
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from cardbench import check, flops_art, trace, traffic_gen
from cardbench.loops.serve import reference_answer, weights_for


def reference_module(cfg: dict):
    """The module of the configuration's `reference` file."""
    return importlib.import_module(cfg["reference"].removesuffix(".py").replace("/", "."))


def run(cell) -> dict:
    from wavemamba_torch.inference import enhance, load_model, set_parity_mode
    from wavemamba_torch.models.art import fused_attention
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.utils.img_util import batch2img, img2batch

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    on_card = dev.type == "cuda"
    reference = reference_module(cfg)
    set_parity_mode()  # as inference.main does before it builds the model
    ref_model = reference.from_config(cfg)
    weights = weights_for(cfg, ref_model, cell.seed, dev)
    model = load_model(cfg["network_g"], weights, dev)
    stated = {k: getattr(model.cfg, k) for k in cfg["program"]}
    if stated != cfg["program"]:
        raise ValueError(f"the program runs {stated}, the configuration states {cfg['program']}")
    pool = traffic_gen.frames(mix, cell.seed, dev)
    ladder = BucketLadder()

    def request(img):
        with record_function("cardbench.img2batch"):
            batch = img2batch(img)
        with record_function("cardbench.enhance"):
            out = enhance(model, batch, ladder)
        with record_function("cardbench.batch2img"):
            return batch2img(out)

    for i in range(mix["warmup_requests"]):
        request(pool[i % len(pool)])
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - cell.t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    sequence = traffic_gen.order(mix, cell.seed, 1 << 16)
    kept, wall, failed = {}, [], 0
    calls_before = fused_attention.calls

    def serve(k):
        nonlocal failed
        t0 = time.perf_counter()
        try:
            answer = request(pool[sequence[k]])
        except Exception as exc:  # a request that fails is counted, and the loop goes on
            failed += 1
            print(f"request {k} failed: {exc!r}", file=sys.stderr)
            return
        wall.append(time.perf_counter() - t0)
        if k < mix["kept_requests"]:
            kept[k] = answer

    traced = None
    w0 = time.perf_counter()
    if cell.trace:
        with trace.profiled(dev.type) as got:
            for k in range(mix["trace_requests"]):
                serve(k)
        traced = got[0]
        attempted = mix["trace_requests"]
    else:
        attempted = 0
        while time.perf_counter() - w0 < cell.seconds:
            serve(attempted)
            attempted += 1
    window_s = time.perf_counter() - w0
    attn_calls = fused_attention.calls - calls_before
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference.set_tf32(False)
    ref_model.load_state_dict(weights, strict=True)
    ref_model.to(dev).eval()
    readings = []
    for k in traffic_gen.checked(cell.seed, min(len(kept), mix["kept_requests"]),
                                 mix["checked_requests"]):
        if k in kept:
            readings.append(check.compare_u8(kept[k], reference_answer(ref_model, pool[sequence[k]],
                                                                       dev)))
    numbers = check.widest(readings) if readings else {}

    h, w = mix["height"], mix["width"]
    bh, bw = -(-h // 128) * 128, -(-w // 128) * 128
    g = cfg["network_g"]
    out = {"attempted": attempted, "failed": failed, "setup_s": setup_s,
           "memory_peak_bytes": max(setup_peak, window_peak), "numbers": numbers}
    if not cell.trace:
        out["e2e"] = {"serve_images_per_s": len(wall) / window_s,
                      "serve_latency_p90_ms": float(np.percentile(wall, 90)) * 1e3}
    else:
        out["trace"] = traced
        out["layer_ctx"] = {
            "kind": "serve", "trace": traced, "requests": len(wall), "request_s": wall,
            "flops_per_request": flops_art.model_flops(g, 1, bh, bw),
            "attn_shapes": flops_art.attention_calls(g, 1, bh, bw), "attn_calls": attn_calls,
            "peak_flops": cfg["peak_tflops"]["serve"] * 1e12, "window_peak_bytes": window_peak}
    return out


def control(cell) -> dict:
    """The control's numbers for `cell`: the reference one precision below
    the configuration's (`config['control']['serve']`) in the program's
    place on the requests a run checks, against the reference in float32."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    reference = reference_module(cfg)
    model = reference.from_config(cfg)
    model.load_state_dict(weights_for(cfg, model, cell.seed, dev), strict=True)
    model.to(dev).eval()
    pool = traffic_gen.frames(mix, cell.seed, dev)
    sequence = traffic_gen.order(mix, cell.seed, mix["kept_requests"])
    reference.set_tf32(False)
    readings = []
    for k in traffic_gen.checked(cell.seed, mix["kept_requests"], mix["checked_requests"]):
        frame = pool[sequence[k]]
        with reference.lower_precision(cfg["control"]["serve"], dev.type):
            lower = reference_answer(model, frame, dev)
        readings.append(check.compare_u8(lower, reference_answer(model, frame, dev)))
    return check.widest(readings)

