"""Serving loop: whole frames through the inference CLI's per-image path.

Each request is the work `wavemamba_torch.inference` does for one image
between `imread` and `imwrite`: `img2batch`, `enhance(model, batch,
BucketLadder())`, `batch2img`, in the CLI's float32 parity mode, with the
model built as the CLI builds it (`WaveMambaConfig` or its `fast` preset,
through `build_network`). Clients wait for each answer before they send the
next (a closed loop). A request is timed from its start to its uint8 answer
on the host.

Set-up: weights (`reference/init.py`) and the frame pool (`traffic_gen`)
on the device, the model, and `warmup_requests` requests at the cell's own
frame size, which build the kernels and allocate what the window reuses.
After the window, the program is freed and the reference answers
`checked_requests` of the first `kept_requests` requests, drawn from the
seed.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from cardbench import check, flops, trace, traffic_gen
from cardbench.reference import wavemamba as reference
from cardbench.reference.init import make_state_dict


def build_program(cfg: dict, state_dict: dict, device):
    """The model as the CLI's `_serve` builds it for the configuration's
    preset; raises where it departs from the configuration's `program`."""
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.wavemamba import WaveMambaConfig

    g = cfg["network_g"]
    make = WaveMambaConfig.fast if cfg["preset"] == "fast" else WaveMambaConfig
    pcfg = make(in_chn=g["in_chn"], wf=g["wf"], n_l_blocks=tuple(g["n_l_blocks"]),
                n_h_blocks=tuple(g["n_h_blocks"]), ffn_scale=g["ffn_scale"],
                d_state=g["d_state"], d_conv=g["d_conv"])
    stated = {k: getattr(pcfg, k) for k in cfg["program"]}
    if stated != cfg["program"]:
        raise ValueError(f"the program runs {stated}, the configuration states {cfg['program']}")
    return build_network({"type": "WaveMamba", **dataclasses.asdict(pcfg)}, state_dict,
                         device=device)


def reference_answer(model, frame: np.ndarray, device) -> np.ndarray:
    """The reference's BGR uint8 answer to one BGR uint8 frame: to [0, 1]
    RGB, reflect-padded bottom and right to the next multiple of 128 (the
    bucket of a mix of one frame size), the network, cropped, clipped,
    scaled to 255 and rounded."""
    h, w = frame.shape[:2]
    rgb = frame[..., ::-1].astype(np.float32) / 255.0
    rgb = np.pad(rgb, ((0, -h % 128), (0, -w % 128), (0, 0)), mode="reflect")
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(rgb)).to(device).permute(2, 0, 1)[None]
        y = model(x)[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()
    return (np.clip(y, 0.0, 1.0)[..., ::-1] * 255.0).round().astype(np.uint8)


def weights_for(cfg: dict, model, seed: int, device) -> dict:
    """The state dict both sides load: the configuration's checkpoint
    (`weights.serve`, a `.pth` under the `params` key) where it names one,
    else the benchmark's seeded weights."""
    path = cfg.get("weights", {}).get("serve")
    if path:
        return torch.load(path, map_location=device, weights_only=True)["params"]
    return make_state_dict(model, traffic_gen.sub_seed(seed, traffic_gen.WEIGHTS), device)


def _k1_launches():
    from wavemamba_torch.ops import scan_cuda

    return scan_cuda.ss2d_scan_pair.launches


def run(cell) -> dict:
    from wavemamba_torch.inference import enhance, set_parity_mode
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.utils.img_util import batch2img, img2batch

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    on_card = dev.type == "cuda"
    set_parity_mode()  # as inference.main does before it builds the model
    ref_model = reference.from_config(cfg)
    weights = weights_for(cfg, ref_model, cell.seed, dev)
    model = build_program(cfg, weights, dev)
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
    k1_before = _k1_launches()

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
    k1_calls = _k1_launches() - k1_before
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
    n_done = len(wall)
    out = {"attempted": attempted, "failed": failed, "setup_s": setup_s,
           "memory_peak_bytes": max(setup_peak, window_peak), "numbers": numbers}
    if not cell.trace:
        out["e2e"] = {"serve_images_per_s": n_done / window_s,
                      "serve_latency_p90_ms": float(np.percentile(wall, 90)) * 1e3}
    else:
        out["trace"] = traced
        out["layer_ctx"] = {
            "kind": "serve", "trace": traced, "requests": n_done, "request_s": wall,
            "flops_per_request": flops.model_flops(g, 1, bh, bw),
            "k1_calls": flops.scan_calls(g, 1, bh, bw), "k1_launches": k1_calls,
            "stream_bytes": 2 if cfg["program"]["scan_dtype"] == "bfloat16" else 4,
            "peak_flops": cfg["peak_tflops"]["serve"] * 1e12, "window_peak_bytes": window_peak}
    return out


def control(cell) -> dict:
    """The control's numbers for `cell`: the reference in the precision
    just below the configuration's (`config['control']['serve']`, see
    `reference.lower_precision`) put in the program's place on the requests
    a run checks, against the reference in float32."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
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
