"""Headline benchmark of the port: WaveMamba (the shipped config, seeded
weights) 1080x1920 single-image inference latency on one CUDA card.

    python -m wavemamba_torch.bench            # WM_MODE=fast (default)
    WM_MODE=parity python -m wavemamba_torch.bench

The counterpart of the root `bench.py`, with its modes (`WM_MODE`): `fast`,
`WaveMambaConfig.fast()` (bf16, K1 on bf16 token streams); `fast_xla`,
`WaveMambaConfig.fast_xla()` (bf16, the 'par' scan, no kernel); `parity`,
`WaveMambaConfig()` (float32, K1). Its input: a seeded uniform 1080x1920
frame (`np.random.RandomState(0)`). Its timing: K = 10 forwards back to back
between two CUDA events, per frame, the median of 3 such runs, after two
warm-up forwards; `device_ms` is the device time of the kernels of one
forward by `torch.profiler`, the mean over 3 forwards. TF32 is off, as in
the inference CLI. Prints one JSON line: `metric`, `value` (seconds),
`unit`, `vs_baseline`, `device_ms`, and the card's name and power limit as
nvidia-smi reports them. It needs a card and exits non-zero without one.

`vs_baseline` is `BASELINE_1080P_S / value`. `BASELINE_1080P_S` is the
paper's figure for a 1920x1080 forward on the authors' own GPU
(`BASELINE.md`), not a number measured on an H100.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

BASELINE_1080P_S = 0.402  # the paper's GPU (BASELINE.md), not an H100
MODES = ("fast", "fast_xla", "parity")
K, RUNS, TRACED = 10, 3, 3


def config(mode):
    from wavemamba_torch.models import WaveMambaConfig

    if mode == "fast":
        return WaveMambaConfig.fast()
    if mode == "fast_xla":
        return WaveMambaConfig.fast_xla()
    if mode == "parity":
        return WaveMambaConfig()
    raise ValueError(f"WM_MODE={mode!r}; known: {MODES}")


def device_ms_per_call(fn, calls):
    """Device time (ms) of the kernels and copies `fn` runs, by
    torch.profiler, over `calls` calls of it, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / calls


def run(mode="fast"):
    """The benchmark's result dict for one mode, on the current CUDA card."""
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.models import init_network
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    set_parity_mode()
    cfg = config(mode)
    model = init_network({"type": "WaveMamba", **dataclasses.asdict(cfg)},
                         torch.Generator().manual_seed(0), device="cuda", train=False)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 1080, 1920, 3).astype(np.float32)).cuda()
    fwd = lambda: wavemamba_apply(model, x)  # noqa: E731
    for _ in range(2):
        fwd()
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()  # start from an idle card
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K):
            out = fwd()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / K)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"bench {mode}: the output is not finite")
    latency = float(np.median(times))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return {"metric": f"wavemamba_1080p_latency({mode})", "value": latency, "unit": "s",
            "vs_baseline": BASELINE_1080P_S / latency,
            "device_ms": device_ms_per_call(fwd, TRACED), "runs_s": times,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def main():
    if not torch.cuda.is_available():
        sys.exit("bench: torch.cuda.is_available() is False; the benchmark measures the card")
    print(json.dumps(run(os.environ.get("WM_MODE", "fast"))), flush=True)


if __name__ == "__main__":
    main()
