#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`wavemamba_torch`) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds every
kernel of the port from `wavemamba_torch/csrc/`, holds each against its
plain PyTorch version on the card, serves the shipped model at full width,
and prints one JSON line per phase:

  1. device  the card (nvidia-smi), torch and CUDA versions, the kernel build.
  2. k1      kernel K1 (`ss2d_scan_pair`) against `ss2d_scan_pair_plain` at
             the three scan lengths of a 1080p forward, on a ragged length
             and on a column (transposed) token stream; times and bounds.
  3. serve   `ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth` through the CLI's
             load -> bucket pad -> forward -> crop path, three seeded
             low-light requests (1080x1920, 1080x1920, 720x1280); launches
             of K1, latency, peak memory, outputs finite and brighter.
  4. model   the full model with K1 against the same model with the plain
             scan at 256x384, and the card against the CPU at 64x96.
  5. profile device time by kernel (torch.profiler) over one 1152x1920
             forward, and the card's idle share.

Then the `kernels` line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero without the last line. It needs
one card and exits non-zero where CUDA is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, "ckpt", "WaveMamba_ProcLLIE_BSRGAN_XXL4.pth")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores (128 FMA lanes per SM per
# clock, an FMA counted as two operations).
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# Transcendentals (exp2, log2, rcp) run on the special-function units: 16
# results per SM per clock on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput), a sixteenth of F32_OPS_S.
SFU_OPS_S = F32_OPS_S / 16
# K1 against its plain version: max abs difference on the synthetic inputs
# below (|y| up to ~50). The projections and the chunk prefix sum in another
# order than the plain version's einsum and log-depth scan.
K1_ATOL = 1e-4
# The whole model, K1 against the plain scan on the card, and the card
# (cuDNN / cuBLAS in full f32, TF32 off) against the CPU.
MODEL_ATOL = 1e-4
LEVELS_1080P = [(576, 960), (288, 480), (144, 240)]  # token grid of each LFSS level


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps):
    """Median device time of `fn` in ms over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def k1_bound(B, L, D, N, R):
    """Least time (ms) the card could take for one K1 call, what bounds it
    ("bytes" or "operations"), and the unit that bounds it ("hbm", "fma" or
    "sfu").

    Bytes: x read once, y written once, the weights read once. Per (token,
    direction), each computed once: on the FMA pipe, an FMA counted as two,
    the projection 2D(R+2N), dt 2RD, log1p of the softplus D (one operation,
    though it is a polynomial), the recurrence 6 per (n, d) (da*A, the FMA of
    h, du*B, the FMA of C.h), du D and the output FMA 2D; on the SFU, one exp
    per (n, d) and one per d for the softplus (`expf` is one ex2 there plus
    FMA-pipe range reduction, not counted)."""
    weights = 2 * D * (R + 2 * N) + 2 * R * D + 2 * D + 2 * N * D + 2 * D
    nbytes = 4 * (B * L * D + 2 * B * L * D + weights)
    fma_ops = 2 * B * L * (2 * D * (R + 2 * N) + 2 * R * D + D + 6 * N * D + D + 2 * D)
    sfu_ops = 2 * B * L * (N * D + D)
    times = {"hbm": nbytes / HBM_BYTES_S * 1e3, "fma": fma_ops / F32_OPS_S * 1e3,
             "sfu": sfu_ops / SFU_OPS_S * 1e3}
    unit = max(times, key=times.get)
    return times[unit], ("bytes" if unit == "hbm" else "operations"), unit


def pair_inputs(rs, B, L, D=64, N=16, R=2):
    """Synthetic K1 inputs, the distribution of the JAX package's kernel test."""
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    return (cuda(rs.rand(B, L, D) * 0.5), cuda(rs.rand(2, D, R + 2 * N) * 0.2),
            cuda(rs.rand(2, R, D) * 0.2), cuda(rs.rand(2, D) * 0.1),
            -torch.exp(cuda(rs.rand(2, N, D))), cuda(rs.rand(2, D)))


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from wavemamba_torch.ops import scan_cuda

    t0 = time.perf_counter()
    lib = scan_cuda.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.replace("ptxas info    :", "").strip()
             for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "k1_build_s": build_s, "k1_library": os.path.relpath(lib, ROOT), "ptxas": ptxas})
    return smi


def phase_k1():
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    rs = np.random.RandomState(0)
    rows = []
    cases = [("level%d" % (i + 1), h, w, False) for i, (h, w) in enumerate(LEVELS_1080P)]
    cases += [("ragged", 1, 34560 + 37, False), ("columns", 144, 240, True)]
    for name, h, w, columns in cases:
        args = pair_inputs(rs, 1, h * w)
        if columns:  # the stream SS2D scans for directions 1 and 3
            x = args[0].view(1, h, w, -1).transpose(1, 2).reshape(1, h * w, -1).contiguous()
            args = (x,) + args[1:]
        y = ss2d_scan_pair(*args)
        torch.cuda.synchronize()
        y_plain = ss2d_scan_pair_plain(*args)
        err = float((y - y_plain).abs().max())
        check(bool(torch.isfinite(y).all()), f"K1 {name}: finite")
        check(err <= K1_ATOL, f"K1 {name}: max abs err {err} <= {K1_ATOL}")
        row = {"phase": "k1", "case": name, "B": 1, "L": h * w, "D": 64, "N": 16, "R": 2,
               "max_abs_err": err, "tol": K1_ATOL, "y_max_abs": float(y_plain.abs().max())}
        if not columns and name != "ragged":
            row["ms"] = cuda_ms(lambda: ss2d_scan_pair(*args), 20)
            row["plain_ms"] = cuda_ms(lambda: ss2d_scan_pair_plain(*args), 3)
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k1_bound(1, h * w, 64, 16, 2)
        row["launches"] = ss2d_scan_pair.launches
        emit(row)
        rows.append(row)
        del y, y_plain, args
    return rows


def phase_serve(model):
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    cfg = model.cfg
    per_forward = 2 * 2 * sum(cfg.n_l_blocks)  # two pairs per SS2D, down and up halves
    check(per_forward == 28, "the shipped config scans 28 pairs per forward")
    rs = np.random.RandomState(0)
    shapes = [(1080, 1920), (1080, 1920), (720, 1280)]
    images = [(rs.rand(1, h, w, 3) * 0.12).astype(np.float32) for h, w in shapes]
    ladder = BucketLadder()
    enhance(model, images[0], ladder)  # warm-up: cuDNN plans, the allocator's pool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ss2d_scan_pair.launches = 0  # the main path's count starts here
    results = []
    for img in images:
        before = ss2d_scan_pair.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = enhance(model, img, ladder)
        end.record()
        end.synchronize()
        host_s = time.perf_counter() - t0
        results.append((img, out, start.elapsed_time(end), host_s,
                        ss2d_scan_pair.launches - before))
    launches = ss2d_scan_pair.launches  # read just after the main path
    peak = torch.cuda.max_memory_allocated()

    for (img, out, ms, host_s, n), (h, w) in zip(results, shapes):
        check(out.shape == img.shape, f"output shape {out.shape} == {img.shape}")
        check(bool(np.isfinite(out).all()), "outputs finite")
        check(float(out.mean()) > float(img.mean()), "outputs brighter than inputs")
        check(n == per_forward, f"{n} K1 launches in a forward, expected {per_forward}")
        emit({"phase": "serve", "image": [h, w], "bucket": list(ladder.shape_for(h, w)),
              "latency_ms": ms, "host_s": host_s, "k1_launches": n,
              "in_mean": float(img.mean()), "out_mean": float(out.mean())})
    check(launches == per_forward * len(images), f"{launches} K1 launches on the main path")

    x = torch.from_numpy(np.ascontiguousarray(np.pad(
        images[0], ((0, 0), (0, 72), (0, 0), (0, 0)), mode="reflect"))).cuda()
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    forward_ms = cuda_ms(lambda: wavemamba_apply(model, x), 3)
    emit({"phase": "serve", "requests": len(images), "k1_launches": launches,
          "forward_ms_1152x1920": forward_ms, "peak_memory_bytes": peak})
    return launches, x


def phase_model(model):
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.wavemamba import set_scan, wavemamba_apply
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    rs = np.random.RandomState(1)
    x = torch.from_numpy((rs.rand(1, 256, 384, 3) * 0.12).astype(np.float32)).cuda()
    y_kernel = wavemamba_apply(model, x)
    set_scan(model, ss2d_scan_pair_plain)
    try:
        y_plain = wavemamba_apply(model, x)
    finally:
        set_scan(model, ss2d_scan_pair)
    err = float((y_kernel - y_plain).abs().max())
    emit({"phase": "model", "case": "kernel_vs_plain", "image": [256, 384],
          "max_abs_err": err, "tol": MODEL_ATOL})
    check(err <= MODEL_ATOL, f"model kernel vs plain {err} <= {MODEL_ATOL}")

    small = (rs.rand(1, 64, 96, 3) * 0.12).astype(np.float32)
    cpu_model = build_network({"type": "WaveMamba"}, load_network(CKPT, device="cpu"),
                              device="cpu")
    y_cpu = wavemamba_apply(cpu_model, torch.from_numpy(small)).numpy()
    y_gpu = wavemamba_apply(model, torch.from_numpy(small).cuda()).cpu().numpy()
    err = float(np.abs(y_gpu - y_cpu).max())
    emit({"phase": "model", "case": "card_vs_cpu", "image": [64, 96],
          "max_abs_err": err, "tol": MODEL_ATOL})
    check(err <= MODEL_ATOL, f"model card vs CPU {err} <= {MODEL_ATOL}")


def phase_profile(model, x):
    """Device time by kernel over one 1152x1920 forward, and the share of the
    forward's wall time in which the card ran no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wavemamba_torch.models.wavemamba import wavemamba_apply

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        wavemamba_apply(model, x)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    k1_ms = sum(r[0] for r in rows if "chunk_scan" in r[2] or "chunk_prefix" in r[2]) / 1e3
    conv_ms = sum(r[0] for r in rows if "conv" in r[2].lower() or "xmma" in r[2]) / 1e3
    emit({"phase": "profile", "image": [1152, 1920], "wall_ms": wall_ms, "busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms, "k1_ms": k1_ms, "conv_ms": conv_ms,
          "kernels": len(rows), "launches": sum(r[1] for r in rows),
          "top": [{"us": us, "calls": n, "name": name[:90]} for us, n, name in rows[:20]]})


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.models import build_network

    set_parity_mode()
    smi = phase_device()
    k1_rows = phase_k1()
    t0 = time.perf_counter()
    model = build_network({"type": "WaveMamba"}, load_network(CKPT, device="cuda"), device="cuda")
    emit({"phase": "load", "checkpoint": os.path.relpath(CKPT, ROOT),
          "load_s": time.perf_counter() - t0})
    launches, x1080 = phase_serve(model)
    phase_model(model)
    phase_profile(model, x1080)

    level1 = k1_rows[0]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "ss2d_scan_pair (K1)", "route": "cuda", "source": "wavemamba_torch/csrc/ss2d_scan.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:705", "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows), "ms": level1["ms"],
        "plain_ms": level1["plain_ms"], "bound_ms": level1["bound_ms"],
        "bound_by": level1["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
