#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`wavemamba_torch`) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds every
kernel of the port from `wavemamba_torch/csrc/`, holds each against its
plain PyTorch version on the card, serves the shipped model, trains a fresh
one at full width, drives the yml pipelines' path with `scan_impl: pallas`,
and prints one JSON line per phase:

  1. device  the card (nvidia-smi), torch and CUDA versions, the kernel builds.
  2. k1      kernel K1 (`ss2d_scan_pair`) against `ss2d_scan_pair_plain` at
             the three scan lengths of a 1080p forward, on a ragged length
             and on a column (transposed) token stream; times and bounds.
  3. k2      kernel K2 (`ss2d_scan_pair_bwd`, K1's backward) against
             `ss2d_scan_pair_plain_bwd` at the training shapes, on a ragged
             length and on a column stream, all six outputs and K1's carries;
             times at the three training lengths and bounds.
  3b. k3     kernel K3 (`selective_scan_cuda`, the unfused scan of
             `scan_impl: pallas`) against `selective_scan_plain` at the route's
             shapes: the three scan lengths of a 1080p forward, the three of a
             batch-8 512x512 step, a ragged length; times and bounds.
  3c. k4     kernel K4 (`selective_scan_cuda_bwd`, K3's backward) against
             `selective_scan_plain_bwd` at the three training shapes and the
             ragged one, all seven outputs, the same bits twice; times, bounds.
  3d. k5     kernel K5 (`ss2d_scan_pair(..., variant='ssd')`, K1's function in
             the segment-local form) against its plain version and against K1,
             y and carries, at the three scan lengths of a 1080p forward, a
             ragged length and a column stream, the same bits twice; times and
             bounds.
  3e. chain  the conv-chain kernel (`csrc/conv_chain.cu`) from both entry
             points, K6 (`fused_chain`, 2-D tiles) and K7 (`fused_chain_band`,
             row bands), against `fused_chain_plain`, for each of the nine
             wrappers with the shipped checkpoint's modules at the 1080p shape
             where each runs and at 17x130, the same bits twice and from both
             entry points; times beside the bound, the plain version, the stock
             modules the chain replaces and, for a single conv, `F.conv2d`.
  4. serve   `ckpt/WaveMamba_ProcLLIE_BSRGAN_XXL4.pth` through the CLI's
             load -> bucket pad -> forward -> crop path, two seeded
             low-light requests (1080x1920, 720x1280); launches of K1,
             latency, peak memory, outputs finite and brighter.
  4b. serve_fused the same requests with `conv_impl: fused`: 76 K7 launches
             and 28 K1 a forward, latency, forward time, peak memory; the output
             against the same model with plain chains on the card and against
             the stock float32 route; one forward through K6 (`chain_route`).
  4c. tile   a 2160x3840 request through `--tile`'s path at 240 / 16: tiles,
             forwards, latency, peak memory, and its difference from the
             whole-frame forward.
  5. model   the full model with K1 against the same model with the plain
             scan at 256x384, the card against the CPU at 64x96, and the
             unfused route: K3 against the plain scan, and against K1.
  6. grad    loss and every parameter's gradient at 128x128, batch 2, with
             K1 + K2 against the same model with the plain scan and the
             plain backward; the same for K3 + K4 on the unfused route.
  7. train   a seeded fresh model, the settings of
             `options/train_wavemamba_uhdll.yml` (AdamW, cosine schedule, L1 +
             0.1 FFT, batch 8 of 512x512, float32), one warm-up step and six
             steps on a seeded synthetic batch: launches of K1 and K2 per
             step, ms per step, images/s, peak memory, the loss falls, EMA
             and lr follow their formulas.
  8. resume  the training state saved after step 3, restored into a fresh
             trainer, takes step 4 again: the same loss and parameters.
  9. pipeline the path of `python -m wavemamba_torch.pipelines.train` with
             `network_g.scan_impl: pallas`, from an options dict as a yml parses
             to (this script needs no PyYAML): `build_model` -> a seeded
             in-memory dataset of uint8 pairs -> `EnlargedSampler` ->
             `ThreadedLoader` -> `device_prefetch` -> `optimize_parameters`,
             one warm-up step and four steps at batch 8 of 512x512;
             `validation` on two pairs with psnr/ssim and best tracking;
             `save`, `resume` into a fresh `RestorationModel` and one more
             step that repeats; one 1080x1920 request through
             `RestorationModel.test`. 14 K3 and 14 K4 launches a step, no K1/K2.
 10. profile device time by kernel (torch.profiler) over one 1152x1920
             forward of each conv route, one training step of the fused scan
             route and one of the unfused route, and the card's idle share.

Then the `kernels` line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero without the last line. It needs
one card and exits non-zero where CUDA is missing. `--remat` trains with
block recompute, to measure it; the step fits an 80 GB card without.
"""

from __future__ import annotations

import argparse
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
# K2 against its plain version: max abs difference over each output's max abs
# value. Both follow the same arithmetic in f32; the sums over tokens and
# batch (up to 524,288 terms) are taken in another order.
K2_RTOL = 1e-5
# Loss and gradients of the whole model, K1 + K2 against plain scan + plain
# backward, both on the card: the loss relative, each gradient by its max abs
# difference over the gradient's max abs value (cuDNN's and cuBLAS's backward
# sums are the same on both sides; the scans differ as above).
GRAD_LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
# A restored trainer against the one that went on: cuDNN's weight gradients
# and the gather's backward add with atomics, so a step is not bitwise
# repeatable; Adam divides by sqrt(v), which can turn a last-bit difference in
# a near-zero gradient into a small fraction of lr = 5e-4. A restore that lost
# the moments or the EMA would move a parameter by a whole update, 5e-4. The
# parameters and the EMA by their max abs difference, Adam's two moments by
# theirs over the moment's max abs value.
RESUME_LOSS_RTOL = 1e-5
RESUME_ATOL = 1e-5
RESUME_MOMENT_RTOL = 1e-4
# K3 against its plain version: max abs difference on the synthetic inputs
# below (|y| up to ~10); the chunk prefix sums in another order than the plain
# version's log-depth scan. K4: each output's max abs difference over its max
# abs value, as K2; the sums over tokens and batch (up to 524,288 terms per
# direction) are taken in another order.
K3_ATOL = 1e-4
K4_RTOL = 1e-5
# K5 against its plain version and against K1: max abs difference, as K1's
# (the same inputs; the segment-local form sums in another order again).
K5_ATOL = 1e-4
# The chain kernel against its plain version, of each output's max abs value.
# Both round the same operands to bf16 and sum in f32, in other orders. Where
# a last-bit difference of an f32 stage (LayerNorm, GELU, the depthwise sum)
# moves a value across a bf16 rounding boundary ahead of a 1x1 or dense 3x3,
# one product moves by a bf16 step: 1e-5 on at least 99.5% of the elements,
# 1e-2 on every one.
CHAIN_TIGHT_REL, CHAIN_TIGHT_SHARE, CHAIN_LOOSE_REL = 1e-5, 0.995, 1e-2
# The fused-route model, chain kernels against plain chains on the card: the
# same rounding flips, spread over the image by the scans. Max and mean abs.
FUSED_MODEL_ATOL, FUSED_MODEL_MEAN = 5e-3, 5e-4
# The fused route against the stock float32 route on the same weights: bf16
# operands and the tanh GELU. Max abs and the PSNR between the two outputs.
FUSED_VS_STOCK_ATOL, FUSED_VS_STOCK_PSNR = 1e-2, 55.0
# Dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet): the chains'
# bf16 products could run there.
TENSOR_BF16_OPS_S = 989e12
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, EMA_DECAY = 8, 512, 6, 0.999
PIPELINE_STEPS = 4
TRAIN_LENGTHS = [65536, 16384, 4096]  # tokens per image at the three LFSS levels of 512x512
SCHEDULER = {"type": "CosineAnnealingRestartCyclicLR", "periods": [100, 100000],
             "restart_weights": [1, 1], "eta_mins": [0.0005, 0.0000001]}
LEVELS_1080P = [(576, 960), (288, 480), (144, 240)]  # token grid of each LFSS level


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps, warmup=True):
    """Median device time of `fn` in ms over `reps` runs, after one warm-up
    unless `warmup` is off (for the plain versions, which take seconds)."""
    if warmup:
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


def _bound(nbytes, fma_ops, sfu_ops, tensor_ops=0):
    """(ms, "bytes" or "operations", unit) of the slowest of the units."""
    times = {"hbm": nbytes / HBM_BYTES_S * 1e3, "fma": fma_ops / F32_OPS_S * 1e3,
             "sfu": sfu_ops / SFU_OPS_S * 1e3, "tensor": tensor_ops / TENSOR_BF16_OPS_S * 1e3}
    unit = max(times, key=times.get)
    return times[unit], ("bytes" if unit == "hbm" else "operations"), unit


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
    return _bound(nbytes, fma_ops, sfu_ops)


def k5_bound(B, L, D, N, R):
    """Least time (ms) the card could take for one K5 call; as `k1_bound`, the
    same bytes. Per (token, direction), each computed once: on the FMA pipe the
    projection 2D(R+2N), dt 2RD, log1p of the softplus D, the segment sum of da
    D, per (n, d) 8 (cl*A, w*B, the divide's refinement 2, the cumsum, H +
    cums, G times it, the FMA of C.h counted once), du D and the output FMA 2D;
    on the SFU one exp and one reciprocal (inside the divide) per (n, d) and
    one exp per d for the softplus."""
    weights = 2 * D * (R + 2 * N) + 2 * R * D + 2 * D + 2 * N * D + 2 * D
    nbytes = 4 * (B * L * D + 2 * B * L * D + weights)
    fma_ops = 2 * B * L * (2 * D * (R + 2 * N) + 2 * R * D + 2 * D + 8 * N * D + D + 2 * D)
    sfu_ops = 2 * B * L * (2 * N * D + D)
    return _bound(nbytes, fma_ops, sfu_ops)


def chain_bound(c0, specs, pixels):
    """Least time (ms) the card could take for one chain over `pixels` pixels
    of one image, and what bounds it. Bytes: the input read once, the output
    written once, the weights read once. Per pixel: the bf16 products of the
    1x1, dense 3x3 and gate stages (2 per multiply-add) on the tensor cores;
    on the FMA pipe the depthwise taps (2 each), a bias 1, LayerNorm 6, the
    tanh GELU 8 and silu / sigmoid 3 per element, the gate 3, the residual 2;
    on the SFU a tanh per GELU, an exp and a reciprocal per silu or sigmoid,
    a reciprocal square root per LayerNorm."""
    weights = sum(t.numel() for s in specs for t in s[4:6] if t is not None)
    nbytes = 4 * (pixels * (c0 + specs[-1][2]) + weights)
    tensor, fma, sfu = 0, 0, 0
    for kind, cin, cout, act, w, b, eps in specs:
        fma += cout if b is not None and kind != "ln" else 0
        if kind in ("pw", "mulsig0"):
            tensor += 2 * cin * cout
        if kind == "dense":
            tensor += 18 * cin * cout
        if kind == "dw":
            fma += 18 * cin
        if kind in ("act", "glu"):
            fma += (8 if act == "gelu" else 3) * cout + (cout if kind == "glu" else 0)
            sfu += (1 if act == "gelu" else 2) * cout
        if kind == "mulsig0":
            fma, sfu = fma + 3 * cout, sfu + 2 * cout
        if kind == "ln":
            fma, sfu = fma + 6 * cin, sfu + 1
        if kind == "res0":
            fma += 2 * cin
    return _bound(nbytes, fma * pixels, sfu * pixels, tensor * pixels)


def k2_bound(B, L, D, N, R, T=64):
    """Least time (ms) the card could take for one K2 call; as `k1_bound`.

    Bytes: x and dy read once, dx written once, the chunk-entry states and
    chunk decays read once, the weights read and their gradients written.
    Per (token, direction), each computed once: on the FMA pipe, the
    projection 2DJ (J = R+2N) and dt 2RD; per (n, d) the state's recompute 4
    (da*A, the FMA of h, du*B) and the adjoint 13 (g, a*g, g*da*u, common,
    g.B, dda, dA); the sums over channels for dB and dC 3ND; the projection
    backward 2RD + 2DJ, the weight sums 2DJ + 2RD, and some 10 D for the
    softplus, the sigmoid's divide, dz, du and the small sums. On the SFU one
    exp per (n, d) and three per d (softplus, sigmoid, its reciprocal)."""
    J = R + 2 * N
    nc = -(-L // T)
    weights = 2 * D * J + 2 * R * D + 2 * D + 2 * N * D + 2 * D
    nbytes = 4 * (B * L * D * (1 + 2 + 1) + B * 2 * nc * (N * D + D) + 2 * weights)
    fma_ops = 2 * B * L * (3 * 2 * D * J + 3 * 2 * R * D + (4 + 13 + 3) * N * D + 10 * D)
    sfu_ops = 2 * B * L * (N * D + 3 * D)
    return _bound(nbytes, fma_ops, sfu_ops)


def k3_bound(B, K, L, D, N):
    """Least time (ms) the card could take for one K3 call; as `k1_bound`.

    Bytes: u, delta, Bs, Cs read once, y written once, the weights read once.
    Per (token, stream), each computed once: on the FMA pipe log1p of the
    softplus D, the recurrence 6 per (n, d), du D and the output FMA 2D; on the
    SFU one exp per (n, d) and one per d for the softplus."""
    weights = K * (D * N + 2 * D)
    nbytes = 4 * (B * K * L * (3 * D + 2 * N) + weights)
    return _bound(nbytes, B * K * L * (6 * N * D + 4 * D), B * K * L * (N * D + D))


def k4_bound(B, K, L, D, N, T=64):
    """Least time (ms) the card could take for one K4 call; as `k2_bound`.

    Bytes: u, delta, dy, Bs, Cs read once, du, ddelta, dB, dC written once,
    the chunk-entry states and chunk sums of da read once, the weights read
    and their gradients written. Per (token, stream) and (n, d), on the FMA
    pipe: the state's recompute 4, the adjoint 13, the sums over channels for
    dB and dC 3, and some 10 D for the softplus, the sigmoid's divide, ddelta,
    du and the small sums; on the SFU one exp per (n, d) and three per d."""
    nc = -(-L // T)
    weights = K * (D * N + 2 * D)
    nbytes = 4 * (B * K * L * (5 * D + 4 * N) + B * K * nc * (N * D + D) + 2 * weights)
    return _bound(nbytes, B * K * L * (20 * N * D + 10 * D), B * K * L * (N * D + 3 * D))


def scan_inputs(rs, B, L, K=4, D=64, N=16):
    """Synthetic K3 inputs at the unfused route's layouts: da around 0.1-1, as
    the dt projection gives, B and C of the projections' size."""
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
    return (cuda(rs.rand(B, K, L, D) * 0.5), cuda(rs.randn(B, K, L, D) * 0.5 - 1.0),
            -torch.exp(cuda(rs.rand(K, D, N))), cuda(rs.randn(B, K, L, N) * 0.5),
            cuda(rs.randn(B, K, L, N) * 0.5), cuda(rs.rand(K, D)), cuda(rs.rand(K, D) * 0.1))


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
    libs = scan_cuda.build_all()  # one nvcc per source, started together
    build_s = time.perf_counter() - t0

    def ptxas(lib, kernels):
        """Registers and spills of each kernel of the build, as `-Xptxas -v`
        reports them; of a templated kernel, the shipped dt_rank's (<16, 2>)."""
        lines = lib.with_suffix(".log").read_text().splitlines()
        out = []
        for i, ln in enumerate(lines):
            name = next((k for k in kernels if k in ln), None)
            if "Compiling entry function" in ln and name and (
                    "ILi16ELi" not in ln or "ILi16ELi2E" in ln):
                out.append(name + ": " + ", ".join(
                    x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4]))
        return out

    emit({"phase": "device", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "libraries": [os.path.relpath(lib, ROOT) for lib in libs],
          "k1_ptxas": ptxas(libs[0], ["chunk_scan", "chunk_prefix"]),
          "k2_ptxas": ptxas(libs[1], ["bwd_local", "bwd_prefix", "bwd_main", "bwd_reduce"]),
          "k3_ptxas": ptxas(libs[2], ["scan_chunk", "chunk_prefix"]),
          "k4_ptxas": ptxas(libs[3], ["bwd_local", "chunk_prefix", "bwd_main", "bwd_reduce"]),
          "k5_ptxas": ptxas(libs[4], ["chunk_scan_ssd", "chunk_prefix"]),
          "chain_ptxas": ptxas(libs[5], ["chain_kernel"])})
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
            row["plain_ms"] = cuda_ms(lambda: ss2d_scan_pair_plain(*args), 1, warmup=False)
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k1_bound(1, h * w, 64, 16, 2)
        row["launches"] = ss2d_scan_pair.launches
        emit(row)
        rows.append(row)
        del y, y_plain, args
    return rows


OUTPUTS = ("dx", "dwx", "ddtw", "dbias", "dA", "ddsk")


def phase_k2():
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain, ss2d_scan_pair_plain_bwd
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd

    rs = np.random.RandomState(2)
    rows = []
    # The three LFSS levels of a training step at batch 8 of 512x512 (level 1
    # first, as TRAIN_LENGTHS), then a ragged length and a column stream.
    cases = [("level1", TRAIN_BATCH, 256, 256, False), ("level2", TRAIN_BATCH, 128, 128, False),
             ("level3", TRAIN_BATCH, 64, 64, False), ("ragged", 1, 1, 1000, False),
             ("columns", 1, 48, 80, True)]
    check([h * w for _, _, h, w, _ in cases[:3]] == TRAIN_LENGTHS, "the k2 cases are the training lengths")
    for name, B, h, w, columns in cases:
        L = h * w
        args = pair_inputs(rs, B, L)
        if columns:
            x = args[0].view(B, h, w, -1).transpose(1, 2).reshape(B, L, -1).contiguous()
            args = (x,) + args[1:]
        dy = torch.from_numpy(rs.randn(B, 2, L, 64).astype(np.float32)).cuda()
        y, state, sumda = ss2d_scan_pair(*args, return_carries=True)
        got = ss2d_scan_pair_bwd(*args, state, sumda, dy)
        again = ss2d_scan_pair_bwd(*args, state, sumda, dy)
        torch.cuda.synchronize()
        y_plain, state_plain, sumda_plain = ss2d_scan_pair_plain(*args, return_carries=True)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ss2d_scan_pair_plain_bwd(*args, state_plain, dy)
        end.record()
        end.synchronize()
        # K1 at this batch: y and what it hands to K2.
        fwd_err = {"y": float((y - y_plain).abs().max()),
                   "state": float((state - state_plain).abs().max()),
                   "sumda": float((sumda - sumda_plain).abs().max())}
        check(max(fwd_err.values()) <= K1_ATOL, f"K1 {name} B={B}: y and carries {fwd_err}")
        row = {"phase": "k2", "case": name, "B": B, "L": L, "D": 64, "N": 16, "R": 2,
               "tol_rel": K2_RTOL, "k1": fwd_err, "max_abs_err": {}, "max_rel_err": {}}
        for key, g, g2, w_ in zip(OUTPUTS, got, again, want):
            check(g.shape == w_.shape and bool(torch.isfinite(g).all()), f"K2 {name} {key}: finite")
            check(torch.equal(g, g2), f"K2 {name} {key}: the same bits on a second run")
            err = float((g - w_).abs().max())
            row["max_abs_err"][key] = err
            row["max_rel_err"][key] = err / float(w_.abs().max())
            check(row["max_rel_err"][key] <= K2_RTOL,
                  f"K2 {name} {key}: max rel err {row['max_rel_err'][key]} <= {K2_RTOL}")
        del got, again, y, y_plain, state_plain, sumda_plain, want
        if B == TRAIN_BATCH:  # one call of a training step at this LFSS level
            row["ms"] = cuda_ms(lambda: ss2d_scan_pair_bwd(*args, state, sumda, dy), 10)
            row["k1_ms"] = cuda_ms(lambda: ss2d_scan_pair(*args), 10)
            row["plain_ms"] = start.elapsed_time(end)  # the one run compared above
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k2_bound(B, L, 64, 16, 2)
            row["k1_bound_ms"] = k1_bound(B, L, 64, 16, 2)[0]
        row["launches"] = ss2d_scan_pair_bwd.launches
        emit(row)
        rows.append(row)
        del state, sumda, args, dy
    return rows


def timed_once(fn):
    """(result, device ms) of one run of `fn`: for the plain versions."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


SCAN_OUTPUTS = ("du", "ddelta", "dA", "dBs", "dCs", "dD_skip", "ddelta_bias")


def phase_k3_k4():
    """K3 and K4 at the shapes the unfused route gives them: one call scans
    all four directions of an SS2D block. The training shapes also go through
    K4, on the carries K3 left."""
    from wavemamba_torch.ops.scan import selective_scan_plain, selective_scan_plain_bwd
    from wavemamba_torch.ops.scan_cuda import selective_scan_cuda, selective_scan_cuda_bwd

    rs = np.random.RandomState(4)
    cases = [("serve_level%d" % (i + 1), 1, h * w, False) for i, (h, w) in enumerate(LEVELS_1080P)]
    cases += [("train_level%d" % (i + 1), TRAIN_BATCH, L, True) for i, L in enumerate(TRAIN_LENGTHS)]
    cases += [("ragged", 1, 1000, True)]
    k3_rows, k4_rows = [], []
    for name, B, L, backward in cases:
        args = scan_inputs(rs, B, L)
        y, state, sumda = selective_scan_cuda(*args, return_carries=True)
        torch.cuda.synchronize()
        (y_plain, state_plain, sumda_plain), plain_ms = timed_once(
            lambda: selective_scan_plain(*args, return_carries=True))
        err = {"y": float((y - y_plain).abs().max()), "state": float((state - state_plain).abs().max()),
               "sumda": float((sumda - sumda_plain).abs().max())}
        check(bool(torch.isfinite(y).all()), f"K3 {name}: finite")
        check(max(err.values()) <= K3_ATOL, f"K3 {name}: y and carries {err} <= {K3_ATOL}")
        row = {"phase": "k3", "case": name, "B": B, "K": 4, "L": L, "D": 64, "N": 16,
               "max_abs_err": err["y"], "carries_err": err, "tol": K3_ATOL,
               "y_max_abs": float(y_plain.abs().max())}
        del y, y_plain, sumda_plain
        if name != "ragged":
            row["ms"] = cuda_ms(lambda: selective_scan_cuda(*args), 10)
            row["plain_ms"] = plain_ms
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k3_bound(B, 4, L, 64, 16)
        row["launches"] = selective_scan_cuda.launches
        emit(row)
        k3_rows.append(row)
        if backward:
            dy = torch.from_numpy(rs.randn(B, 4, L, 64).astype(np.float32)).cuda()
            got = selective_scan_cuda_bwd(*args, state, sumda, dy)
            again = selective_scan_cuda_bwd(*args, state, sumda, dy)
            torch.cuda.synchronize()
            want, plain_ms = timed_once(lambda: selective_scan_plain_bwd(*args, state_plain, dy))
            row = {"phase": "k4", "case": name, "B": B, "K": 4, "L": L, "D": 64, "N": 16,
                   "tol_rel": K4_RTOL, "max_abs_err": {}, "max_rel_err": {}}
            for key, g, g2, w_ in zip(SCAN_OUTPUTS, got, again, want):
                check(g.shape == w_.shape and bool(torch.isfinite(g).all()), f"K4 {name} {key}: finite")
                check(torch.equal(g, g2), f"K4 {name} {key}: the same bits on a second run")
                e = float((g - w_).abs().max())
                row["max_abs_err"][key] = e
                row["max_rel_err"][key] = e / float(w_.abs().max())
                check(row["max_rel_err"][key] <= K4_RTOL,
                      f"K4 {name} {key}: max rel err {row['max_rel_err'][key]} <= {K4_RTOL}")
            del got, again, want
            if name != "ragged":
                row["ms"] = cuda_ms(lambda: selective_scan_cuda_bwd(*args, state, sumda, dy), 10)
                row["plain_ms"] = plain_ms
                row["bound_ms"], row["bound_by"], row["bound_unit"] = k4_bound(B, 4, L, 64, 16)
            row["launches"] = selective_scan_cuda_bwd.launches
            emit(row)
            k4_rows.append(row)
            del dy
        del args, state, sumda, state_plain
        torch.cuda.empty_cache()
    return k3_rows, k4_rows


def phase_k5():
    """K5 at K1's shapes: against its plain version (y, carries; the level-1
    plain run, timed, is the one compared) and against K1 on the same inputs."""
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_ssd

    rs = np.random.RandomState(5)
    rows = []
    ss2d_scan_pair_ssd.launches = 0
    cases = [("level%d" % (i + 1), h, w, False) for i, (h, w) in enumerate(LEVELS_1080P)]
    cases += [("ragged", 1, 34560 + 37, False), ("columns", 144, 240, True)]
    for name, h, w, columns in cases:
        args = pair_inputs(rs, 1, h * w)
        if columns:
            x = args[0].view(1, h, w, -1).transpose(1, 2).reshape(1, h * w, -1).contiguous()
            args = (x,) + args[1:]
        got = ss2d_scan_pair(*args, variant="ssd", return_carries=True)
        again = ss2d_scan_pair(*args, variant="ssd", return_carries=True)
        k1 = ss2d_scan_pair(*args, return_carries=True)
        torch.cuda.synchronize()
        plain, plain_ms = timed_once(lambda: ss2d_scan_pair_plain(*args, return_carries=True,
                                                                  variant="ssd", sub=8))
        keys = ("y", "state", "sumda")
        err = {k: float((g - p_).abs().max()) for k, g, p_ in zip(keys, got, plain)}
        vs_k1 = {k: float((g - p_).abs().max()) for k, g, p_ in zip(keys, got, k1)}
        check(all(bool(torch.isfinite(g).all()) for g in got), f"K5 {name}: finite")
        check(all(torch.equal(g, g2) for g, g2 in zip(got, again)), f"K5 {name}: the same bits twice")
        check(max(err.values()) <= K5_ATOL, f"K5 {name}: against its plain version {err}")
        check(max(vs_k1.values()) <= K5_ATOL, f"K5 {name}: against K1 {vs_k1}")
        row = {"phase": "k5", "case": name, "B": 1, "L": h * w, "D": 64, "N": 16, "R": 2, "sub": 8,
               "max_abs_err": err["y"], "carries_err": err, "vs_k1_err": vs_k1, "tol": K5_ATOL,
               "y_max_abs": float(plain[0].abs().max())}
        if name == "level1":  # the one plain run timed, as K1's
            row["plain_ms"] = plain_ms
        if not columns and name != "ragged":
            row["ms"] = cuda_ms(lambda: ss2d_scan_pair(*args, variant="ssd"), 20)
            row["k1_ms"] = cuda_ms(lambda: ss2d_scan_pair(*args), 20)
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k5_bound(1, h * w, 64, 16, 2)
            row["k1_bound_ms"] = k1_bound(1, h * w, 64, 16, 2)[0]
        row["launches"] = ss2d_scan_pair_ssd.launches
        emit(row)
        rows.append(row)
        del got, again, k1, plain, args
    return rows


def chain_stages(call, x):
    """The stage list a chain wrapper hands to `_run`, without running it."""
    from wavemamba_torch.experimental import conv_fused as cf

    real = cf._run
    cf._run = lambda x_, stages, *rest: stages
    try:
        return call(x)
    finally:
        cf._run = real


def chain_cases(stock):
    """(wrapper, call, stock call, input channels, (H, W) at 1080p) for the
    nine wrappers, with the shipped checkpoint's modules (`stock`: the model
    with stock convs); the Restormer FFN, which the shipped model lacks, from a
    seeded init. Shapes: where each runs in a 1080p forward, level 1 for the
    LFSS / HFE chains."""
    import torch.nn.functional as F

    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.models.wavemamba import FeedForwardRestormer
    from wavemamba_torch.ops.nn import init_conv2d

    net = stock.restoration_network
    d1, u1 = net.down_group1, net.up_group1
    lfss, hfe = d1.l_blk[0], d1.h_blk[0]
    rest = FeedForwardRestormer(32)
    gen = torch.Generator().manual_seed(41)
    for m in rest.modules():
        if isinstance(m, torch.nn.Conv2d):
            init_conv2d(m, gen)
    rest = rest.cuda().eval()
    full, level1 = (1152, 1920), LEVELS_1080P[0]
    pac = hfe.attn.matching_transformation.paconv
    return [
        ("dense3x3 conv_01", lambda x: cf.dense3x3(net.conv_01, x), net.conv_01, 3, full),
        ("dense3x3 last", lambda x: cf.dense3x3(net.last, x), net.last, 32, full),
        ("dense3x3 l_conv", lambda x: cf.dense3x3(d1.l_conv, x), d1.l_conv, 64, level1),
        ("dense3x3 h_out_conv", lambda x: cf.dense3x3(u1.h_out_conv, x), u1.h_out_conv, 32, level1),
        ("dw_act", lambda x: cf.dw_act(lfss.self_attention.conv2d, x),
         lambda x: F.silu(lfss.self_attention.conv2d(x)), 64, level1),
        ("lfss_ffn_block", lambda x: cf.lfss_ffn_block(lfss.ln_2, lfss.conv_blk, lfss.skip_scale2, x),
         lambda x: x * lfss.skip_scale2.view(1, -1, 1, 1) + lfss.conv_blk(lfss.ln_2(x)), 32, level1),
        ("qkv_chain", lambda x: cf.qkv_chain(hfe.attn, x, ln=hfe.norm1),
         lambda x: hfe.attn.qkv_dwconv(hfe.attn.qkv(hfe.norm1(x))), 32, level1),
        ("paconv_chain", lambda x: cf.paconv_chain(pac, x), pac, 64, level1),
        ("ff_in_chain", lambda x: cf.ff_in_chain(hfe.ffn.project_in, x, ln=hfe.norm2),
         lambda x: hfe.ffn.project_in(hfe.norm2(x)), 32, level1),
        ("ff_out_chain", lambda x: cf.ff_out_chain(hfe.ffn.project_out, x), hfe.ffn.project_out,
         32, level1),
        ("ffn_chain", lambda x: cf.ffn_chain(lfss.conv_blk, x), lfss.conv_blk, 32, level1),
        ("restormer_chain", lambda x: cf.restormer_chain(rest, x, ln=hfe.norm2, residual=True),
         lambda x: x + rest(hfe.norm2(x)), 32, level1),
    ]


def chain_errors(got, want):
    """Max abs and max relative difference and the share of elements beyond
    the tight bound, of `want`'s max abs value."""
    d = (got - want).abs()
    scale = float(want.abs().max())
    return {"max_abs_err": float(d.max()), "max_rel_err": float(d.max()) / scale,
            "share_beyond_tight": float((d > CHAIN_TIGHT_REL * scale).float().mean())}


def check_chain(name, err):
    check(1.0 - err["share_beyond_tight"] >= CHAIN_TIGHT_SHARE,
          f"{name}: {err['share_beyond_tight']} of the elements beyond {CHAIN_TIGHT_REL} of the max")
    check(err["max_rel_err"] <= CHAIN_LOOSE_REL, f"{name}: max rel err {err['max_rel_err']}")


@torch.no_grad()
def phase_chain(stock, per_forward):
    """The chain kernel from both entry points against the plain version, for
    every wrapper; `per_forward`: each wrapper's launches in a forward of the
    serve path (`serve_fused`)."""
    import torch.nn.functional as F

    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.ops.conv_fused_cuda import chain_plan

    rs = np.random.RandomState(6)
    rows = []
    for name, call, stock_call, c, (h, w) in chain_cases(stock):
        wrapper = name.split()[0]
        row = {"phase": "chain", "chain": name, "shape": [1, c, h, w],
               "launches_per_forward": per_forward.get(wrapper, 0)}
        for shape in ((h, w), (17, 130)):  # the 1080p shape, then an odd one for the borders
            x = torch.from_numpy((rs.randn(1, c, *shape) * 0.5).astype(np.float32)).cuda()
            stages = chain_stages(call, x)
            specs = cf._specs(c, stages)
            band = cf.fused_chain_band(x, stages)
            band2 = cf.fused_chain_band(x, stages)
            tile = cf.fused_chain(x, stages)
            tile2 = cf.fused_chain(x, stages)
            torch.cuda.synchronize()
            plain, plain_ms = timed_once(lambda: cf.fused_chain_plain(x, stages))
            check(bool(torch.isfinite(band).all()), f"{name} {shape}: finite")
            check(torch.equal(band, band2) and torch.equal(tile, tile2),
                  f"{name} {shape}: the same bits twice")
            check(torch.equal(band, tile), f"{name} {shape}: K7 and K6 compute the same bits")
            err = chain_errors(band, plain)
            check_chain(f"{name} {shape}", err)
            key = "odd" if shape == (17, 130) else "main"
            row[key] = err
            if key == "main":
                row["tile_K7"], row["smem_K7"] = chain_plan(c, specs, 16, w)
                row["tile_K6"], row["smem_K6"] = chain_plan(c, specs, 8, 128)
                row["ms"] = cuda_ms(lambda: cf.fused_chain_band(x, stages), 10)
                row["k6_ms"] = cuda_ms(lambda: cf.fused_chain(x, stages), 10)
                row["plain_ms"] = plain_ms
                row["stock_ms"] = cuda_ms(lambda: stock_call(x), 10)
                row["library_ms"] = None
                if wrapper == "dense3x3":  # one library call computes a single conv
                    conv = stages[0]
                    row["library_ms"] = cuda_ms(lambda: F.conv2d(x, conv[1], conv[2], padding=1), 10)
                row["bound_ms"], row["bound_by"], row["bound_unit"] = chain_bound(c, specs, h * w)
            del band, band2, tile, tile2, plain, x
        emit(row)
        rows.append(row)
    return rows


def phase_serve_fused(fused, stock):
    """The serve path of `phase_serve` with `conv_impl: fused`; then the same
    frame through plain chains, through the stock route, and through K6."""
    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    chains = 2 * sum(fused.cfg.n_l_blocks) * 2 + 2 * sum(fused.cfg.n_h_blocks) * 5 + 8
    check(chains == 76, "the shipped config runs 76 chains a forward")
    rs = np.random.RandomState(0)
    shapes = [(1080, 1920), (720, 1280)]
    images = [(rs.rand(1, h, w, 3) * 0.12).astype(np.float32) for h, w in shapes]
    ladder = BucketLadder()
    enhance(fused, images[0], ladder)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counts = lambda: (cf.fused_chain_band.launches, cf.fused_chain.launches, ss2d_scan_pair.launches)
    cf.fused_chain_band.launches = cf.fused_chain.launches = ss2d_scan_pair.launches = 0  # the main path
    results = []
    for img in images:
        before = counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = enhance(fused, img, ladder)
        end.record()
        end.synchronize()
        results.append((img, out, start.elapsed_time(end), time.perf_counter() - t0,
                        tuple(a - b for a, b in zip(counts(), before))))
    launches = counts()  # read just after the main path
    peak = torch.cuda.max_memory_allocated()
    for (img, out, ms, host_s, n), (h, w) in zip(results, shapes):
        check(out.shape == img.shape and bool(np.isfinite(out).all()), "outputs finite")
        check(float(out.mean()) > float(img.mean()), "outputs brighter than inputs")
        check(n == (chains, 0, 28), f"{n} K7 / K6 / K1 launches in a forward, expected ({chains}, 0, 28)")
        emit({"phase": "serve_fused", "image": [h, w], "bucket": list(ladder.shape_for(h, w)),
              "latency_ms": ms, "host_s": host_s, "k7_launches": n[0], "k1_launches": n[2]})

    x = torch.from_numpy(np.ascontiguousarray(np.pad(
        images[0], ((0, 0), (0, 72), (0, 0), (0, 0)), mode="reflect"))).cuda()
    forward_ms = cuda_ms(lambda: wavemamba_apply(fused, x), 3)
    y = wavemamba_apply(fused, x)
    with cf.chain_route("plain"):
        y_plain = wavemamba_apply(fused, x)
    y_stock = wavemamba_apply(stock, x)
    before = cf.fused_chain.launches
    with cf.chain_route("tile"):
        y_tile = wavemamba_apply(fused, x)
    k6_launches = cf.fused_chain.launches - before

    # Each wrapper's calls in one forward.
    per_forward = {}
    names = ("dw_act", "lfss_ffn_block", "qkv_chain", "paconv_chain", "ff_in_chain", "ff_out_chain",
             "dense3x3", "ffn_chain", "restormer_chain")
    real = {n: getattr(cf, n) for n in names}
    for n in names:
        setattr(cf, n, lambda *a, _n=n, **k: per_forward.__setitem__(_n, per_forward.get(_n, 0) + 1)
                or real[_n](*a, **k))
    try:
        wavemamba_apply(fused, x)
    finally:
        for n in names:
            setattr(cf, n, real[n])

    d = (y - y_plain).abs()
    ds = (y - y_stock).abs()
    psnr = float(10 * torch.log10(1.0 / (ds ** 2).mean()))
    row = {"phase": "serve_fused", "requests": len(images), "k7_launches": launches[0],
           "k6_launches": launches[1], "k1_launches": launches[2],
           "forward_ms_1152x1920": forward_ms, "peak_memory_bytes": peak,
           "kernel_vs_plain_chains": {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                                      "tol_max": FUSED_MODEL_ATOL, "tol_mean": FUSED_MODEL_MEAN},
           "fused_vs_stock": {"max_abs_err": float(ds.max()), "mean_abs_err": float(ds.mean()),
                              "psnr_db": psnr, "tol_max": FUSED_VS_STOCK_ATOL,
                              "tol_psnr_db": FUSED_VS_STOCK_PSNR},
           "k6_route": {"launches": k6_launches, "same_bits_as_k7": bool(torch.equal(y, y_tile))},
           "per_forward": per_forward}
    emit(row)
    check(launches == (chains * len(images), 0, 28 * len(images)), f"{launches} launches on the main path")
    check(float(d.max()) <= FUSED_MODEL_ATOL and float(d.mean()) <= FUSED_MODEL_MEAN,
          f"fused model, chain kernels vs plain chains {row['kernel_vs_plain_chains']}")
    check(float(ds.max()) <= FUSED_VS_STOCK_ATOL and psnr >= FUSED_VS_STOCK_PSNR,
          f"fused vs stock route {row['fused_vs_stock']}")
    check(k6_launches == chains and torch.equal(y, y_tile), "the K6 route: 76 launches, K7's bits")
    check(sum(per_forward.values()) == chains, f"wrapper calls in a forward {per_forward}")
    return dict(launches=launches[0], k6_launches=k6_launches, x=x, forward_ms=forward_ms,
                per_forward=per_forward)


def phase_tile(stock):
    """A 2160x3840 request through the CLI's `--tile 240` path (16 pixels of
    context, tiles padded to x8, batches of 8 tiles), on the stock route."""
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    rs = np.random.RandomState(7)
    img = (rs.rand(1, 2160, 3840, 3) * 0.12).astype(np.float32)
    enhance(stock, img[:, :240, :240], None, tile=240)  # warm-up: one batch at the tile shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ss2d_scan_pair.launches
    t0 = time.perf_counter()
    out = enhance(stock, img, None, tile=240)
    torch.cuda.synchronize()
    latency_ms = (time.perf_counter() - t0) * 1e3
    forwards = (ss2d_scan_pair.launches - before) // 28
    peak = torch.cuda.max_memory_allocated()
    tiles = -(-2160 // 240) * -(-3840 // 240)
    check(out.shape == img.shape and bool(np.isfinite(out).all()), "the tiled output")
    check(forwards == -(-tiles // 8), f"{forwards} forwards for {tiles} tiles in batches of 8")
    torch.cuda.reset_peak_memory_stats()
    whole = wavemamba_apply(stock, torch.from_numpy(img).cuda()).cpu().numpy()
    whole_peak = torch.cuda.max_memory_allocated()
    d = np.abs(out - whole)
    emit({"phase": "tile", "image": [2160, 3840], "tile_size": 240, "tile_pad": 16,
          "tile_shape": [8, 272, 272, 3], "tiles": tiles, "forwards": forwards,
          "latency_ms": latency_ms, "peak_memory_bytes": peak, "whole_frame_peak_memory_bytes": whole_peak,
          "in_mean": float(img.mean()), "out_mean": float(out.mean()), "whole_frame_out_mean": float(whole.mean()),
          "vs_whole_frame": {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                             "psnr_db": float(10 * np.log10(1.0 / np.mean(d.astype(np.float64) ** 2)))}})
    del whole, out
    torch.cuda.empty_cache()


def phase_serve(model):
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    cfg = model.cfg
    per_forward = 2 * 2 * sum(cfg.n_l_blocks)  # two pairs per SS2D, down and up halves
    check(per_forward == 28, "the shipped config scans 28 pairs per forward")
    rs = np.random.RandomState(0)
    shapes = [(1080, 1920), (720, 1280)]
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
    return launches, x, forward_ms


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

    # The unfused route (`scan_impl: pallas`) on the same weights: K3 against
    # the plain scan, and against the fused route's output above.
    from wavemamba_torch.models.wavemamba import set_unfused_scan
    from wavemamba_torch.ops.scan import selective_scan_plain
    from wavemamba_torch.ops.scan_cuda import selective_scan_cuda

    unfused = build_network({"type": "WaveMamba", "scan_impl": "pallas"},
                            load_network(CKPT, device="cuda"), device="cuda")
    before = selective_scan_cuda.launches, ss2d_scan_pair.launches
    y_k3 = wavemamba_apply(unfused, x)
    check((selective_scan_cuda.launches - before[0], ss2d_scan_pair.launches - before[1]) == (14, 0),
          "the unfused forward launches K3 14 times and K1 never")
    set_unfused_scan(unfused, selective_scan_plain)
    y_plain = wavemamba_apply(unfused, x)
    err = float((y_k3 - y_plain).abs().max())
    routes = float((y_k3 - y_kernel).abs().max())
    emit({"phase": "model", "case": "unfused_kernel_vs_plain", "image": [256, 384],
          "max_abs_err": err, "unfused_vs_fused_max_abs_err": routes, "tol": MODEL_ATOL})
    check(err <= MODEL_ATOL, f"unfused model, K3 vs plain {err} <= {MODEL_ATOL}")
    check(routes <= MODEL_ATOL, f"unfused vs fused route {routes} <= {MODEL_ATOL}")


class PlainScanPair(torch.autograd.Function):
    """The plain scan with the plain backward, on whatever device: what K1 +
    K2 (`scan_cuda.SS2DScanPair`) are held against in the `grad` phase."""

    @staticmethod
    def forward(ctx, x, wx, dtw, bias, A, dsk):
        from wavemamba_torch.ops.scan import ss2d_scan_pair_plain

        y, state, _ = ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, return_carries=True)
        ctx.save_for_backward(x, wx, dtw, bias, A, dsk, state)
        return y

    @staticmethod
    def backward(ctx, dy):
        from wavemamba_torch.ops.scan import ss2d_scan_pair_plain_bwd

        return ss2d_scan_pair_plain_bwd(*ctx.saved_tensors, dy)


def synthetic_batch(seed, batch, size):
    """A seeded low-light pair on the card, NHWC float32: gt uniform, lq = gt
    * 0.12 + noise."""
    rs = np.random.RandomState(seed)
    gt = rs.rand(batch, size, size, 3).astype(np.float32)
    lq = np.clip(gt * 0.12 + rs.randn(batch, size, size, 3).astype(np.float32) * 0.01, 0, 1)
    return torch.from_numpy(lq.astype(np.float32)).cuda(), torch.from_numpy(gt).cuda()


class PlainSelectiveScan(torch.autograd.Function):
    """The plain unfused scan with the plain backward: what K3 + K4
    (`scan_cuda.SelectiveScan`) are held against in the `grad` phase."""

    @staticmethod
    def forward(ctx, *args):
        from wavemamba_torch.ops.scan import selective_scan_plain

        y, state, _ = selective_scan_plain(*args, return_carries=True)
        ctx.save_for_backward(*args, state)
        return y

    @staticmethod
    def backward(ctx, dy):
        from wavemamba_torch.ops.scan import selective_scan_plain_bwd

        return selective_scan_plain_bwd(*ctx.saved_tensors, dy)


def phase_grad(route):
    """Loss and gradients of the whole model, the route's kernels against its
    plain scan with the plain backward: 'fused' is K1 + K2 (28 + 28 launches),
    'unfused' (`scan_impl: pallas`) K3 + K4 (14 + 14)."""
    from wavemamba_torch.models import init_network
    from wavemamba_torch.models.wavemamba import set_scan, set_unfused_scan
    from wavemamba_torch.ops import scan_cuda
    from wavemamba_torch.train.trainer import TrainConfig, loss_fn

    fused = route == "fused"
    model = init_network({"type": "WaveMamba", "remat": False,
                          "scan_impl": "pallas_fused" if fused else "pallas"},
                         torch.Generator().manual_seed(11), device="cuda")
    lq, gt = synthetic_batch(12, 2, 128)
    tcfg = TrainConfig()
    results = []
    wrappers = (scan_cuda.ss2d_scan_pair, scan_cuda.ss2d_scan_pair_bwd,
                scan_cuda.selective_scan_cuda, scan_cuda.selective_scan_cuda_bwd)
    before = [w.launches for w in wrappers]
    scans = (scan_cuda.ss2d_scan_pair, PlainScanPair.apply) if fused else (None, PlainSelectiveScan.apply)
    for scan in scans:
        (set_scan if fused else set_unfused_scan)(model, scan)
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(model, tcfg, lq, gt)
        total.backward()
        results.append((float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}))
    launched = tuple(w.launches - b for w, b in zip(wrappers, before))
    check(launched == ((28, 28, 0, 0) if fused else (0, 0, 14, 14)),
          f"{launched} K1/K2/K3/K4 launches in one forward and backward of the {route} route")
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(((float((grads_k[n] - g).abs().max()) / (float(g.abs().max()) + 1e-30), n)
                 for n, g in grads_p.items()))
    check(all(bool(torch.isfinite(g).all()) for g in grads_k.values()), "gradients finite")
    emit({"phase": "grad", "route": route, "image": [128, 128], "batch": 2, "loss_kernel": loss_k,
          "loss_plain": loss_p, "loss_rel_err": loss_rel, "loss_tol": GRAD_LOSS_RTOL,
          "parameters": len(grads_p), "worst_grad_rel_err": worst[0], "worst_grad": worst[1],
          "grad_tol": GRAD_RTOL,
          "max_grad_abs_err": max(float((grads_k[n] - g).abs().max()) for n, g in grads_p.items())})
    check(loss_rel <= GRAD_LOSS_RTOL, f"loss kernel vs plain {loss_rel} <= {GRAD_LOSS_RTOL}")
    check(worst[0] <= GRAD_RTOL, f"gradient of {worst[1]}: {worst[0]} <= {GRAD_RTOL}")


def train_setup(remat, seed=21):
    from wavemamba_torch.models import init_network
    from wavemamba_torch.train.trainer import TrainConfig, create_train_state, make_train_step

    tcfg = TrainConfig(lr=5e-4, weight_decay=1e-3, betas=(0.9, 0.99), scheduler=SCHEDULER,
                       pixel_weight=1.0, fft_weight=0.1, ema_decay=EMA_DECAY)
    model = init_network({"type": "WaveMamba", "remat": remat},
                         torch.Generator().manual_seed(seed), device="cuda")
    return create_train_state(model, tcfg), make_train_step(tcfg), tcfg


def phase_train(remat):
    """One warm-up step and TRAIN_STEPS steps at full width and depth on one
    fixed seeded batch of TRAIN_BATCH images, with block recompute if `remat`.
    A step that does not fit the card's memory fails the run. Returns what the
    later phases need."""
    from wavemamba_torch.checkpoint import save_training_state
    from wavemamba_torch.models import param_count
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd
    from wavemamba_torch.train.trainer import make_lr

    batch = TRAIN_BATCH
    state, step, tcfg = train_setup(remat)
    lq, gt = synthetic_batch(22, batch, TRAIN_SIZE)
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, lq, gt)  # warm-up: cuDNN plans, the allocator's pool
    warm_loss = float(m["total"])
    check(param_count(state.model) == 1_512_718, "the shipped config has 1,512,718 parameters")
    per_step = 2 * 2 * sum(state.model.cfg.n_l_blocks)  # pairs scanned in a forward
    k1_per_step = per_step * (2 if remat else 1)  # the recompute runs K1 again
    lr = make_lr(tcfg)
    named = dict(state.model.named_parameters())
    states_dir = os.path.join(ROOT, "build", "chip_smoke", "training_states")

    ss2d_scan_pair.launches = ss2d_scan_pair_bwd.launches = 0  # the main path's counts start here
    losses, times, saved = [], [], {}
    for i in range(1, TRAIN_STEPS + 1):  # state.step == i before the step
        ema_before = {n: e.clone() for n, e in state.ema.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, lq, gt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["total"]))
        check(state.optimizer.param_groups[0]["lr"] == lr(i), f"lr of step {i} is schedule({i})")
        ema_err = max(float((state.ema[n] - (ema_before[n] * EMA_DECAY
                                             + p.detach() * (1 - EMA_DECAY))).abs().max())
                      for n, p in named.items())
        check(ema_err <= 1e-6, f"EMA after step {i} follows its formula ({ema_err})")
        if state.step == 3:
            saved["path"] = save_training_state(state, states_dir, 3)
        if state.step == 4:
            saved["loss"] = losses[-1]
            saved["state"] = state.state_dict()
    k1_launches, k2_launches = ss2d_scan_pair.launches, ss2d_scan_pair_bwd.launches  # read after
    peak = torch.cuda.max_memory_allocated()

    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "losses finite")
    check(losses[-1] < warm_loss, f"the loss fell on the repeated batch: {warm_loss} -> {losses[-1]}")
    check(k2_launches == per_step * TRAIN_STEPS == 28 * TRAIN_STEPS,
          f"{k2_launches} K2 launches in {TRAIN_STEPS} steps")
    check(k1_launches == k1_per_step * TRAIN_STEPS, f"{k1_launches} K1 launches in {TRAIN_STEPS} steps")
    check(state.step == TRAIN_STEPS + 1, "the step count")
    ms = float(np.median(times))
    emit({"phase": "train", "batch": batch, "size": [TRAIN_SIZE, TRAIN_SIZE], "remat": remat,
          "steps": TRAIN_STEPS, "loss_first": warm_loss, "losses": losses, "step_ms": times,
          "ms_per_step": ms, "images_per_s": batch / ms * 1e3, "peak_memory_bytes": peak,
          "k1_launches": k1_launches, "k2_launches": k2_launches,
          "k1_per_step": k1_per_step, "k2_per_step": per_step, "lr": lr(TRAIN_STEPS)})
    return dict(state=state, step=step, tcfg=tcfg, lq=lq, gt=gt, remat=remat, saved=saved,
                ms_per_step=ms,
                k1_launches=k1_launches, k2_launches=k2_launches)


def phase_resume(run):
    """The state saved after step 3 goes into a fresh trainer (other initial
    weights) and takes step 4 on the same batch: the loss and the parameters
    of the trainer that went on."""
    from wavemamba_torch.checkpoint import find_resume_state, restore_training_state

    saved = run["saved"]
    path = find_resume_state(os.path.dirname(saved["path"]))
    check(path == saved["path"], f"find_resume_state finds {saved['path']}")
    fresh, step, _ = train_setup(run["remat"], seed=99)
    fresh = restore_training_state(path, fresh)
    check(fresh.step == 3, "the restored step count")
    fresh, m = step(fresh, run["lq"], run["gt"])
    loss = float(m["total"])
    loss_rel = abs(loss - saved["loss"]) / abs(saved["loss"])
    got, want = fresh.state_dict(), saved["state"]
    check(got["step"] == want["step"] == 4 and got["adam_step"] == want["adam_step"],
          "the step counts after the resumed step")
    diff = lambda key: max(float((got[key][n] - w).abs().max()) for n, w in want[key].items())
    size = lambda key: max(float(w.abs().max()) for w in want[key].values())
    err, ema_err = diff("params"), diff("ema")
    moment_rel = {key: diff(key) / size(key) for key in ("exp_avg", "exp_avg_sq")}
    emit({"phase": "resume", "state": os.path.relpath(path, ROOT), "loss": loss,
          "loss_went_on": saved["loss"], "loss_rel_err": loss_rel, "loss_tol": RESUME_LOSS_RTOL,
          "max_param_abs_err": err, "max_ema_abs_err": ema_err, "param_tol": RESUME_ATOL,
          "moment_rel_err": moment_rel, "moment_tol": RESUME_MOMENT_RTOL})
    check(loss_rel <= RESUME_LOSS_RTOL, f"resumed loss {loss} vs {saved['loss']}")
    check(err <= RESUME_ATOL, f"resumed parameters within {RESUME_ATOL}: {err}")
    check(ema_err <= RESUME_ATOL, f"resumed EMA within {RESUME_ATOL}: {ema_err}")
    check(max(moment_rel.values()) <= RESUME_MOMENT_RTOL,
          f"resumed Adam moments within {RESUME_MOMENT_RTOL} of their max: {moment_rel}")


class SyntheticPairs:
    """A seeded in-memory map-style dataset of low-light pairs, HWC RGB: uint8
    for training (what `transfer_dtype: uint8` ships), float32 in [0, 1] for
    validation. Items as `PairedImageDataset` gives them."""

    def __init__(self, n, size, seed, uint8):
        rs = np.random.RandomState(seed)
        self.items = []
        for i in range(n):
            gt = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
            lq = np.clip(gt * 0.12 + rs.randn(size, size, 3) * 2.5, 0, 255).astype(np.uint8)
            if not uint8:
                gt, lq = gt.astype(np.float32) / 255.0, lq.astype(np.float32) / 255.0
            self.items.append({"lq": lq, "gt": gt, "lq_path": f"synthetic/lq/{i:03d}.png",
                               "gt_path": f"synthetic/gt/{i:03d}.png"})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        return self.items[index]


def pipeline_opt(seed):
    """The options of `options/train_wavemamba_uhdll.yml` as `parse_options`
    hands them on, with `scan_impl: pallas`, EMA on and no block recompute."""
    root = os.path.join(ROOT, "build", "chip_smoke", "experiments", "pipeline")
    return {
        "name": "pipeline", "model_type": "FeMaSRModel", "scale": 1, "manual_seed": seed,
        "is_train": True, "device": "cuda",
        "network_g": {"type": "WaveMamba", "in_chn": 3, "wf": 32, "n_l_blocks": [1, 2, 4],
                      "n_h_blocks": [1, 1, 2], "ffn_scale": 2.0, "scan_impl": "pallas",
                      "remat": False},
        "path": {"pretrain_network_g": None, "resume_state": None, "experiments_root": root,
                 "models": os.path.join(root, "models"),
                 "training_states": os.path.join(root, "training_states"),
                 "visualization": os.path.join(root, "visualization")},
        "train": {"optim_g": {"type": "AdamW", "lr": 5e-4, "weight_decay": 1e-3, "betas": [0.9, 0.99]},
                  "scheduler": dict(SCHEDULER), "total_iter": 101000, "warmup_iter": -1,
                  "ema_decay": EMA_DECAY,
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
                  "fft_opt": {"type": "FFTLoss", "loss_weight": 0.1, "reduction": "mean"}},
        "val": {"val_freq": 5000, "save_img": False, "key_metric": "psnr", "metrics": {
            "psnr": {"type": "psnr", "crop_border": 4, "test_y_channel": True},
            "ssim": {"type": "ssim", "crop_border": 4, "test_y_channel": True}}},
    }


def phase_pipeline(fused_ms_per_step):
    """This slice's path at full width and depth with `scan_impl: pallas`. Its
    numbers stand beside the fused route's of this run (`train`, `serve`)."""
    import shutil

    from wavemamba_torch.data import EnlargedSampler, ThreadedLoader, device_prefetch
    from wavemamba_torch.ops import scan_cuda
    from wavemamba_torch.runner import build_model

    wrappers = {"k1": scan_cuda.ss2d_scan_pair, "k2": scan_cuda.ss2d_scan_pair_bwd,
                "k3": scan_cuda.selective_scan_cuda, "k4": scan_cuda.selective_scan_cuda_bwd}
    counts = lambda: {k: w.launches for k, w in wrappers.items()}
    opt = pipeline_opt(seed=31)
    shutil.rmtree(opt["path"]["experiments_root"], ignore_errors=True)
    model = build_model(opt)
    per_forward = 2 * sum(model.cfg.n_l_blocks)  # one K3 launch per SS2D block, down and up
    check(per_forward == 14, "the shipped config scans 14 SS2D blocks per forward")
    train_set = SyntheticPairs(16, TRAIN_SIZE, seed=32, uint8=True)
    sampler = EnlargedSampler(len(train_set), 1, 0, ratio=4)
    loader = ThreadedLoader(train_set, batch_size=TRAIN_BATCH, sampler=sampler, num_workers=4,
                            drop_last=True, seed=opt["manual_seed"])
    check(len(loader) == 8, "eight batches an epoch")
    loader.set_epoch(0)
    batches = device_prefetch(loader, "cuda")

    torch.cuda.reset_peak_memory_stats()
    first = next(batches)
    check(first["lq"].dtype == torch.uint8 and first["lq"].shape == (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3)
          and first["lq"].is_cuda, "the loader hands uint8 NHWC batches on the card")
    warm_loss = float(model.optimize_parameters(first)["total"])  # warm-up

    for w in wrappers.values():  # this path's counts start here
        w.launches = 0
    losses, times, waits = [], [], []

    def step():
        t0 = time.perf_counter()
        batch = next(batches)
        waits.append((time.perf_counter() - t0) * 1e3)
        before = counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = model.optimize_parameters(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["total"]))
        launched = {k: v - before[k] for k, v in counts().items()}
        check(launched == {"k1": 0, "k2": 0, "k3": per_forward, "k4": per_forward},
              f"step {len(times)}: {launched} launches; 14 K3 + 14 K4 and no K1/K2 expected")
        return batch

    for _ in range(PIPELINE_STEPS):
        step()
    saved_iter = model.state.step
    model.save(saved_iter)
    # One more step, which the resumed model repeats below.
    saved = {"batch": step(), "loss": losses[-1], "state": model.state.state_dict()}
    train_launches = counts()
    peak = torch.cuda.max_memory_allocated()
    batches.close()
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "losses finite")
    check(saved_iter == PIPELINE_STEPS + 1 and model.state.step == saved_iter + 1, "the step count")
    check(model.current_lr(saved_iter) == model.state.optimizer.param_groups[0]["lr"],
          "current_lr is the optimizer's")
    ms = float(np.median(times[:PIPELINE_STEPS]))
    emit({"phase": "pipeline", "what": "train", "scan_impl": "pallas", "batch": TRAIN_BATCH,
          "size": [TRAIN_SIZE, TRAIN_SIZE], "steps": len(times), "loss_first": warm_loss,
          "losses": losses, "step_ms": times, "ms_per_step": ms,
          "images_per_s": TRAIN_BATCH / ms * 1e3, "fused_ms_per_step": fused_ms_per_step,
          "data_wait_ms": waits, "data_wait_ms_per_step": float(np.median(waits)),
          "peak_memory_bytes": peak, "launches": train_launches,
          "k3_per_step": per_forward, "k4_per_step": per_forward})

    # Validation through the runner: the EMA weights, psnr / ssim, best tracking.
    val_set = SyntheticPairs(2, TRAIN_SIZE, seed=33, uint8=False)
    val_loader = ThreadedLoader(val_set, batch_size=1, num_workers=2)
    before = counts()
    avg, improved = model.validation(device_prefetch(val_loader, "cuda"), current_iter=saved_iter)
    avg2, improved2 = model.validation(device_prefetch(val_loader, "cuda"), current_iter=saved_iter)
    val_launches = {k: v - before[k] for k, v in counts().items()}
    check(set(avg) == {"psnr", "ssim"} and all(np.isfinite(v) for v in avg.values()), f"metrics {avg}")
    check(improved, "the first validation is the best so far")
    check(all(abs(avg2[k] - v) <= 1e-6 for k, v in avg.items()), f"a repeated validation {avg2} vs {avg}")
    check(improved2 == (avg2["psnr"] > avg["psnr"])
          and model.best_metric_results == {"psnr": max(avg["psnr"], avg2["psnr"])}, "best-metric tracking")
    check(val_launches == {"k1": 0, "k2": 0, "k3": 4 * per_forward, "k4": 0},
          f"validation launches {val_launches}")
    emit({"phase": "pipeline", "what": "validation", "images": 2, "metrics": avg,
          "launches": val_launches})

    # save -> resume into a fresh model (other initial weights) -> the same step again.
    from wavemamba_torch.checkpoint import find_resume_state

    path = find_resume_state(opt["path"]["training_states"])
    check(path is not None and path.endswith(f"{saved_iter}.state"), f"the saved state {path}")
    check(sorted(os.listdir(opt["path"]["models"])) ==
          [f"net_g_{saved_iter}.pth", f"net_g_ema_{saved_iter}.pth", "net_g_ema_latest.pth",
           "net_g_latest.pth"], "the saved networks")
    fresh = build_model({**pipeline_opt(seed=77), "path": opt["path"]})
    check(fresh.resume() == saved_iter, "the resumed iteration")
    loss = float(fresh.optimize_parameters(saved["batch"])["total"])
    loss_rel = abs(loss - saved["loss"]) / abs(saved["loss"])
    got, want = fresh.state.state_dict(), saved["state"]
    diff = lambda key: max(float((got[key][n] - w).abs().max()) for n, w in want[key].items())
    size = lambda key: max(float(w.abs().max()) for w in want[key].values())
    err, ema_err = diff("params"), diff("ema")
    moment_rel = {key: diff(key) / size(key) for key in ("exp_avg", "exp_avg_sq")}
    emit({"phase": "pipeline", "what": "resume", "state": os.path.relpath(path, ROOT), "loss": loss,
          "loss_went_on": saved["loss"], "loss_rel_err": loss_rel, "loss_tol": RESUME_LOSS_RTOL,
          "max_param_abs_err": err, "max_ema_abs_err": ema_err, "param_tol": RESUME_ATOL,
          "moment_rel_err": moment_rel, "moment_tol": RESUME_MOMENT_RTOL})
    check(got["step"] == want["step"] == saved_iter + 1, "the step counts after the resumed step")
    check(loss_rel <= RESUME_LOSS_RTOL, f"resumed loss {loss} vs {saved['loss']}")
    check(err <= RESUME_ATOL and ema_err <= RESUME_ATOL, f"resumed parameters and EMA: {err}, {ema_err}")
    check(max(moment_rel.values()) <= RESUME_MOMENT_RTOL, f"resumed Adam moments: {moment_rel}")
    del fresh, got, want, saved

    # One 1080x1920 request through the runner on this route, beside the
    # same request on the fused route with the same (EMA) weights: unfused,
    # fused, fused, unfused, after a warm-up of each.
    rs = np.random.RandomState(0)
    img = (rs.rand(1, 1080, 1920, 3) * 0.12).astype(np.float32)
    fused_opt = pipeline_opt(seed=31)
    fused_opt["is_train"] = False
    fused_opt["network_g"]["scan_impl"] = "pallas_fused"
    fused = build_model(fused_opt)
    fused.model.load_state_dict(model.state.ema, strict=True)
    check(counts()["k1"] == 0 and counts()["k2"] == 0, "no K1 / K2 launch on this route")
    model.test(img)
    fused.test(img)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    out, request_ms = timed_once(lambda: model.test(img))
    serve_launches = {k: v - before[k] for k, v in counts().items()}
    peak = torch.cuda.max_memory_allocated()
    out_fused, fused_ms = timed_once(lambda: fused.test(img))
    fused_ms = [fused_ms, timed_once(lambda: fused.test(img))[1]]
    request_ms = [request_ms, timed_once(lambda: model.test(img))[1]]
    routes = float(np.abs(out - out_fused).max())
    check(out.shape == img.shape and bool(np.isfinite(out).all()), "the request's output")
    check(serve_launches == {"k1": 0, "k2": 0, "k3": per_forward, "k4": 0},
          f"request launches {serve_launches}")
    check(routes <= MODEL_ATOL, f"the request on the two routes {routes} <= {MODEL_ATOL}")
    emit({"phase": "pipeline", "what": "serve", "image": [1080, 1920], "latency_ms": request_ms,
          "fused_latency_ms": fused_ms, "unfused_vs_fused_max_abs_err": routes,
          "k3_launches": serve_launches["k3"], "peak_memory_bytes": peak})
    total = counts()  # K1 now holds the fused model's three requests; K3 and K4 this route's
    check(total["k1"] == 3 * 2 * per_forward and total["k2"] == 0, "the fused requests' K1 launches")
    return dict(model=model, loader=loader, ms_per_step=ms, launches=total)


def profile_rows(fn):
    """Run `fn` under torch.profiler: (wall ms, [(device us, calls, kernel name)])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        # Kernels and copies only: the profiler mirrors host annotations
        # (`Optimizer.step#AdamW.step`) onto the device's timeline as spans.
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.name.startswith("Optimizer."):
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.device_time_total, n + 1)
    return wall_ms, sorted(((us, n, name) for name, (us, n) in by_name.items()), reverse=True)


def phase_profile(model, x, forward_ms, run, pipe, fused):
    """Device time by kernel over one 1152x1920 forward of each conv route
    (stock convs, and the fused chains: K7), one training step of the fused
    scan route (K1 + K2) and one of the unfused route (K3 + K4, through the
    runner), and the share of each one's wall time in which the card ran no
    kernel."""
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    def report(what, wall_ms, rows, unprofiled_ms, **extra):
        busy_ms = sum(r[0] for r in rows) / 1e3
        named = lambda *keys: sum(r[0] for r in rows if any(k in r[2] for k in keys)) / 1e3
        # K2 and K4 name their kernels alike (each in its own library): a
        # profile holds one route, so the adjoint's time is that route's.
        adjoint = named("bwd_local", "bwd_prefix", "bwd_main", "bwd_reduce", "chunk_prefix<true>")
        emit({"phase": "profile", "what": what, **extra, "wall_ms": wall_ms, "busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms,
              # against the same work's time without the profiler's overhead
              "unprofiled_ms": unprofiled_ms, "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
              "k1_ms": named("chunk_scan", "::chunk_prefix("),
              "k2_ms": 0.0 if what == "train_step_unfused" else adjoint,
              "k3_ms": named("scan_chunk", "chunk_prefix<false>"),
              "k4_ms": adjoint if what == "train_step_unfused" else 0.0,
              "flip_ms": named("flip"),
              "chain_ms": named("chain_kernel"), "chain_launches": sum(
                  r[1] for r in rows if "chain_kernel" in r[2]),
              "conv_ms": sum(r[0] for r in rows if "chain_kernel" not in r[2] and (
                  "conv" in r[2].lower() or "xmma" in r[2] or "wgrad" in r[2]
                  or "dgrad" in r[2])) / 1e3,
              "kernels": len(rows), "launches": sum(r[1] for r in rows),
              "top": [{"us": us, "calls": n, "name": name[:90]} for us, n, name in rows[:20]]})

    report("forward", *profile_rows(lambda: wavemamba_apply(model, x)), forward_ms,
           image=[1152, 1920])
    report("forward_fused", *profile_rows(lambda: wavemamba_apply(fused["model"], x)),
           fused["forward_ms"], image=[1152, 1920])
    report("train_step", *profile_rows(lambda: run["step"](run["state"], run["lq"], run["gt"])),
           run["ms_per_step"], batch=run["lq"].shape[0], size=[TRAIN_SIZE, TRAIN_SIZE], remat=run["remat"])
    batch = {"lq": run["lq"], "gt": run["gt"]}
    report("train_step_unfused", *profile_rows(lambda: pipe["model"].optimize_parameters(batch)),
           pipe["ms_per_step"], batch=run["lq"].shape[0], size=[TRAIN_SIZE, TRAIN_SIZE], remat=False)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--remat", action="store_true",
                        help="block recompute in the train phase (to measure it; the step "
                             "fits an 80 GB card without)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.models import build_network

    set_parity_mode()
    smi = phase_device()
    k1_rows = phase_k1()
    k2_rows = phase_k2()
    k3_rows, k4_rows = phase_k3_k4()
    k5_rows = phase_k5()
    t0 = time.perf_counter()
    model = build_network({"type": "WaveMamba"}, load_network(CKPT, device="cuda"), device="cuda")
    emit({"phase": "load", "checkpoint": os.path.relpath(CKPT, ROOT),
          "load_s": time.perf_counter() - t0})
    launches, x1080, forward_ms = phase_serve(model)
    fused_model = build_network({"type": "WaveMamba", "conv_impl": "fused"},
                                load_network(CKPT, device="cuda"), device="cuda")
    fused = phase_serve_fused(fused_model, model)
    fused["model"] = fused_model
    chain_rows = phase_chain(model, fused["per_forward"])
    phase_tile(model)
    phase_model(model)
    phase_grad("fused")
    phase_grad("unfused")
    run = phase_train(args.remat)
    phase_resume(run)
    pipe = phase_pipeline(run["ms_per_step"])
    phase_profile(model, x1080, forward_ms, run, pipe, fused)

    # K1 and K5 at level 1 of the 1080p forward; K2, K3 and K4 at level 1 of
    # the training step. Launches: each path's own, counted from 0 just before
    # it: K1 the serve path's and the fused training path's, K2 the latter's, K3
    # and K4 the pipeline path's (steps, validation, the request), K7 the fused
    # serve path's.
    level1 = k1_rows[0]
    k2_level1 = k2_rows[0]
    k3_level1 = next(r for r in k3_rows if r["case"] == "train_level1")
    k4_level1 = next(r for r in k4_rows if r["case"] == "train_level1")
    k5_level1 = k5_rows[0]
    # K6 / K7: one call of the slowest chain of a 1080p forward, paconv_chain
    # at level 1; the `chain` lines hold every wrapper's.
    pac = next(r for r in chain_rows if r["chain"] == "paconv_chain")
    chain_err = lambda key: max(max(r[k][key] for k in ("main", "odd")) for r in chain_rows)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "ss2d_scan_pair (K1)", "route": "cuda", "source": "wavemamba_torch/csrc/ss2d_scan.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:705",
        "launches": launches + run["k1_launches"], "launches_serve": launches,
        "launches_train": run["k1_launches"],
        "max_abs_err": max([r["max_abs_err"] for r in k1_rows] + [max(r["k1"].values()) for r in k2_rows]),
        "ms": level1["ms"], "plain_ms": level1["plain_ms"], "bound_ms": level1["bound_ms"],
        "bound_by": level1["bound_by"], "library_ms": None}, {
        "name": "ss2d_scan_pair_bwd (K2)", "route": "cuda",
        "source": "wavemamba_torch/csrc/ss2d_scan_bwd.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:952", "launches": run["k2_launches"],
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in k2_rows),
        "max_rel_err": max(max(r["max_rel_err"].values()) for r in k2_rows),
        "ms": k2_level1["ms"], "plain_ms": k2_level1["plain_ms"],
        "bound_ms": k2_level1["bound_ms"], "bound_by": k2_level1["bound_by"],
        "library_ms": None}, {
        "name": "selective_scan_cuda (K3)", "route": "cuda",
        "source": "wavemamba_torch/csrc/selective_scan.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:134", "launches": pipe["launches"]["k3"],
        "max_abs_err": max(max(r["carries_err"].values()) for r in k3_rows),
        "ms": k3_level1["ms"], "plain_ms": k3_level1["plain_ms"],
        "bound_ms": k3_level1["bound_ms"], "bound_by": k3_level1["bound_by"],
        "library_ms": None}, {
        "name": "selective_scan_cuda_bwd (K4)", "route": "cuda",
        "source": "wavemamba_torch/csrc/selective_scan_bwd.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:317", "launches": pipe["launches"]["k4"],
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in k4_rows),
        "max_rel_err": max(max(r["max_rel_err"].values()) for r in k4_rows),
        "ms": k4_level1["ms"], "plain_ms": k4_level1["plain_ms"],
        "bound_ms": k4_level1["bound_ms"], "bound_by": k4_level1["bound_by"],
        "library_ms": None}, {
        "name": "ss2d_scan_pair_ssd (K5)", "route": "cuda",
        "source": "wavemamba_torch/csrc/ss2d_scan_ssd.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:578", "launches": k5_rows[-1]["launches"],
        "launches_note": "every launch of the k5 phase (comparisons and timing): no configuration "
                         "selects K5, so no model path runs it",
        "max_abs_err": max(max(r["carries_err"].values()) for r in k5_rows),
        "max_abs_err_vs_k1": max(max(r["vs_k1_err"].values()) for r in k5_rows),
        "ms": k5_level1["ms"], "plain_ms": k5_level1["plain_ms"],
        "bound_ms": k5_level1["bound_ms"], "bound_by": k5_level1["bound_by"],
        "library_ms": None}, {
        "name": "fused_chain (K6)", "route": "cuda", "source": "wavemamba_torch/csrc/conv_chain.cu",
        "replaces": "wavemamba_tpu/experimental/conv_fused.py:96", "launches": fused["k6_launches"],
        "launches_note": "one 1152x1920 forward of the fused route under chain_route('tile')",
        "shape": "paconv_chain " + "x".join(map(str, pac["shape"])),
        "max_abs_err": chain_err("max_abs_err"), "max_rel_err": chain_err("max_rel_err"),
        "ms": pac["k6_ms"], "plain_ms": pac["plain_ms"], "bound_ms": pac["bound_ms"],
        "bound_by": pac["bound_by"], "library_ms": pac["library_ms"], "stock_ms": pac["stock_ms"]}, {
        "name": "fused_chain_band (K7)", "route": "cuda", "source": "wavemamba_torch/csrc/conv_chain.cu",
        "replaces": "wavemamba_tpu/experimental/conv_fused.py:403", "launches": fused["launches"],
        "shape": "paconv_chain " + "x".join(map(str, pac["shape"])),
        "max_abs_err": chain_err("max_abs_err"), "max_rel_err": chain_err("max_rel_err"),
        "ms": pac["ms"], "plain_ms": pac["plain_ms"], "bound_ms": pac["bound_ms"],
        "bound_by": pac["bound_by"], "library_ms": pac["library_ms"], "stock_ms": pac["stock_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
