#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`wavemamba_torch`) on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It builds every
kernel of the port from `wavemamba_torch/csrc/`, holds each against its
plain PyTorch version on the card, serves the shipped model, trains a fresh
one at full width, drives the yml pipelines' path with `scan_impl: pallas`,
and prints one JSON line per phase:

  1. device  the card (nvidia-smi), torch and CUDA versions, the kernel builds
             (seconds in all and each source's `nvcc`), each kernel's
             registers and spills.
  2. k1      kernel K1 (`ss2d_scan_pair`) against `ss2d_scan_pair_plain` at
             the three scan lengths of a 1080p forward, on a ragged length
             and on a column (transposed) token stream; times and bounds,
             the device time of each of K1's three kernels (`phases_ms`:
             pass 1, chunk prefix, replay; torch.profiler), the SM clock and
             power draw that nvidia-smi samples while it runs, and the
             launch's geometry (threads, shared memory, grid) beside the
             blocks and warps an SM that the card's occupancy query reports,
             held against `scan_cuda.k1_plan`.
  3. k2      kernel K2 (`ss2d_scan_pair_bwd`, K1's backward) against
             `ss2d_scan_pair_plain_bwd` at the training shapes, on a ragged
             length and on a column stream, all six outputs and K1's carries;
             times at the three training lengths and bounds; the launch's
             geometry (threads, shared memory, `gx`) and the blocks and warps
             an SM that the card's occupancy query reports, held against
             `scan_cuda.k2_plan`.
  3b. k3     kernel K3 (`selective_scan_cuda`, the unfused scan of
             `scan_impl: pallas`) against `selective_scan_plain` at the route's
             shapes: the three scan lengths of a 1080p forward, the three of a
             batch-8 512x512 step, a ragged length; times and bounds.
  3c. k4     kernel K4 (`selective_scan_cuda_bwd`, K3's backward) against
             `selective_scan_plain_bwd` at the three training shapes and the
             ragged one, all seven outputs, the same bits twice; times at the
             three training lengths and bounds, the device time of each of
             K4's four kernels (`phases_ms`: local adjoint, prefix, gradients,
             reduction; torch.profiler), the SM clock and power draw under
             its load; the launch's geometry (threads, shared memory, `gx`)
             and the blocks and warps an SM that the card's occupancy query
             reports, held against `scan_cuda.k4_plan`.
  3d. k5     kernel K5 (`ss2d_scan_pair(..., variant='ssd')`, K1's function in
             the segment-local form) against its plain version and against K1,
             y and carries, at the three scan lengths of a 1080p forward, a
             ragged length and a column stream; on bf16 x with bf16 y and with
             float32 y against the plain version at level 3 and the ragged
             length, timed at level 1; the same bits twice; times and bounds,
             `phases_ms` (pass 1, chunk prefix, replay), the SM clock and power
             draw under its load, the launch geometry held against
             `scan_cuda.k5_plan`, and the issued instructions a MUFU of each
             pass's hot loop (SASS).
  3e. chain  the conv-chain kernel (`csrc/conv_chain.cu`, tensor cores) from
             both entry points, K6 (`fused_chain`, 2-D tiles) and K7
             (`fused_chain_band`, row bands), against `fused_chain_plain`, for
             each of the nine wrappers with the shipped checkpoint's modules at
             the 1080p shape where each runs and at 17x130, on a float32 and on
             a bf16 input (one bf16 step more), the same bits twice and from
             both entry points; times beside the bound, the plain version, the
             stock modules the chain replaces and, for a single conv,
             `F.conv2d`, all on the row's dtype; tile, shared memory, TFLOP/s.
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
             0.1 FFT, batch 8 of 512x512, float32), under each block
             recompute policy in turn: none, 'full' and 'save_scan' (the
             yml's: it sets no `remat`), each from the same init: loss and
             every gradient (held against no recompute's), then one warm-up
             step and six steps on a seeded synthetic batch: launches of K1
             and K2 per step (28 / 28, 56 / 28 and 28 / 28), ms per step,
             images/s, peak memory, the loss falls, EMA and lr follow their
             formulas; under 'save_scan' the recompute hands each of the 28
             ops of the gradients' step the x its forward scanned, bit for
             bit (`scan_cuda.record_x_digests`). Then 'full' and 'save_scan'
             in twenty alternating
             steps (`train_policies`): 'save_scan' may not be slower a step
             by more than the spread of 'full''s steps.
  8. resume  the 'save_scan' training state saved after step 3, restored into
             a fresh trainer, takes step 4 again: the same loss and
             parameters.
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
 10. probe   the probes P1-P5 (`wavemamba_torch/scripts/gpu_probe.py`,
             `csrc/gpu_probe.cu`) at the TPU probes' K and at a K that makes
             each compute-bound, against their plain versions, the same bits
             twice: Gop/s, ms, bound, plain and library times; P1's, P3's and
             P4's registers, warps an SM and hot loop (SASS), the SM clock
             and power under P1's and P3's compute-bound load.
 11. serve_fast the same two requests with `WaveMambaConfig.fast()` (bf16,
             K1 on bf16 token streams): 28 K1 launches a forward, each on
             bf16 x and y, latency, forward time, peak memory, PSNR against
             the float32 route's output; the whole model with K1 against the
             plain scan at 256x384.
 11b. serve_fast_fused the same two requests with `WaveMambaConfig.fast(
             conv_impl="fused")`: 76 K7 + 28 K1 launches a forward, both on
             bf16 activations, PSNR against the float32 route (held) and
             against `fast()` (reported), chain kernels against plain chains on
             the same model, the forward beside `fast()`'s, peak memory.
 12. train_fast / train_mixed the xxl4 yml's (bf16 compute and scan) and
             the proc512 yml's (bf16 compute, float32 scan) `network_g` and
             `train` sections
             through `build_model` and the yml's loader on a seeded uint8
             dataset (train_fast: the device-resident dataset,
             `cache_on_device: true`; train_mixed: the host loader), with the
             ymls' block recompute ('save_scan'), 1 + 6 steps on one batch of
             8 x 512x512: 28 K1 + 28 K2 a step on bf16 streams (train_mixed:
             bf16 x, float32 y and dy), ms a step, images/s, peak memory, the
             loss falls; before them, for
             each mix, loss and gradients with K1 + K2 against the plain scan
             and backward at 128x128 (`grad` routes `fast` and `mixed`), both
             read against the float32 plain route's gradients as bf16 noise,
             and a planted K2 fault that the check must catch.
 12b. device_cache the xxl4 yml's device-resident dataset at its scale:
             3,200 seeded uint8 pairs of 512x512 (400 where the host cannot
             hold them, said on the line) staged on the card, the staging
             seconds, bytes on the card, ms a batch of 8; the first batches
             of an epoch against the same loader on CPU tensors and against
             numpy's crop and dihedral modes, bit for bit.
 12c. data   the data layer: the port's dataset generator
             (`python -m wavemamba_torch.scripts.make_proc_dataset --bsrgan
             --n-train 16 --n-val 1 --size 512 --seed 2`) twice at once under
             `build/chip_smoke/`, the two trees the same bytes; meanwhile the
             native crop (`data/native.py`, built from `native/wavedata.cc`)
             on 8 seeded uint8 pairs of 2160x3840 against its numpy version bit
             for bit in modes 0-7 and batched, the host ms of a batch of 8 by
             the native and the numpy routes, and `filter2d`, `duf_downsample`
             and `diff_jpeg` (forward and gradient) on CUDA tensors against
             the CPU, with their ms; then the uhdll yml trains 3 steps from the
             generated set through `PairedImageDataset`'s native route and the
             threaded loader under 'save_scan': 28 K1 + 28 K2 a step. Needs
             OpenCV (the generator's).
 12c2. scripts the ported scripts, each as users run it (`python -m
             wavemamba_torch.scripts.<name>`) in a child process on the card, on
             the data phase's generated sets: `dataset_manifest` writes and
             verifies a set and exits 1 on a copy with one flipped byte;
             `merge_datasets` merges the two sets (pairs summed, the merge
             verifies); `cross_val_ckpts` runs the eight shipped checkpoints
             on a 128x128 crop of the val pair (XXL4's PSNR within 0.01 dB
             of the same forward on the CPU);
             `tiled_localize` and `tiled_fidelity` give finite readings; the
             xxl4 yml trains 2 iterations through `pipelines.train`, each saved
             and validated, and `eval_run_ckpts` on that experiment gives the
             run's logged validations, `post_train_eval` loads its best
             checkpoint strictly (card against CPU within MODEL_ATOL) and
             `metrics_sweep` scores the restored sample as the port's metrics
             do here; `trace_topops` tables a trace of one 512x512 forward
             (K1's kernels: 28 K1 x 3 calls, `short_profile` where the
             profiler kept fewer); then, each alone on the card,
             `conv1x1_sweep` (the four `conv1x1_as_conv` variants of `fast()`
             at 1080x1920: ms, 28 K1 a forward, >= 40 dB from float32) and
             `chain_tune` (K7 at band_h 8 / 16 / 32 / 64 against the stock
             modules and the plain chains, bf16, 544x960; `fast()` against
             `fast(conv_impl="fused")` at 1088x1920).
 12d. parallel multi-GPU on the one card, in child processes (fresh
             interpreters, never forked from this one): `torchrun --standalone
             --nproc_per_node=1 -m wavemamba_torch.pipelines.train -opt
             options/train_wavemamba_uhdll.yml` for 1 + 4 iterations on the
             data phase's generated set (NCCL at world size 1: the exit code,
             the log's global batch of 8, the checkpoint); beside it two gloo
             ranks sharing cuda:0: the yml's trainer at batch_size_per_gpu 4
             against the ungrouped batch-8 steps (losses, parameters, the
             ranks' bits), the XXL4 checkpoint with `scan_impl: seq_sharded`
             at 512x512 against the one-process 'chunked' forward,
             `tiled_apply_mesh` of the tile phase's 2160x3840 frame against
             the one-process tiles, the device cache's slices against the
             one-process global batch, two trainer steps of the XXL4
             checkpoint with `scan_impl: seq_sharded` at batch 2 of 256x256
             (the step gathers the ranks' rows) against the same steps with
             'chunked' in this process, on the parameters, with a planted
             fault (the output gradient summed over the ranks) caught, and
             which collectives gloo runs on CUDA
             tensors; then a child in an NCCL group of one rank: the grouped
             steps' parameters equal the ungrouped steps' bit for bit (under
             deterministic algorithms), and the ms a step with and without the
             group in turns, 28 K1 + 28 K2 a step. Two ranks on one card are
             a correctness run, not a scaling figure.
 12e. deploy the deployment route (`wavemamba_torch/deploy.py`): right after
             the builds, `python -m wavemamba_torch.scripts.export_model export`
             traces two artifacts of the XXL4 checkpoint in child processes
             that see no card (a build host), while the phases above run: K1's
             op kept (`--target cuda --allow_custom_calls`) for the 1152x1920
             bucket with a 240 / 16 tile program, and the `fast` preset with
             uint8 I/O. Here they load on the card, each program one CUDA
             graph captured at its first call: the two requests of `serve`'s
             sizes (new seeded images), each twice, within 1e-5 of the eager
             forward on the same padded input (bit equality reported) and the
             same bits on the replay; two dispatches before one fetch; 2160x3840
             through `tiled` against the eager tiles; K1 in each graph (28 a
             forward), the replay against the eager forward (CUDA events) and
             each one's idle share (torch.profiler); the fast uint8 artifact
             against the float32 one (>= 40 dB); trace, save and load seconds,
             artifact bytes, first and later request latency, memory after
             each capture; then `export_model run` twice on a fresh
             `--compile_cache` (the first process builds K1 there, the
             second loads it): each one's first request in seconds; last,
             a third artifact, the tile program sharded over two ranks
             (`--mesh_devices 2`), served by two gloo ranks sharing cuda:0
             (each its batch-4 share of every tile batch through its own
             CUDA graph, the shares gathered in rank order) on the same
             2160x3840 frame: within 1e-6 of the one-process artifact's
             tiles, the same bits on both ranks, K1 in every tile batch of
             each, and a planted fault (the shares gathered in swapped
             order) caught. Two more artifacts, exported beside the CLI's
             through `deploy.export_model` (the CLI has no `conv_impl` flag),
             each one 1152x1920 bucket: `fast(conv_impl="fused")` with uint8
             I/O, whose graph holds K1 and the chain op (K7), within one
             level of the eager fused `fast()` bytes on every pixel and >= 40
             dB from float32; and `scan_impl: pallas` float32, whose graph
             holds K3's op, within 1e-5 of the eager forward; in each graph
             the kernels the eager forward launches (wrappers and kernel
             names), replay and eager ms, idle shares and load seconds.
 12f. art    ART, the second model family, at its default width (dim 48, 8
             blocks): the uhdll yml with `network_g: {type: ART}` through
             `pipelines.train` for 1 + 4 iterations at batch 8 of 512x512 from
             the data phase's generated set, twice in child processes under
             deterministic algorithms (finite losses, the same parameters'
             bits, the checkpoint, the final validation); ms a step and peak
             memory through `build_model`; a 1080x1920 forward timed; a 64x96
             forward against the CPU. ART runs no kernel of the port.
 12g. secondary the VGG19 perceptual and style losses at batch 8 of 512x512,
             LPIPS at 1080x1920, the R1 and WGAN-GP penalties (and their own
             gradient) on a small discriminator, each against the CPU on the
             same seeded weights (no pretrained weights are in the
             repository); `utils/profiler.trace` around one WaveMamba
             forward, whose trace must name K1's kernels.
 13. profile device time by kernel (torch.profiler) over one 1152x1920
             forward of each conv route, of `fast()` and of
             `fast(conv_impl="fused")`, one training step of the fused scan
             route, of the unfused route and of the two bf16 ymls, and the
             card's idle share; K1's and K3's launches as the profile
             recorded them beside their wrappers' counts (`short_profile`
             where it recorded fewer); K2's ms and share of each fused
             step's busy time, also in the `kernels` line; K3's and K4's ms
             of the unfused step (the run fails if that profile finds either
             by name nowhere).
 14. bench   `wavemamba_torch.bench` in `fast` and `parity` modes.

The k1 and k2 phases also hold the kernels on bf16 streams (x and y, or x,
dy and dx) against their plain versions, within one bf16 rounding step, at
every shape the fast paths give them, and on bf16 x with float32 y / dy (the
proc ymls' mix, rows `*_mixed`) at the three levels of a 1080p forward and
of a training step: y to the float32 rows' tolerance, dx within one bf16
step, the same bits twice. Then
the `kernels` line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero without the last line. It needs
one card and exits non-zero where CUDA is missing.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
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
# Both round the same operands to bf16; the plain version takes each product's
# sum exactly and rounds it once, the kernel sums on the tensor cores within
# about an ulp of that. Where a last-bit difference of an f32 stage (LayerNorm,
# GELU, the depthwise sum, a sum) moves a value across a bf16 rounding boundary
# ahead of a 1x1 or dense 3x3, one product moves by a bf16 step: 1e-5 on at
# least 99.5% of the elements, 1e-2 on every one.
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
# K1 / K2 on bf16 streams against their plain versions on the same bf16
# inputs: both compute in float32 and round y once (dx once per member, then
# the pair's sum), so an element differs only where the float32 values
# (within K1_ATOL / K2_RTOL of each other) fall on two sides of a bf16
# rounding boundary: by one bf16 step (8 significant bits: at most 2^-7 of
# its magnitude; for dx, of the sum's or of either member's), plus the
# float32 difference.
BF16_STEP = 2.0 ** -7
# The bf16 model (`fast()`): K1 against the plain scan on the card, both on
# bf16 streams; one-step flips of y travel through the bf16 network. Max abs
# and PSNR between the two outputs.
FAST_MODEL_ATOL, FAST_MODEL_PSNR = 5e-2, 45.0
# The fast route's 1080p request against the float32 route's, same weights.
FAST_VS_F32_PSNR = 40.0
# `fast(conv_impl="fused")`, chain kernels against plain chains on the card,
# both on bf16 activations: as FAST_MODEL_*, one-step flips of bf16 chain
# outputs travel through the bf16 network. Max abs and PSNR.
FAST_FUSED_MODEL_ATOL, FAST_FUSED_MODEL_PSNR = 5e-2, 45.0
# bf16 training, K1 + K2 against the plain scan and backward, both on bf16
# streams: the loss relative. The gradients against bf16 noise, which the
# float32 plain route's gradients measure: the kernels may be no farther from
# the plain bf16 route, over all gradients as one vector and at the median
# leaf, than the plain bf16 route is from float32; and each gradient that
# K2's sums give (the scan parameters of every SS2D, 70 leaves) within
# GRAD_FAST_SCAN_RTOL of its float32 norm, about twice the largest reading of
# either distance on those leaves (PERF.md). Other single leaves are not held: one
# flip of a bf16 y changes the rounding downstream, and some leaves (an
# attention temperature's, a LayerNorm's in the HFE attention) move by 30% to
# 100% between two bf16 runs that both sit within 2% of float32 over all.
# A planted fault, K2's dA 25% off, must fail the check (it moves only the
# A_logs leaves, which the norm and the median do not see).
GRAD_FAST_LOSS_RTOL = 1e-3
GRAD_FAST_SCAN_RTOL = 0.1
GRAD_FAST_PLANT = 0.25
TRAIN_BATCH, TRAIN_SIZE, TRAIN_STEPS, EMA_DECAY = 8, 512, 6, 0.999
PIPELINE_STEPS = 4
# 'save_scan' against 'full' in alternating steps of the two trainers
# (`phase_train`). Both steps are host-bound, and a shared host spreads a
# step's time by 30-90 ms between turns, more than the few ms that K1's
# launches are worth: the turns decide only beyond that spread.
POLICY_TURNS = 20
TRAIN_LENGTHS = [65536, 16384, 4096]  # tokens per image at the three LFSS levels of 512x512
SCHEDULER = {"type": "CosineAnnealingRestartCyclicLR", "periods": [100, 100000],
             "restart_weights": [1, 1], "eta_mins": [0.0005, 0.0000001]}
LEVELS_1080P = [(576, 960), (288, 480), (144, 240)]  # token grid of each LFSS level


_T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line also gets `t_s`, the seconds since
    the script started, so that each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
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


def k1_bound(B, L, D, N, R, x_bytes=4, y_bytes=None):
    """Least time (ms) the card could take for one K1 call, what bounds it
    ("bytes" or "operations"), and the unit that bounds it ("hbm", "fma" or
    "sfu").

    Bytes: x read once (`x_bytes` a value: 2 in bf16), y written once
    (`y_bytes`, x's by default), the weights read once. Per (token,
    direction), each computed once: on the FMA pipe, an FMA counted as two,
    the projection 2D(R+2N), dt 2RD, log1p of the softplus D (one operation,
    though it is a polynomial), the recurrence 6 per (n, d) (da*A, the FMA of
    h, du*B, the FMA of C.h), du D and the output FMA 2D; on the SFU, one exp
    per (n, d) and one per d for the softplus (`expf` is one ex2 there plus
    FMA-pipe range reduction, not counted)."""
    weights = 2 * D * (R + 2 * N) + 2 * R * D + 2 * D + 2 * N * D + 2 * D
    nbytes = x_bytes * B * L * D + (y_bytes or x_bytes) * 2 * B * L * D + 4 * weights
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


def chain_bound(c0, specs, pixels, act_bytes=4):
    """Least time (ms) the card could take for one chain over `pixels` pixels
    of one image, what bounds it, the unit that does, and the tensor cores'
    operations. Bytes: the input read once, the output written once
    (`act_bytes` each: 2 in bf16), the f32 weights read once. Per pixel: the
    bf16 products of the 1x1, dense 3x3 and gate stages (2 per multiply-add)
    on the tensor cores; on the FMA pipe the depthwise taps (2 each), a bias 1, LayerNorm 6, the
    tanh GELU 8 and silu / sigmoid 3 per element, the gate 3, the residual 2;
    on the SFU a tanh per GELU, an exp and a reciprocal per silu or sigmoid,
    a reciprocal square root per LayerNorm."""
    weights = sum(t.numel() for s in specs for t in s[4:6] if t is not None)
    nbytes = act_bytes * pixels * (c0 + specs[-1][2]) + 4 * weights
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
    return (*_bound(nbytes, fma * pixels, sfu * pixels, tensor * pixels), tensor * pixels)


def k2_bound(B, L, D, N, R, T=64, stream_bytes=4, dy_bytes=None):
    """Least time (ms) the card could take for one K2 call; as `k1_bound`.

    Bytes: x and dy read once, dx written once (`stream_bytes` each, dy
    `dy_bytes` where it differs), the chunk-entry states and
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
    nbytes = B * L * D * (2 * stream_bytes + 2 * (dy_bytes or stream_bytes)) \
        + 4 * (B * 2 * nc * (N * D + D) + 2 * weights)
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


def template_tags(mangled):
    """The template arguments that follow a kernel's <16, R> in its mangled
    name, as words: a pass (`Lb0E` pass1, `Lb1E` replay) and stream dtypes
    (`f` f32, `13__nv_bfloat16` bf16, a substitution `S<n>_` the dtype before
    it)."""
    words, rest = [], mangled
    while rest and not rest.startswith("E"):
        for pat, word in (("Lb0E", "pass1"), ("Lb1E", "replay"), ("13__nv_bfloat16", "bf16"),
                          ("f", "f32")):
            if rest.startswith(pat):
                words.append(word)
                rest = rest[len(pat):]
                break
        else:
            sub = rest.find("_") if rest.startswith("S") else -1
            if sub < 0 or not words:
                break
            words.append(words[-1])
            rest = rest[sub + 1:]
    return words


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from wavemamba_torch.ops import scan_cuda

    t0 = time.perf_counter()
    libs = scan_cuda.build_all()  # one nvcc per source, started together
    build_s = time.perf_counter() - t0

    def ptxas(lib, kernels, shipped="ILi16ELi2E"):
        """Registers and spills of each kernel of the build, as `-Xptxas -v`
        reports them; of a templated kernel, the shipped instantiation's
        (`shipped` in its mangled name: <16, 2> is K1's and K2's dt_rank, <16,
        64> K4's 64 channels a block; K3's <16> keeps both passes), named
        with its pass and stream dtypes where it has them (K1: [pass, x, y];
        K2: [x, dy]; K3: [pass])."""
        lines = lib.with_suffix(".log").read_text().splitlines()
        out = []
        for i, ln in enumerate(lines):
            name = next((k for k in kernels if k in ln), None)
            if "Compiling entry function" in ln and name and (
                    "ILi16ELi" not in ln or shipped in ln):
                args = template_tags(ln.split(shipped, 1)[1]) if shipped in ln else []
                out.append(name + (f" [{', '.join(args)}]" if args else "") + ": " + ", ".join(
                    x.replace("ptxas info    :", "").strip() for x in lines[i + 2:i + 4]))
        return out

    emit({"phase": "device", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "build_s_by_source": dict(scan_cuda.BUILD_SECONDS),
          "libraries": [os.path.relpath(lib, ROOT) for lib in libs],
          "k1_ptxas": ptxas(libs[0], ["chunk_scan", "chunk_prefix"]),
          "k2_ptxas": ptxas(libs[1], ["bwd_local", "bwd_prefix", "bwd_main", "bwd_reduce"]),
          "k3_ptxas": ptxas(libs[2], ["selective_chunk", "selective_prefix"], "ILi16E"),
          "k4_ptxas": ptxas(libs[3], ["bwd_local", "bwd_prefix", "bwd_main", "bwd_reduce"], "ILi16ELi64E"),
          "k5_ptxas": ptxas(libs[4], ["chunk_scan_ssd", "chunk_prefix"]),
          "chain_ptxas": ptxas(libs[5], ["chain_kernel"]),
          "probe_ptxas": ptxas(libs[6], ["flat", "shaped", "expchain", "nsum", "mxu_seg"])})
    return smi


K1_PHASES = ("pass1", "prefix", "replay")


def k1_phase_of(kernel):
    """Which of K1's three kernels a profiler name is: pass 1
    (`chunk_scan<..., false, ...>`), the chunk prefix, or the replay
    (`chunk_scan<..., true, ...>`); None for any other kernel."""
    if "chunk_prefix" in kernel:
        return "prefix"
    if "chunk_scan<" in kernel:
        return "replay" if "true" in kernel else "pass1"
    return None


def k5_phase_of(kernel):
    """Which of K5's three kernels a profiler name is: pass 1
    (`chunk_scan_ssd<..., false, ...>`), the chunk prefix, or the replay
    (`chunk_scan_ssd<..., true, ...>`); None for any other kernel. K1 names
    its prefix alike: a profile that holds K5 holds no K1."""
    if "chunk_prefix" in kernel:
        return "prefix"
    if "chunk_scan_ssd<" in kernel:
        return "replay" if "true" in kernel else "pass1"
    return None


# Profiler sessions a measurement takes at most: torch.profiler may record
# none of a session's kernels (two sessions in a row recorded none of K1's
# in one run), and the next session takes the measurement again.
PROFILE_SESSIONS = 5


def kernel_phases(call, phase_of, phases, what, reps=5):
    """Device ms per call of each of a kernel's launches (`phases`, named by
    `phase_of` from the profiler's kernel names) over `reps` calls of `call`
    under torch.profiler (after one call outside it). The profiler need not
    record every launch of a session (it kept 2-3 of 5 of K4's long
    launches): each launch's time is the mean over those it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(PROFILE_SESSIONS):  # another session where one recorded none of the kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        us, calls = dict.fromkeys(phases, 0.0), dict.fromkeys(phases, 0)
        for e in prof.events():
            phase = phase_of(e.name) if e.device_type == DeviceType.CUDA else None
            if phase:
                us[phase] += e.device_time_total
                calls[phase] += 1
        if all(calls.values()):
            return {p: us[p] / 1e3 / calls[p] for p in phases}
        ms = us
    raise RuntimeError(f"check failed: {what}'s {len(phases)} kernels ran under the profiler: {ms}")


def clocks_under_load(call, seconds=0.5):
    """(SM clock MHz, power draw W): the medians of nvidia-smi's samples,
    every 50 ms, while `call` runs back to back for `seconds`. The load starts
    once nvidia-smi has given its first sample, which is left out: its start
    can take longer than the load."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        smi.stdout.readline()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = [[float(v) for v in ln.split(",")] for ln in out.splitlines() if ln.count(",") == 1]
    check(len(samples) > 0, "nvidia-smi sampled the clock under load")
    return float(np.median([s[0] for s in samples])), float(np.median([s[1] for s in samples]))


def scan_geometry(kernel, names, plan, occ):
    """The launch geometry of K1's or K3's three kernels (`names`: pass 1,
    the replay, the chunk prefix) for a `k1` / `k3` row: the plan's blocks and
    residency (`scan_cuda.k1_plan` / `k3_plan`) beside what the card reports
    for the same launch (`k1_occupancy` / `k3_occupancy`, registers
    included). Fails where the launch's threads or shared memory are not the
    plan's, or where the card lets fewer blocks of a kernel reside than
    planned."""
    pass1, replay, prefix = names
    kernels = {pass1: ("pass1", "scan"), replay: ("replay", "scan"), prefix: ("prefix", "prefix")}
    check(all(occ[k] == plan[k] for k in ("threads", "smem_scan", "prefix_threads")),
          f"{kernel} launches {occ} as {kernel.lower()}_plan planned {plan}")
    blocks = {name: occ[f"blocks_per_sm_{own}"] for name, (own, _) in kernels.items()}
    threads = {pass1: plan["threads"], replay: plan["threads"], prefix: plan["prefix_threads"]}
    for name, (_, planned) in kernels.items():
        check(blocks[name] >= plan[f"blocks_per_sm_{planned}"],
              f"{kernel} {name}: {blocks[name]} blocks an SM, {plan[f'blocks_per_sm_{planned}']} planned")
    return {"threads": threads,
            "smem_bytes": {pass1.split("<")[0]: plan["smem_scan"], prefix: plan["smem_prefix"]},
            "blocks_per_sm": blocks,
            "warps_per_sm": {name: blocks[name] * -(-threads[name] // 32) for name in kernels},
            "planned_warps_per_sm": {name: plan[f"warps_per_sm_{planned}"]
                                     for name, (_, planned) in kernels.items()},
            "grid_scan": list(plan["grid_scan"]), "waves_scan": plan["waves_scan"],
            "grid_prefix": list(plan["grid_prefix"])}


def k1_geometry(plan, occ):
    return scan_geometry("K1", ("chunk_scan<false>", "chunk_scan<true>", "chunk_prefix"), plan, occ)


F32_STREAMS = (torch.float32, torch.float32)  # (x, y) or (x, dy) dtypes of the float32 rows


def k1_row_geometry(B, L, streams):
    """`k1_geometry` at a k1 row's shape (D=64, N=16, R=2) and (x, y) dtypes
    on this card."""
    from wavemamba_torch.ops.scan_cuda import CHUNK, k1_occupancy, k1_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return k1_geometry(k1_plan(B, L, 64, 16, 2, CHUNK, sms), k1_occupancy(D=64, R=2, streams=streams))


def k1_timings(row, call, phase_of=k1_phase_of, kernel="K1"):
    """A timed k1 (or k5) row's device times: `ms` (CUDA events, median of
    20), `phases_ms` (the kernel's three kernels, torch.profiler), and the SM
    clock and power draw while it runs."""
    row["ms"] = cuda_ms(call, 20)
    row["phases_ms"] = kernel_phases(call, phase_of, K1_PHASES, kernel)
    row["clocks_sm_mhz"], row["power_draw_w"] = clocks_under_load(call)


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
        y_plain, plain_ms = timed_once(lambda: ss2d_scan_pair_plain(*args))
        err = float((y - y_plain).abs().max())
        check(bool(torch.isfinite(y).all()), f"K1 {name}: finite")
        check(err <= K1_ATOL, f"K1 {name}: max abs err {err} <= {K1_ATOL}")
        row = {"phase": "k1", "case": name, "B": 1, "L": h * w, "D": 64, "N": 16, "R": 2,
               "max_abs_err": err, "tol": K1_ATOL, "y_max_abs": float(y_plain.abs().max()),
               "geometry": k1_row_geometry(1, h * w, F32_STREAMS)}
        if not columns and name != "ragged":
            k1_timings(row, lambda: ss2d_scan_pair(*args))
            row["plain_ms"] = plain_ms  # the comparison's one call, as K3's
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k1_bound(1, h * w, 64, 16, 2)
        row["launches"] = ss2d_scan_pair.launches
        emit(row)
        rows.append(row)
        del y, y_plain, args
    return rows


def bf16_excess(got, want, atol):
    """How far `got` (bf16) lies beyond one bf16 step of `want` (the plain
    version's bf16) plus `atol` (a number, or a tensor of `want`'s shape), at
    its worst element: <= 0 passes; and the share of elements that differ at
    all."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float((d - BF16_STEP * w.abs() - atol).max()), float((d > 0).float().mean())


def phase_k1_bf16(y_dtype=torch.bfloat16):
    """K1 on bf16 x, against its plain version on the same bf16 x, at every
    level of a 1080p forward (B=1, as `phase_k1`); times and bounds. With bf16
    y (the fast presets; also a ragged length and a column stream) an element
    may differ by one bf16 step; with float32 y (rows `*_mixed`, the proc
    ymls' mix) y is held to the float32 rows' K1_ATOL, as x is the same bf16
    values in both versions. K1 at the training shapes on these streams is
    held in `phase_k2_bf16`."""
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    bf16 = torch.bfloat16
    mixed = y_dtype == torch.float32
    rs = np.random.RandomState(18 if mixed else 8)
    rows = []
    tag = "mixed" if mixed else "bf16"
    cases = [(f"level{i + 1}_{tag}", h, w, False) for i, (h, w) in enumerate(LEVELS_1080P)]
    if not mixed:
        cases += [("ragged_bf16", 1, 34560 + 37, False), ("columns_bf16", 144, 240, True)]
    for name, h, w, columns in cases:
        args = pair_inputs(rs, 1, h * w)
        x = args[0].to(bf16)
        if columns:
            x = x.view(1, h, w, -1).transpose(1, 2).reshape(1, h * w, -1).contiguous()
        args = (x,) + args[1:]
        y = ss2d_scan_pair(*args, out_dtype=y_dtype)
        again = ss2d_scan_pair(*args, out_dtype=y_dtype)
        torch.cuda.synchronize()
        y_plain, plain_ms = timed_once(lambda: ss2d_scan_pair_plain(*args, out_dtype=y_dtype))
        err = float((y.float() - y_plain.float()).abs().max())
        check(y.dtype == y_dtype and bool(torch.isfinite(y.float()).all()),
              f"K1 {name}: {y_dtype}, finite")
        check(torch.equal(y, again), f"K1 {name}: the same bits twice")
        row = {"phase": "k1", "case": name, "B": 1, "L": h * w, "D": 64, "N": 16, "R": 2,
               "x": "bfloat16", "y": str(y_dtype).removeprefix("torch."), "max_abs_err": err}
        if mixed:
            check(err <= K1_ATOL, f"K1 {name}: max abs err {err} <= {K1_ATOL}")
            row["tol"] = K1_ATOL
        else:
            excess, share = bf16_excess(y, y_plain, K1_ATOL)
            check(excess <= 0, f"K1 {name}: beyond one bf16 step of the plain version by {excess}")
            row.update(share_differing=share, tol=f"one bf16 step + {K1_ATOL}")
        row.update(y_max_abs=float(y_plain.float().abs().max()),
                   geometry=k1_row_geometry(1, h * w, (bf16, y_dtype)))
        if not columns and not name.startswith("ragged"):
            x32 = args[0].float()
            k1_timings(row, lambda: ss2d_scan_pair(*args, out_dtype=y_dtype))
            row["f32_ms"] = cuda_ms(lambda: ss2d_scan_pair(x32, *args[1:]), 20)
            row["plain_ms"] = plain_ms
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k1_bound(
                1, h * w, 64, 16, 2, 2, y_dtype.itemsize)
        row["launches"] = ss2d_scan_pair.launches
        emit(row)
        rows.append(row)
        del y, again, y_plain, args
    return rows


OUTPUTS = ("dx", "dwx", "ddtw", "dbias", "dA", "ddsk")
# The warps each backward design holds resident on an SM in bwd_local and
# bwd_main at the least, as the card's occupancy query reports them.
K2_MIN_WARPS = {"bwd_local": 16, "bwd_main": 16}
K4_MIN_WARPS = {"bwd_local": 32, "bwd_main": 16}


def bwd_geometry(kernel, plan, occ, min_warps):
    """The launch geometry of K2's or K4's `bwd_local` and `bwd_main` for a
    `k2` / `k4` row: the plan's grid and residency (`scan_cuda.k2_plan` /
    `k4_plan`) beside what the card reports for the same launch
    (`k2_occupancy` / `k4_occupancy`, registers included). Fails where the
    launch's threads or shared memory are not the plan's, where the card lets
    fewer blocks of either kernel reside than planned, or where a kernel has
    fewer warps an SM than `min_warps` holds for it."""
    kernels = ("local", "main")
    check(all(occ[k] == plan[k] for k in ("threads", "smem_local", "smem_main")),
          f"{kernel} launches {occ} as {kernel.lower()}_plan planned {plan}")
    warps = {f"bwd_{k}": occ[f"blocks_per_sm_{k}"] * occ["threads"] // 32 for k in kernels}
    for k in kernels:
        check(occ[f"blocks_per_sm_{k}"] >= plan[f"blocks_per_sm_{k}"],
              f"{kernel} bwd_{k}: {occ[f'blocks_per_sm_{k}']} blocks an SM, "
              f"{plan[f'blocks_per_sm_{k}']} planned")
    check(all(warps[k] >= min_warps[k] for k in warps), f"{kernel}'s warps an SM {warps} >= {min_warps}")
    return {"threads": occ["threads"],
            "smem_bytes": {f"bwd_{k}": occ[f"smem_{k}"] for k in kernels},
            "blocks_per_sm": {f"bwd_{k}": occ[f"blocks_per_sm_{k}"] for k in kernels},
            "warps_per_sm": warps,
            "planned_warps_per_sm": {f"bwd_{k}": plan[f"warps_per_sm_{k}"] for k in kernels},
            "gx": plan["gx"]}


def k2_geometry(plan, occ):
    return bwd_geometry("K2", plan, occ, K2_MIN_WARPS)


def k4_geometry(plan, occ):
    return bwd_geometry("K4", plan, occ, K4_MIN_WARPS)


def k2_row_geometry(B, L, streams):
    """`k2_geometry` at a k2 row's shape (D=64, N=16, R=2) and (x, dy) dtypes
    on this card."""
    from wavemamba_torch.ops.scan_cuda import CHUNK, k2_occupancy, k2_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return k2_geometry(k2_plan(B, L, 64, 16, 2, CHUNK, sms), k2_occupancy(R=2, streams=streams))


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
               "tol_rel": K2_RTOL, "k1": fwd_err, "max_abs_err": {}, "max_rel_err": {},
               "geometry": k2_row_geometry(B, L, F32_STREAMS)}
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


def phase_k2_bf16(dy_dtype=torch.bfloat16):
    """K2 on bf16 x and dx with `dy_dtype` dy: bf16 (the fast training
    preset; K1's y bf16 too) or float32 (rows `*_mixed`, the proc ymls' mix:
    K1's y float32), against its plain version on the same inputs, at
    the three LFSS levels of a training step (batch 8, as `phase_k2`) and, on
    bf16 dy, a ragged length and a column stream; K1's y and carries at the
    same shapes; times and bounds. Both versions round each member's dx to
    bf16 and add the two in bf16, so an element may differ by one bf16 step
    of either member's dx: the plain version's members (from dy with the
    other member's half zeroed) set that step."""
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain, ss2d_scan_pair_plain_bwd
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd

    bf16 = torch.bfloat16
    mixed = dy_dtype == torch.float32
    rs = np.random.RandomState(19 if mixed else 9)
    rows = []
    tag = "mixed" if mixed else "bf16"
    cases = [(f"level{i + 1}_{tag}", TRAIN_BATCH, L, 1, False) for i, L in enumerate(TRAIN_LENGTHS)]
    if not mixed:
        cases += [("ragged_bf16", 1, 1000, 1, False), ("columns_bf16", 1, 48 * 80, 48, True)]
    for name, B, L, h, columns in cases:
        args = pair_inputs(rs, B, L)
        x = args[0].to(bf16)
        if columns:
            x = x.view(B, h, L // h, -1).transpose(1, 2).reshape(B, L, -1).contiguous()
        args = (x,) + args[1:]
        dy = torch.from_numpy(rs.randn(B, 2, L, 64).astype(np.float32)).cuda().to(dy_dtype)
        y, state, sumda = ss2d_scan_pair(*args, return_carries=True, out_dtype=dy_dtype)
        got = ss2d_scan_pair_bwd(*args, state, sumda, dy)
        again = ss2d_scan_pair_bwd(*args, state, sumda, dy)
        torch.cuda.synchronize()
        y_plain, state_plain, sumda_plain = ss2d_scan_pair_plain(*args, return_carries=True,
                                                                 out_dtype=dy_dtype)
        fwd_err = {"y": float((y.float() - y_plain.float()).abs().max()),
                   "state": float((state - state_plain).abs().max()),
                   "sumda": float((sumda - sumda_plain).abs().max())}
        if mixed:  # float32 y from the same bf16 x: the float32 rows' tolerance
            check(y.dtype == torch.float32 and fwd_err["y"] <= K1_ATOL, f"K1 {name} B={B}: y {fwd_err}")
        else:
            y_excess, fwd_err["y_share_differing"] = bf16_excess(y, y_plain, K1_ATOL)
            check(y.dtype == bf16 and y_excess <= 0, f"K1 {name} B={B}: y beyond one bf16 step by {y_excess}")
        check(max(fwd_err["state"], fwd_err["sumda"]) <= K1_ATOL, f"K1 {name} B={B}: carries {fwd_err}")
        del y, y_plain, sumda_plain
        want, plain_ms = timed_once(lambda: ss2d_scan_pair_plain_bwd(*args, state_plain, dy))
        member = None
        for k in (0, 1):  # each member's dx: dy of the other member zeroed
            dyk = dy.clone()
            dyk[:, 1 - k] = 0
            mk = ss2d_scan_pair_plain_bwd(*args, state_plain, dyk)[0].float().abs()
            member = mk if member is None else torch.maximum(member, mk)
            del dyk, mk
        check(got[0].dtype == bf16 and all(g.dtype == torch.float32 for g in got[1:]),
              f"K2 {name}: dx in bf16, the weights' gradients in float32")
        check(all(torch.equal(g, g2) for g, g2 in zip(got, again)), f"K2 {name}: the same bits twice")
        excess, share = bf16_excess(got[0], want[0], BF16_STEP * member
                                    + K2_RTOL * float(want[0].float().abs().max()))
        check(excess <= 0, f"K2 {name}: dx beyond one bf16 step of the plain version by {excess}")
        rel = {k: float((g - w_).abs().max()) / float(w_.abs().max())
               for k, g, w_ in zip(OUTPUTS[1:], got[1:], want[1:])}
        check(max(rel.values()) <= K2_RTOL, f"K2 {name}: weight gradients {rel}")
        row = {"phase": "k2", "case": name, "B": B, "L": L, "D": 64, "N": 16, "R": 2,
               "x": "bfloat16", "dy": str(dy_dtype).removeprefix("torch."), "dx": "bfloat16",
               "k1": fwd_err,
               "max_abs_err": {"dx": float((got[0].float() - want[0].float()).abs().max())},
               "dx_share_differing": share, "max_rel_err": rel,
               "tol": f"dx one bf16 step of it and of each member's dx; {K2_RTOL}",
               "geometry": k2_row_geometry(B, L, (bf16, dy_dtype))}
        if B == TRAIN_BATCH:
            row["ms"] = cuda_ms(lambda: ss2d_scan_pair_bwd(*args, state, sumda, dy), 10)
            row["plain_ms"] = plain_ms
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k2_bound(
                B, L, 64, 16, 2, stream_bytes=2, dy_bytes=dy_dtype.itemsize)
        row["launches"] = ss2d_scan_pair_bwd.launches
        emit(row)
        rows.append(row)
        del got, again, want, member, state, sumda, state_plain, args, dy
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
K4_PHASES = ("local", "prefix", "main", "reduce")
K3_PHASES = ("pass1", "prefix", "replay")
K3_KERNELS = ("selective_chunk<false>", "selective_chunk<true>", "selective_prefix")


def k3_phase_of(kernel):
    """Which of K3's three kernels a profiler name is: pass 1
    (`selective_chunk<16, false>`), the chunk prefix (`selective_prefix`), or
    the replay (`selective_chunk<16, true>`); None for any other kernel."""
    if "selective_prefix" in kernel:
        return "prefix"
    if "selective_chunk<" in kernel:
        return "replay" if "true" in kernel else "pass1"
    return None


def k3_geometry(plan, occ):
    return scan_geometry("K3", K3_KERNELS, plan, occ)


def k3_row_geometry(B, L):
    """`k3_geometry` at a k3 row's shape (K=4, D=64, N=16) on this card."""
    from wavemamba_torch.ops.scan_cuda import CHUNK, k3_occupancy, k3_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return k3_geometry(k3_plan(B, 4, L, 64, 16, CHUNK, sms), k3_occupancy(D=64, L=L))


def k4_row_geometry(B, L):
    """`k4_geometry` at a k4 row's shape (K=4, D=64, N=16) on this card."""
    from wavemamba_torch.ops.scan_cuda import CHUNK, k4_occupancy, k4_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return k4_geometry(k4_plan(B, 4, L, 64, 16, CHUNK, sms), k4_occupancy(D=64))


def k4_phase_of(kernel):
    """Which of K4's four kernels a profiler name is: the local adjoint
    (`bwd_local`), the chunk prefix, the gradients (`bwd_main`) or the
    reduction of the blocks' partial sums; None for any other kernel. K2
    names its kernels alike: a profile that holds K4 holds no K2."""
    for phase, key in (("local", "bwd_local<"), ("prefix", "bwd_prefix"), ("main", "bwd_main<"),
                       ("reduce", "bwd_reduce")):
        if key in kernel:
            return phase
    return None


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
        again = selective_scan_cuda(*args, return_carries=True)
        torch.cuda.synchronize()
        for key, g, g2 in zip(("y", "state", "sumda"), (y, state, sumda), again):
            check(torch.equal(g, g2), f"K3 {name} {key}: the same bits on a second run")
        del again
        (y_plain, state_plain, sumda_plain), plain_ms = timed_once(
            lambda: selective_scan_plain(*args, return_carries=True))
        err = {"y": float((y - y_plain).abs().max()), "state": float((state - state_plain).abs().max()),
               "sumda": float((sumda - sumda_plain).abs().max())}
        check(bool(torch.isfinite(y).all()), f"K3 {name}: finite")
        check(max(err.values()) <= K3_ATOL, f"K3 {name}: y and carries {err} <= {K3_ATOL}")
        row = {"phase": "k3", "case": name, "B": B, "K": 4, "L": L, "D": 64, "N": 16,
               "max_abs_err": err["y"], "carries_err": err, "tol": K3_ATOL,
               "y_max_abs": float(y_plain.abs().max()), "geometry": k3_row_geometry(B, L)}
        del y, y_plain, sumda_plain
        if name != "ragged":
            call = lambda: selective_scan_cuda(*args)
            row["ms"] = cuda_ms(call, 10)
            row["phases_ms"] = kernel_phases(call, k3_phase_of, K3_PHASES, "K3")
            row["clocks_sm_mhz"], row["power_draw_w"] = clocks_under_load(call)
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
                   "tol_rel": K4_RTOL, "max_abs_err": {}, "max_rel_err": {},
                   "geometry": k4_row_geometry(B, L)}
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
                call = lambda: selective_scan_cuda_bwd(*args, state, sumda, dy)
                row["ms"] = cuda_ms(call, 10)
                row["phases_ms"] = kernel_phases(call, k4_phase_of, K4_PHASES, "K4")
                row["clocks_sm_mhz"], row["power_draw_w"] = clocks_under_load(call)
                row["plain_ms"] = plain_ms
                row["bound_ms"], row["bound_by"], row["bound_unit"] = k4_bound(B, 4, L, 64, 16)
            row["launches"] = selective_scan_cuda_bwd.launches
            emit(row)
            k4_rows.append(row)
            del dy
        del args, state, sumda, state_plain
        torch.cuda.empty_cache()
    return k3_rows, k4_rows


K5_KERNELS = ("chunk_scan_ssd<false>", "chunk_scan_ssd<true>", "chunk_prefix")
K5_OUTPUTS = ("y", "state", "sumda")


def k5_geometry(plan, occ):
    return scan_geometry("K5", K5_KERNELS, plan, occ)


def k5_row_geometry(B, L, streams):
    """`k5_geometry` at a k5 row's shape (D=64, N=16, R=2, sub 8) and (x, y)
    dtypes on this card."""
    from wavemamba_torch.ops.scan_cuda import CHUNK, k5_occupancy, k5_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return k5_geometry(k5_plan(B, L, 64, 16, 2, CHUNK, 8, sms), k5_occupancy(D=64, R=2, streams=streams))


def k5_loops():
    """Issued instructions a MUFU in the hot loops of K5's two passes (the
    float32 build, R = 2), from the library's SASS."""
    from wavemamba_torch.ops import scan_cuda
    from wavemamba_torch.scripts.gpu_probe import sass_loop
    from wavemamba_torch.scripts.k5_variants import TEMPLATES

    lib = scan_cuda.build(scan_cuda.SOURCE_K5)
    return {name: {k: v for k, v in sass_loop("chunk_scan_ssd", lib, "MUFU", tag).items()
                   if k != "opcodes"} for name, tag in TEMPLATES[False].items()}


def phase_k5():
    """K5 at K1's shapes: on float32 streams against its plain version (y,
    carries; the level-1 plain run, timed, is the one compared) and against
    K1 on the same inputs, at the three levels of a 1080p forward, a ragged
    length and a column stream; on bf16 x with bf16 y and with float32 y
    against the plain version on the same bf16 x at level 3 and the ragged
    length (y within one bf16 step of it with bf16 y, within K5_ATOL with
    float32 y; the carries within K5_ATOL), and timed at level 1. Every row
    the same bits twice; the timed ones with `phases_ms`, the SM clock and
    power under load, and the launch geometry against `scan_cuda.k5_plan`."""
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
        err = {k: float((g - p_).abs().max()) for k, g, p_ in zip(K5_OUTPUTS, got, plain)}
        vs_k1 = {k: float((g - p_).abs().max()) for k, g, p_ in zip(K5_OUTPUTS, got, k1)}
        check(all(bool(torch.isfinite(g).all()) for g in got), f"K5 {name}: finite")
        check(all(torch.equal(g, g2) for g, g2 in zip(got, again)), f"K5 {name}: the same bits twice")
        check(max(err.values()) <= K5_ATOL, f"K5 {name}: against its plain version {err}")
        check(max(vs_k1.values()) <= K5_ATOL, f"K5 {name}: against K1 {vs_k1}")
        row = {"phase": "k5", "case": name, "B": 1, "L": h * w, "D": 64, "N": 16, "R": 2, "sub": 8,
               "max_abs_err": err["y"], "carries_err": err, "vs_k1_err": vs_k1, "tol": K5_ATOL,
               "y_max_abs": float(plain[0].abs().max()),
               "geometry": k5_row_geometry(1, h * w, F32_STREAMS)}
        del got, again, k1, plain
        if name == "level1":  # the one plain run timed, as K1's
            row["plain_ms"] = plain_ms
            row["sass_loop"] = k5_loops()
        if not columns and name != "ragged":
            k1_timings(row, lambda: ss2d_scan_pair(*args, variant="ssd"), k5_phase_of, "K5")
            row["k1_ms"] = cuda_ms(lambda: ss2d_scan_pair(*args), 20)
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k5_bound(1, h * w, 64, 16, 2)
            row["k1_bound_ms"] = k1_bound(1, h * w, 64, 16, 2)[0]
        row["launches"] = ss2d_scan_pair_ssd.launches
        emit(row)
        rows.append(row)
        del args
    for y_dtype in (torch.bfloat16, torch.float32):
        rows += k5_bf16_rows(rs, y_dtype)
    return rows


def k5_bf16_rows(rs, y_dtype):
    """`phase_k5`'s rows on bf16 x with `y_dtype` y (`_bf16`: bf16, the fast
    presets' pair; `_mixed`: float32, the proc ymls')."""
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_ssd

    mixed = y_dtype == torch.float32
    tag = "mixed" if mixed else "bf16"
    rows = []
    (h1, w1), (h3, w3) = LEVELS_1080P[0], LEVELS_1080P[2]
    for name, L in ((f"level3_{tag}", h3 * w3), (f"ragged_{tag}", 34560 + 37), (f"level1_{tag}", h1 * w1)):
        args = pair_inputs(rs, 1, L)
        args = (args[0].to(torch.bfloat16),) + args[1:]
        call = lambda **kw: ss2d_scan_pair(*args, variant="ssd", out_dtype=y_dtype, **kw)
        got, again = call(return_carries=True), call(return_carries=True)
        torch.cuda.synchronize()
        check(got[0].dtype == y_dtype and all(bool(torch.isfinite(g.float()).all()) for g in got),
              f"K5 {name}: {y_dtype}, finite")
        check(all(torch.equal(g, g2) for g, g2 in zip(got, again)), f"K5 {name}: the same bits twice")
        row = {"phase": "k5", "case": name, "B": 1, "L": L, "D": 64, "N": 16, "R": 2, "sub": 8,
               "x": "bfloat16", "y": str(y_dtype).removeprefix("torch.")}
        if not name.startswith("level1"):  # the plain version at level 1 takes seconds
            plain = ss2d_scan_pair_plain(*args, return_carries=True, variant="ssd", sub=8,
                                         out_dtype=y_dtype)
            err = {k: float((g.float() - p_.float()).abs().max()) for k, g, p_ in zip(K5_OUTPUTS, got, plain)}
            check(max(err["state"], err["sumda"]) <= K5_ATOL, f"K5 {name}: carries {err}")
            if mixed:
                check(err["y"] <= K5_ATOL, f"K5 {name}: max abs err {err} <= {K5_ATOL}")
                row["tol"] = K5_ATOL
            else:
                excess, share = bf16_excess(got[0], plain[0], K5_ATOL)
                check(excess <= 0, f"K5 {name}: beyond one bf16 step of the plain version by {excess}")
                row.update(share_differing=share, tol=f"one bf16 step + {K5_ATOL}")
            row.update(max_abs_err=err["y"], carries_err=err, y_max_abs=float(plain[0].float().abs().max()))
            del plain
        else:
            x32 = args[0].float()
            row["geometry"] = k5_row_geometry(1, L, (torch.bfloat16, y_dtype))
            k1_timings(row, lambda: call(), k5_phase_of, "K5")
            row["f32_ms"] = cuda_ms(lambda: ss2d_scan_pair(x32, *args[1:], variant="ssd"), 20)
            row["bound_ms"], row["bound_by"], row["bound_unit"] = k5_bound(1, L, 64, 16, 2)
        row["launches"] = ss2d_scan_pair_ssd.launches
        emit(row)
        rows.append(row)
        del got, again, args
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
         lambda x: x * lfss.skip_scale2.to(x.dtype).view(1, -1, 1, 1) + lfss.conv_blk(lfss.ln_2(x)),
         32, level1),
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


def chain_errors_bf16(got, want):
    """`chain_errors` for a bf16 output against the plain chain's bf16 output on
    the same bf16 input: both compute in float32 and round once, so an element
    may also differ by one bf16 step where the two float32 values fall on two
    sides of a rounding boundary. The share beyond one step plus the tight
    bound, and (`bf16_excess`) the worst excess over one step plus the loose
    bound, of `want`'s max abs value (<= 0 passes)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    scale = float(w.abs().max())
    beyond = d > BF16_STEP * w.abs() + CHAIN_TIGHT_REL * scale
    excess, differing = bf16_excess(got, want, CHAIN_LOOSE_REL * scale)
    return {"max_abs_err": float(d.max()), "max_rel_err": float(d.max()) / scale,
            "share_beyond_tight": float(beyond.float().mean()), "loose_excess": excess / scale,
            "share_differing": differing}


def check_chain(name, err):
    check(1.0 - err["share_beyond_tight"] >= CHAIN_TIGHT_SHARE,
          f"{name}: {err['share_beyond_tight']} of the elements beyond {CHAIN_TIGHT_REL} of the max")
    if "loose_excess" in err:  # bf16: one bf16 step more
        check(err["loose_excess"] <= 0, f"{name}: {err['loose_excess']} beyond a bf16 step + "
              f"{CHAIN_LOOSE_REL} of the max")
    else:
        check(err["max_rel_err"] <= CHAIN_LOOSE_REL, f"{name}: max rel err {err['max_rel_err']}")


@torch.no_grad()
def phase_chain(stock, per_forward):
    """The chain kernel from both entry points against the plain version, for
    every wrapper, on a float32 and on a bf16 input; `per_forward`: each
    wrapper's launches in a forward of the serve path (`serve_fused`). The
    bf16 rows time the stock modules and `F.conv2d` on the same bf16 input."""
    import torch.nn.functional as F

    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.ops.conv_fused_cuda import chain_plan

    rs = np.random.RandomState(6)
    rows = []
    for name, call, stock_call, c, (h, w) in chain_cases(stock):
        wrapper = name.split()[0]
        by_dtype = {dtype: {"phase": "chain", "chain": name, "dtype": str(dtype).split(".")[1],
                            "shape": [1, c, h, w], "launches_per_forward": per_forward.get(wrapper, 0)}
                    for dtype in (torch.float32, torch.bfloat16)}
        for shape in ((h, w), (17, 130)):  # the 1080p shape, then an odd one for the borders
            # One float32 draw per shape (the draws of earlier runs), rounded for the bf16 row.
            x32 = torch.from_numpy((rs.randn(1, c, *shape) * 0.5).astype(np.float32)).cuda()
            for dtype, row in by_dtype.items():
                x = x32.to(dtype)
                stages = chain_stages(call, x)
                specs = cf._specs(c, stages)
                band = cf.fused_chain_band(x, stages)
                band2 = cf.fused_chain_band(x, stages)
                tile = cf.fused_chain(x, stages)
                tile2 = cf.fused_chain(x, stages)
                torch.cuda.synchronize()
                plain, plain_ms = timed_once(lambda: cf.fused_chain_plain(x, stages))
                label = f"{name} {row['dtype']} {shape}"
                check(band.dtype == dtype and bool(torch.isfinite(band).all()), f"{label}: finite, {dtype}")
                check(torch.equal(band, band2) and torch.equal(tile, tile2), f"{label}: the same bits twice")
                check(torch.equal(band, tile), f"{label}: K7 and K6 compute the same bits")
                err = chain_errors(band, plain) if dtype == torch.float32 else chain_errors_bf16(band, plain)
                check_chain(label, err)
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
                        wt, bt = (t.to(dtype) for t in stages[0][1:3])
                        row["library_ms"] = cuda_ms(lambda: F.conv2d(x, wt, bt, padding=1), 10)
                    (row["bound_ms"], row["bound_by"], row["bound_unit"],
                     tensor_ops) = chain_bound(c, specs, h * w, act_bytes=x.element_size())
                    row["tensor_tflops"] = tensor_ops / row["ms"] / 1e9
                del band, band2, tile, tile2, plain, x
        for row in by_dtype.values():
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
    K2 (the op `scan_cuda.ss2d_scan_pair_fwd`) are held against in the `grad` phase."""

    @staticmethod
    def forward(ctx, x, wx, dtw, bias, A, dsk, out_dtype):
        from wavemamba_torch.ops.scan import ss2d_scan_pair_plain

        y, state, _ = ss2d_scan_pair_plain(x, wx, dtw, bias, A, dsk, return_carries=True,
                                           out_dtype=out_dtype)
        ctx.save_for_backward(x, wx, dtw, bias, A, dsk, state)
        return y

    @staticmethod
    def backward(ctx, dy):
        from wavemamba_torch.ops.scan import ss2d_scan_pair_plain_bwd

        return ss2d_scan_pair_plain_bwd(*ctx.saved_tensors, dy) + (None,)


def plain_scan_pair(x, wx, dtw, bias, A, dsk, out_dtype=None):
    """`PlainScanPair` with `ss2d_scan_pair`'s signature, for `set_scan`."""
    return PlainScanPair.apply(x, wx, dtw, bias, A, dsk, out_dtype)


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


def model_grads(model, tcfg, lq, gt):
    """Loss and every parameter's gradient of one forward and backward."""
    from wavemamba_torch.train.trainer import loss_fn

    model.zero_grad(set_to_none=True)
    total, _ = loss_fn(model, tcfg, lq, gt)
    total.backward()
    return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


SCAN_LEAVES = ("x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs", "Ds")  # K2's sums


def fast_grad_readings(grads_k, grads_p, grads_32):
    """The bf16 route's gradients with K1 + K2 (`grads_k`) against those with
    the plain scan and backward (`grads_p`), both on bf16 streams, with the
    float32 plain route's (`grads_32`) as the measure of bf16 noise. Per leaf:
    |k - p|, |p - f32| and |f32| (2-norms). Returns the readings and the list
    of what fails (see GRAD_FAST_SCAN_RTOL)."""
    norm = lambda t: float(t.double().norm())
    leaves = {n: (norm(grads_k[n] - grads_p[n]), norm(grads_p[n] - g), norm(g))
              for n, g in grads_32.items()}
    live = {n: v for n, v in leaves.items() if v[2] > 0}
    scan = {n: v for n, v in live.items() if n.endswith(SCAN_LEAVES)}
    total = lambda i: float(np.sqrt(sum(v[i] ** 2 for v in leaves.values())))
    worst = max(scan, key=lambda n: scan[n][0] / scan[n][2])
    r = {"norm_kernel_vs_plain": total(0) / total(2), "norm_plain_vs_float32": total(1) / total(2),
         "median_leaf_kernel_vs_plain": float(np.median([v[0] / v[2] for v in live.values()])),
         "median_leaf_plain_vs_float32": float(np.median([v[1] / v[2] for v in live.values()])),
         "leaves": len(leaves), "scan_leaves": len(scan), "worst_scan_leaf": worst,
         "worst_scan_leaf_rel_err": scan[worst][0] / scan[worst][2],
         "worst_scan_leaf_plain_vs_float32": max(v[1] / v[2] for v in scan.values())}
    failures = [k for k, bad in (
        ("norm", r["norm_kernel_vs_plain"] > r["norm_plain_vs_float32"]),
        ("median leaf", r["median_leaf_kernel_vs_plain"] > r["median_leaf_plain_vs_float32"]),
        ("scan leaf", r["worst_scan_leaf_rel_err"] > GRAD_FAST_SCAN_RTOL)) if bad]
    return r, failures


def phase_grad(route):
    """Loss and gradients of the whole model, the route's kernels against its
    plain scan with the plain backward: 'fused' is K1 + K2 (28 + 28 launches),
    'fast' the same on bf16 streams (`fast_train()`'s dtypes), 'mixed' on
    bf16 compute with float32 scan streams (the proc ymls': bf16 x, float32
    y and dy), 'unfused' (`scan_impl: pallas`) K3 + K4 (14 + 14). 'fast' and
    'mixed' also read both against the float32 plain route's gradients on
    the same weights, and show that their check fails on a planted K2 fault
    (dA off by GRAD_FAST_PLANT)."""
    from wavemamba_torch.models import init_network
    from wavemamba_torch.models.wavemamba import set_scan, set_unfused_scan
    from wavemamba_torch.ops import scan_cuda
    from wavemamba_torch.train.trainer import TrainConfig

    fused = route in ("fused", "fast", "mixed")
    bf16 = route in ("fast", "mixed")
    net = {"type": "WaveMamba", "remat": False, "scan_impl": "pallas_fused" if fused else "pallas"}
    if bf16:
        net.update(compute_dtype="bfloat16", scan_dtype="bfloat16" if route == "fast" else "float32")
    loss_tol = GRAD_FAST_LOSS_RTOL if bf16 else GRAD_LOSS_RTOL
    model = init_network(net, torch.Generator().manual_seed(11), device="cuda")
    lq, gt = synthetic_batch(12, 2, 128)
    tcfg = TrainConfig()
    results = []
    wrappers = (scan_cuda.ss2d_scan_pair, scan_cuda.ss2d_scan_pair_bwd,
                scan_cuda.selective_scan_cuda, scan_cuda.selective_scan_cuda_bwd)
    before = [w.launches for w in wrappers]
    scans = (scan_cuda.ss2d_scan_pair, plain_scan_pair) if fused else (None, PlainSelectiveScan.apply)
    for scan in scans:
        (set_scan if fused else set_unfused_scan)(model, scan)
        results.append(model_grads(model, tcfg, lq, gt))
    launched = tuple(w.launches - b for w, b in zip(wrappers, before))
    check(launched == ((28, 28, 0, 0) if fused else (0, 0, 14, 14)),
          f"{launched} K1/K2/K3/K4 launches in one forward and backward of the {route} route")
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(((float((grads_k[n] - g).abs().max()) / (float(g.abs().max()) + 1e-30), n)
                 for n, g in grads_p.items()))
    check(all(bool(torch.isfinite(g).all()) for g in grads_k.values()), "gradients finite")
    row = {"phase": "grad", "route": route, **{k: net[k] for k in ("compute_dtype", "scan_dtype") if k in net},
           "image": [128, 128], "batch": 2, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_rel_err": loss_rel, "loss_tol": loss_tol,
           "parameters": len(grads_p), "worst_grad_rel_err": worst[0], "worst_grad": worst[1],
           "max_grad_abs_err": max(float((grads_k[n] - g).abs().max()) for n, g in grads_p.items())}
    check(loss_rel <= loss_tol, f"loss kernel vs plain {loss_rel} <= {loss_tol}")
    if not bf16:
        emit({**row, "grad_tol": GRAD_RTOL, "grad_tol_of": "each gradient's max"})
        check(worst[0] <= GRAD_RTOL, f"gradient of {worst[1]}: {worst[0]} <= {GRAD_RTOL}")
        return

    ref = init_network({"type": "WaveMamba", "remat": False}, torch.Generator().manual_seed(11),
                       device="cuda")
    ref.load_state_dict(model.state_dict())
    set_scan(ref, plain_scan_pair)
    loss_32, grads_32 = model_grads(ref, tcfg, lq, gt)
    del ref
    readings, failures = fast_grad_readings(grads_k, grads_p, grads_32)
    leaf = lambda g: g[worst[1]].flatten()[:8].tolist()
    row.update(readings, loss_float32=loss_32, grad_scan_leaf_tol=GRAD_FAST_SCAN_RTOL,
               worst_grad_values={"kernel": leaf(grads_k), "plain": leaf(grads_p),
                                  "float32": leaf(grads_32)})

    # The check against a planted fault: K2's dA off by GRAD_FAST_PLANT.
    real = scan_cuda.ss2d_scan_pair_bwd

    def planted(*args):
        out = real(*args)
        return out[:4] + (out[4] * (1 + GRAD_FAST_PLANT),) + out[5:]

    planted.launches = 0  # the wrapper counts under its module-level name
    set_scan(model, scan_cuda.ss2d_scan_pair)
    scan_cuda.ss2d_scan_pair_bwd = planted
    try:
        _, grads_f = model_grads(model, tcfg, lq, gt)
    finally:
        scan_cuda.ss2d_scan_pair_bwd = real
    planted_readings, planted_failures = fast_grad_readings(grads_f, grads_p, grads_32)
    row["planted_fault"] = {"dA_scale": 1 + GRAD_FAST_PLANT, "fails": planted_failures, **planted_readings}
    emit(row)
    check(not failures, f"bf16 gradients, kernels vs plain against bf16 noise: {failures}")
    check(bool(planted_failures), f"the check misses K2's dA off by {GRAD_FAST_PLANT}")


# The uhdll yml's recompute, and the two it is read against: none, the
# 'full' policy (K1 again in the recompute) and 'save_scan', which every
# shipped train yml runs (the default: they set no `remat` / `remat_policy`).
# K1 and K2 launches a step under each.
TRAIN_POLICIES = {None: (28, 28), "full": (56, 28), "save_scan": (28, 28)}


def train_setup(policy, seed=21):
    """A trainer with the uhdll yml's settings, recomputing blocks under
    `policy` (None: no recompute)."""
    from wavemamba_torch.models import init_network
    from wavemamba_torch.train.trainer import TrainConfig, create_train_state, make_train_step

    tcfg = TrainConfig(lr=5e-4, weight_decay=1e-3, betas=(0.9, 0.99), scheduler=SCHEDULER,
                       pixel_weight=1.0, fft_weight=0.1, ema_decay=EMA_DECAY)
    net = {"type": "WaveMamba", "remat": policy is not None}
    if policy is not None:
        net["remat_policy"] = policy
    model = init_network(net, torch.Generator().manual_seed(seed), device="cuda")
    return create_train_state(model, tcfg), make_train_step(tcfg), tcfg


def train_run(policy, lq, gt):
    """Loss and every gradient of the seeded fresh model on the batch, then one
    warm-up step and TRAIN_STEPS steps on it, recomputing under `policy`. A
    step that does not fit the card's memory fails the run."""
    from wavemamba_torch.checkpoint import save_training_state
    from wavemamba_torch.models import param_count
    from wavemamba_torch.ops.scan_cuda import record_x_digests, ss2d_scan_pair, ss2d_scan_pair_bwd
    from wavemamba_torch.train.trainer import make_lr

    state, step, tcfg = train_setup(policy)
    check(param_count(state.model) == 1_512_718, "the shipped config has 1,512,718 parameters")
    check(state.model.cfg.remat == (policy is not None), f"remat under {policy}")
    # Under 'save_scan' K2 reads the recompute's x beside the forward's
    # carries: the gradients' step digests both x of each of its 28 ops.
    with record_x_digests() as x_record:
        grad_loss, grads = model_grads(state.model, tcfg, lq, gt)
    x_digests = {"ops": len(x_record.pairs), "matched": x_record.matched()}
    if policy == "save_scan":
        check(x_digests == {"ops": 28, "matched": 28},
              f"save_scan: the recompute hands each op the forward's x, bit for bit: {x_digests}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, lq, gt)  # warm-up: cuDNN plans, the allocator's pool
    warm_loss = float(m["total"])
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

    k1_per_step, k2_per_step = TRAIN_POLICIES[policy]
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "losses finite")
    check(losses[-1] < warm_loss, f"the loss fell on the repeated batch: {warm_loss} -> {losses[-1]}")
    check((k1_launches, k2_launches) == (k1_per_step * TRAIN_STEPS, k2_per_step * TRAIN_STEPS),
          f"{k1_launches} K1 / {k2_launches} K2 launches in {TRAIN_STEPS} steps under {policy}")
    check(state.step == TRAIN_STEPS + 1, "the step count")
    ms = float(np.median(times))
    return dict(state=state, step=step, tcfg=tcfg, lq=lq, gt=gt, policy=policy, saved=saved,
                ms_per_step=ms, step_ms=times, losses=losses, warm_loss=warm_loss, peak=peak,
                grad_loss=grad_loss, grads=grads, k1_launches=k1_launches,
                k2_launches=k2_launches, lr=lr(TRAIN_STEPS), x_digests=x_digests)


def phase_train():
    """The trainer at full width and depth on one fixed seeded batch of
    TRAIN_BATCH images, under each of TRAIN_POLICIES in turn, from the same
    seeded init: ms a step, peak memory, K1 / K2 launches a step, the loss,
    and the gradients under 'full' and 'save_scan' against those without
    recompute (GRAD_RTOL of each gradient's max). Returns the runs by
    policy; the 'save_scan' one, the shipped ymls' setting, serves the later
    phases."""
    lq, gt = synthetic_batch(22, TRAIN_BATCH, TRAIN_SIZE)
    runs = {}
    for policy in TRAIN_POLICIES:
        run = runs[policy] = train_run(policy, lq, gt)
        row = {"phase": "train", "batch": TRAIN_BATCH, "size": [TRAIN_SIZE, TRAIN_SIZE],
               "remat": policy is not None, "remat_policy": policy, "steps": TRAIN_STEPS,
               "loss_first": run["warm_loss"], "losses": run["losses"], "step_ms": run["step_ms"],
               "ms_per_step": run["ms_per_step"], "images_per_s": TRAIN_BATCH / run["ms_per_step"] * 1e3,
               "peak_memory_bytes": run["peak"], "k1_launches": run["k1_launches"],
               "k2_launches": run["k2_launches"],
               "k1_per_step": run["k1_launches"] / TRAIN_STEPS,
               "k2_per_step": run["k2_launches"] / TRAIN_STEPS, "lr": run["lr"],
               "grad_loss": run["grad_loss"]}
        if policy is not None:
            base = runs[None]
            worst = max((float((run["grads"][n] - g).abs().max()) / (float(g.abs().max()) + 1e-30), n)
                        for n, g in base["grads"].items())
            loss_rel = abs(run["grad_loss"] - base["grad_loss"]) / abs(base["grad_loss"])
            row.update(vs_no_recompute={"loss_rel_err": loss_rel, "worst_grad_rel_err": worst[0],
                                        "worst_grad": worst[1], "grad_tol": GRAD_RTOL,
                                        "loss_tol": GRAD_LOSS_RTOL,
                                        "equal_bits": all(torch.equal(run["grads"][n], g)
                                                          for n, g in base["grads"].items())})
            row["ms_vs_no_recompute"] = run["ms_per_step"] - base["ms_per_step"]
            if policy == "save_scan":
                row["x_digests"] = run["x_digests"]  # ops of a step, and those whose x matched
                row["ms_vs_full"] = run["ms_per_step"] - runs["full"]["ms_per_step"]
                row["peak_vs_full_bytes"] = run["peak"] - runs["full"]["peak"]
        emit(row)
        if policy is not None:
            check(loss_rel <= GRAD_LOSS_RTOL, f"{policy}: loss {loss_rel} <= {GRAD_LOSS_RTOL} of no recompute's")
            check(worst[0] <= GRAD_RTOL, f"{policy}: gradient of {worst[1]} {worst[0]} <= {GRAD_RTOL}")
            del run["grads"]
    del runs[None]["grads"]
    compare_policies(runs, lq, gt)
    return runs


def compare_policies(runs, lq, gt):
    """'save_scan' against 'full' in POLICY_TURNS turns of one step each, the
    order alternating, so that both meet the same state of the machine (the
    runs above come one after the other): the median step of each, their
    spread (the distance between quartiles), the turns 'save_scan' won, and
    the K1 / K2 launches of every step. The verdict is 'faster' or 'slower'
    where the medians differ by more than 'full''s spread, else
    'unresolved'. Fails where 'save_scan' is slower."""
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd

    times = {"full": [], "save_scan": []}
    for turn in range(POLICY_TURNS):
        for policy in ("full", "save_scan") if turn % 2 == 0 else ("save_scan", "full"):
            run = runs[policy]
            ss2d_scan_pair.launches = ss2d_scan_pair_bwd.launches = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run["state"], m = run["step"](run["state"], lq, gt)
            end.record()
            end.synchronize()
            times[policy].append(start.elapsed_time(end))
            check(np.isfinite(float(m["total"])), f"{policy}: loss finite in turn {turn}")
            check((ss2d_scan_pair.launches, ss2d_scan_pair_bwd.launches) == TRAIN_POLICIES[policy],
                  f"{policy}: {ss2d_scan_pair.launches} K1 / {ss2d_scan_pair_bwd.launches} K2 "
                  f"launches in turn {turn}")
    full, save = (float(np.median(times[p])) for p in ("full", "save_scan"))
    spread = {p: float(np.subtract(*np.percentile(times[p], [75, 25]))) for p in times}
    verdict = ("faster" if save < full - spread["full"] else
               "slower" if save > full + spread["full"] else "unresolved")
    emit({"phase": "train_policies", "batch": TRAIN_BATCH, "size": [TRAIN_SIZE, TRAIN_SIZE],
          "turns": POLICY_TURNS, "full_ms": times["full"], "save_scan_ms": times["save_scan"],
          "full_ms_per_step": full, "save_scan_ms_per_step": save, "ms_vs_full": save - full,
          "spread_ms": spread,
          "save_scan_won": int(np.sum(np.less(times["save_scan"], times["full"]))),
          "verdict": verdict})
    check(verdict != "slower",
          f"'save_scan' {save} ms a step against 'full' {full}, beyond the spread {spread['full']}")


def phase_resume(run):
    """The state saved after step 3 goes into a fresh trainer (other initial
    weights) and takes step 4 on the same batch: the loss and the parameters
    of the trainer that went on."""
    from wavemamba_torch.checkpoint import find_resume_state, restore_training_state

    saved = run["saved"]
    path = find_resume_state(os.path.dirname(saved["path"]))
    check(path == saved["path"], f"find_resume_state finds {saved['path']}")
    fresh, step, _ = train_setup(run["policy"], seed=99)
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


class ScanDtypes:
    """A `set_scan` route that records the dtypes of each call's token stream
    and y and passes the call on to K1's wrapper: where a path hands K1 bf16."""

    def __init__(self):
        from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

        self.scan, self.calls = ss2d_scan_pair, []

    def __call__(self, x, *args, out_dtype=None):
        y = self.scan(x, *args, out_dtype=out_dtype)
        self.calls.append((str(x.dtype), str(y.dtype)))
        return y


def psnr_db(a, b):
    """PSNR (dB, peak 1) between two arrays or tensors."""
    a, b = (np.asarray(t.float().cpu() if torch.is_tensor(t) else t, np.float64) for t in (a, b))
    return float(10 * np.log10(1.0 / np.mean((a - b) ** 2)))


def phase_serve_fast(fast, stock):
    """The serve path of `phase_serve` with `WaveMambaConfig.fast()` on the
    same weights: the two requests (28 K1 launches a forward), the streams K1
    sees, the forward's time, the output against the float32 route's for the
    same request, and the whole model with K1 against the plain scan."""
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.models.wavemamba import set_scan, wavemamba_apply
    from wavemamba_torch.ops.scan import ss2d_scan_pair_plain
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    check((fast.cfg.compute_dtype, fast.cfg.scan_dtype, fast.cfg.scan_impl)
          == ("bfloat16", "bfloat16", "pallas_fused"), f"the fast preset {fast.cfg}")
    rs = np.random.RandomState(0)
    shapes = [(1080, 1920), (720, 1280)]
    images = [(rs.rand(1, h, w, 3) * 0.12).astype(np.float32) for h, w in shapes]
    ladder = BucketLadder()
    for img in images:  # warm-up of each bucket: the first bf16 call of a shape plans its convs
        enhance(fast, img, ladder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ss2d_scan_pair.launches = 0  # the main path's count starts here
    results = []
    for img in images:
        before = ss2d_scan_pair.launches
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = enhance(fast, img, ladder)
        end.record()
        end.synchronize()
        results.append((img, out, start.elapsed_time(end), time.perf_counter() - t0,
                        ss2d_scan_pair.launches - before))
    launches = ss2d_scan_pair.launches  # read just after the main path
    peak = torch.cuda.max_memory_allocated()
    for (img, out, ms, host_s, n), (h, w) in zip(results, shapes):
        ref = enhance(stock, img, ladder)  # the float32 route, the same request
        psnr = psnr_db(out, ref)
        check(out.shape == img.shape and out.dtype == np.float32 and bool(np.isfinite(out).all()),
              "the fast route's output")
        check(float(out.mean()) > float(img.mean()), "outputs brighter than inputs")
        check(n == 28, f"{n} K1 launches in a fast forward, expected 28")
        emit({"phase": "serve_fast", "image": [h, w], "bucket": list(ladder.shape_for(h, w)),
              "latency_ms": ms, "host_s": host_s, "k1_launches": n, "psnr_vs_float32_db": psnr,
              "max_abs_vs_float32": float(np.abs(out - ref).max()), "tol_psnr_db": FAST_VS_F32_PSNR})
        check(psnr >= FAST_VS_F32_PSNR, f"{h}x{w}: fast vs float32 route {psnr} dB >= {FAST_VS_F32_PSNR}")
    check(launches == 28 * len(images), f"{launches} K1 launches on the main path")

    x = torch.from_numpy(np.ascontiguousarray(np.pad(
        images[0], ((0, 0), (0, 72), (0, 0), (0, 0)), mode="reflect"))).cuda()
    forward_ms = cuda_ms(lambda: wavemamba_apply(fast, x), 3)
    stock_ms = cuda_ms(lambda: wavemamba_apply(stock, x), 3)
    streams = ScanDtypes()
    set_scan(fast, streams)
    try:
        wavemamba_apply(fast, x)
    finally:
        set_scan(fast, ss2d_scan_pair)
    check(streams.calls == [("torch.bfloat16", "torch.bfloat16")] * 28,
          f"K1's streams in a fast forward: {sorted(set(streams.calls))}, {len(streams.calls)} calls")

    # The whole model at a small size: the plain scan takes ~7 s a call at
    # 1080p level 1 (the k1 rows' plain_ms), so 28 of them would not fit the
    # run. K1 itself is held on bf16 streams at every shape of this path in
    # `phase_k1_bf16`, and of the training step in `phase_k2_bf16`.
    small = x[:, :256, :384].contiguous()
    y_kernel = wavemamba_apply(fast, small)
    set_scan(fast, ss2d_scan_pair_plain)
    try:
        y_plain = wavemamba_apply(fast, small)
    finally:
        set_scan(fast, ss2d_scan_pair)
    err, psnr = float((y_kernel - y_plain).abs().max()), psnr_db(y_kernel, y_plain)
    emit({"phase": "serve_fast", "requests": len(images), "k1_launches": launches,
          "k1_streams": "bfloat16 x, bfloat16 y (28 calls a forward)",
          "forward_ms_1152x1920": forward_ms, "float32_forward_ms_1152x1920": stock_ms,
          "peak_memory_bytes": peak,
          "kernel_vs_plain_256x384": {"max_abs_err": err, "psnr_db": psnr, "tol_max": FAST_MODEL_ATOL,
                                      "tol_psnr_db": FAST_MODEL_PSNR}})
    check(err <= FAST_MODEL_ATOL and psnr >= FAST_MODEL_PSNR, f"fast model, K1 vs plain: {err}, {psnr} dB")
    return dict(launches=launches, forward_ms=forward_ms, x=x)


@torch.no_grad()
def phase_serve_fast_fused(model, fast, stock):
    """The serve path with `WaveMambaConfig.fast(conv_impl="fused")` on the
    same weights: the bf16 network with its chains on K7 and its scans on K1,
    both on bf16 activations. The two requests of `serve_fast` (each bucket
    warmed): 76 K7 + 28 K1 launches a forward, outputs finite and brighter,
    the PSNR against the float32 stock route (held) and against `fast()` on
    stock convs (reported); then the chain kernels against the plain chains on
    the same model, and the forward at 1152x1920 beside `fast()`'s."""
    from wavemamba_torch.experimental import conv_fused as cf
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair

    check((model.cfg.conv_impl, model.cfg.compute_dtype, model.cfg.scan_dtype)
          == ("fused", "bfloat16", "bfloat16"), f"the fused fast preset {model.cfg}")
    rs = np.random.RandomState(0)
    shapes = [(1080, 1920), (720, 1280)]
    images = [(rs.rand(1, h, w, 3) * 0.12).astype(np.float32) for h, w in shapes]
    ladder = BucketLadder()
    for img in images:  # warm-up of each bucket
        enhance(model, img, ladder)
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
        out = enhance(model, img, ladder)
        end.record()
        end.synchronize()
        results.append((img, out, start.elapsed_time(end), time.perf_counter() - t0,
                        tuple(a - b for a, b in zip(counts(), before))))
    launches = counts()  # read just after the main path
    peak = torch.cuda.max_memory_allocated()
    for (img, out, ms, host_s, n), (h, w) in zip(results, shapes):
        ref = enhance(stock, img, ladder)  # the float32 stock route, the same request
        psnr, psnr_fast = psnr_db(out, ref), psnr_db(out, enhance(fast, img, ladder))
        check(out.shape == img.shape and out.dtype == np.float32 and bool(np.isfinite(out).all()),
              "the fused fast route's output")
        check(float(out.mean()) > float(img.mean()), "outputs brighter than inputs")
        check(n == (76, 0, 28), f"{n} K7 / K6 / K1 launches in a forward, expected (76, 0, 28)")
        emit({"phase": "serve_fast_fused", "image": [h, w], "bucket": list(ladder.shape_for(h, w)),
              "latency_ms": ms, "host_s": host_s, "k7_launches": n[0], "k1_launches": n[2],
              "psnr_vs_float32_db": psnr, "max_abs_vs_float32": float(np.abs(out - ref).max()),
              "tol_psnr_db": FAST_VS_F32_PSNR, "psnr_vs_fast_stock_convs_db": psnr_fast})
        check(psnr >= FAST_VS_F32_PSNR,
              f"{h}x{w}: fused fast vs float32 route {psnr} dB >= {FAST_VS_F32_PSNR}")
    check(launches == (76 * len(images), 0, 28 * len(images)), f"{launches} launches on the main path")

    x = torch.from_numpy(np.ascontiguousarray(np.pad(
        images[0], ((0, 0), (0, 72), (0, 0), (0, 0)), mode="reflect"))).cuda()
    forward_ms = cuda_ms(lambda: wavemamba_apply(model, x), 3)
    fast_ms = cuda_ms(lambda: wavemamba_apply(fast, x), 3)
    y = wavemamba_apply(model, x)
    with cf.chain_route("plain"):
        y_plain = wavemamba_apply(model, x)
    d = (y - y_plain).abs()
    psnr = psnr_db(y, y_plain)
    row = {"phase": "serve_fast_fused", "requests": len(images), "k7_launches": launches[0],
           "k6_launches": launches[1], "k1_launches": launches[2],
           "forward_ms_1152x1920": forward_ms, "fast_stock_convs_forward_ms_1152x1920": fast_ms,
           "peak_memory_bytes": peak,
           "kernel_vs_plain_chains": {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
                                      "psnr_db": psnr, "tol_max": FAST_FUSED_MODEL_ATOL,
                                      "tol_psnr_db": FAST_FUSED_MODEL_PSNR}}
    emit(row)
    check(float(d.max()) <= FAST_FUSED_MODEL_ATOL and psnr >= FAST_FUSED_MODEL_PSNR,
          f"fused fast model, chain kernels vs plain chains {row['kernel_vs_plain_chains']}")
    return dict(launches=launches[0], k1_launches=launches[2], forward_ms=forward_ms)


def _yml_train_opt(name, seed, network_g, train, train_set):
    """An options dict as `parse_options` hands on a train yml's `network_g`,
    `train` and `datasets.train` sections (the data itself is made here),
    from a seeded init. Block recompute as the ymls say: on, 'save_scan'."""
    root = os.path.join(ROOT, "build", "chip_smoke", "experiments", name)
    return {
        "name": name, "model_type": "FeMaSRModel", "scale": 1, "manual_seed": seed,
        "is_train": True, "device": "cuda", "network_g": network_g,
        "datasets": {"train": {"name": name, "type": "PairedImageDataset", "phase": "train",
                               "scale": 1, "io_backend": {"type": "disk"}, "gt_size": TRAIN_SIZE,
                               "geometric_augs": True, "batch_size_per_gpu": TRAIN_BATCH,
                               "num_worker_per_gpu": 8, "dataset_enlarge_ratio": 1,
                               "cache_in_ram": True, "transfer_dtype": "uint8", **train_set}},
        "path": {"pretrain_network_g": None, "resume_state": None, "experiments_root": root,
                 "models": os.path.join(root, "models"),
                 "training_states": os.path.join(root, "training_states"),
                 "visualization": os.path.join(root, "visualization")},
        "train": train,
    }


def _yml_train_section(lr, periods, eta_mins, total_iter):
    return {"ema_decay": 0.999,
            "optim_g": {"type": "AdamW", "lr": lr, "weight_decay": 1e-3, "betas": [0.9, 0.99]},
            "scheduler": {"type": "CosineAnnealingRestartCyclicLR", "periods": periods,
                          "restart_weights": [1, 1], "eta_mins": eta_mins},
            "total_iter": total_iter, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "fft_opt": {"type": "FFTLoss", "loss_weight": 0.1, "reduction": "mean"}}


_PROC_NETWORK_G = {"type": "WaveMamba", "in_chn": 3, "wf": 32, "n_l_blocks": [1, 2, 4],
                   "n_h_blocks": [1, 1, 2], "ffn_scale": 2.0, "scan_impl": "pallas_fused",
                   "scan_chunk": 128, "compute_dtype": "bfloat16"}


def fast_train_opt(seed):
    """`options/train_wavemamba_proc_bsrgan_xxl4.yml`'s sections (bf16
    compute and scan streams; the device-resident dataset)."""
    return _yml_train_opt("train_fast", seed, {**_PROC_NETWORK_G, "scan_dtype": "bfloat16"},
                          _yml_train_section(1e-4, [600, 5400], [0.0001, 0.0000001], 6000),
                          {"cache_on_device": True})


def mixed_train_opt(seed):
    """`options/train_wavemamba_proc512.yml`'s sections (bf16 compute, no
    `scan_dtype`: float32 scan streams; the host loader)."""
    return _yml_train_opt("train_mixed", seed, _PROC_NETWORK_G,
                          _yml_train_section(2e-4, [300, 2700], [0.0002, 0.0000001], 3000), {})


# The phases that train from a shipped yml's sections: its path, its options,
# and the (x, y) dtypes each of its 28 K1 calls a step must see. Both recompute
# their blocks as the ymls do (neither sets `remat`: on, 'save_scan'), so K1
# runs 28 times a step, its outputs kept across the recompute.
TRAIN_YMLS = {
    "train_fast": ("options/train_wavemamba_proc_bsrgan_xxl4.yml", fast_train_opt, 41,
                   ("torch.bfloat16", "torch.bfloat16"),
                   "bfloat16 x, bfloat16 y; K2 bfloat16 x and dy, dx bfloat16"),
    "train_mixed": ("options/train_wavemamba_proc512.yml", mixed_train_opt, 51,
                    ("torch.bfloat16", "torch.float32"),
                    "bfloat16 x, float32 y; K2 bfloat16 x, float32 dy, dx bfloat16"),
}


def yml_train_loader(opt, train_set):
    """The train loader of the yml's `datasets.train` section over the seeded
    in-memory pairs, chosen as `pipelines.train` chooses it: the
    device-resident dataset where `cache_on_device` is set (staged from the
    decoded arrays; this host needs no OpenCV), else the threaded host loader
    behind `device_prefetch`. Returns (the loader, its first batch)."""
    from wavemamba_torch.data import (
        DeviceCachedLoader,
        EnlargedSampler,
        ThreadedLoader,
        device_prefetch,
    )

    dataset_opt = opt["datasets"]["train"]
    sampler = EnlargedSampler(len(train_set), 1, 0, ratio=dataset_opt["dataset_enlarge_ratio"])
    if dataset_opt.get("cache_on_device"):
        items = train_set.items
        loader = DeviceCachedLoader.from_arrays(
            [it["lq"] for it in items], [it["gt"] for it in items], items, dataset_opt,
            TRAIN_BATCH, sampler=sampler, seed=opt["manual_seed"], device="cuda")
        loader.set_epoch(0)
        return loader, next(iter(loader))
    loader = ThreadedLoader(train_set, batch_size=TRAIN_BATCH, sampler=sampler,
                            num_workers=dataset_opt["num_worker_per_gpu"], drop_last=True,
                            seed=opt["manual_seed"])
    loader.set_epoch(0)
    batches = device_prefetch(loader, "cuda")
    batch = next(batches)
    batches.close()
    return loader, batch


def phase_train_yml(phase):
    """bf16 training through the yml path (`TRAIN_YMLS[phase]`): `build_model`
    on the yml's sections with its block recompute ('save_scan'), a seeded
    uint8 dataset through the sampler and the yml's loader (`yml_train_loader`:
    the device-resident dataset for the xxl4 yml), then one warm-up step and
    TRAIN_STEPS steps on the first batch, repeated."""
    from wavemamba_torch.models.wavemamba import set_scan
    from wavemamba_torch.ops import scan_cuda
    from wavemamba_torch.runner import build_model

    yml, make_opt, seed, streams_want, streams_note = TRAIN_YMLS[phase]
    opt = make_opt(seed=seed)
    model = build_model(opt)
    cfg = model.model.cfg
    check(all(p.dtype == torch.float32 for p in model.model.parameters()), "float32 parameters")
    check((cfg.remat, cfg.remat_policy) == (True, "save_scan"), f"{phase}: recompute as the yml says")
    train_set = SyntheticPairs(16, TRAIN_SIZE, seed=seed + 1, uint8=True)
    loader, batch = yml_train_loader(opt, train_set)
    device_cache = bool(opt["datasets"]["train"].get("cache_on_device"))
    check(getattr(loader, "yields_device_batches", False) == device_cache,
          f"{phase}: the {'device-resident' if device_cache else 'host'} loader, got {type(loader).__name__}")
    check(batch["lq"].dtype == torch.uint8 and batch["lq"].is_cuda, "uint8 batches on the card")
    streams = ScanDtypes()
    set_scan(model.model, streams)
    torch.cuda.reset_peak_memory_stats()
    warm_loss = float(model.optimize_parameters(batch)["total"])  # warm-up
    # The hook sees each call: the forward's 28, and the recompute's 28, which
    # the op answers from its saved outputs.
    check(streams.calls == [streams_want] * 56,
          f"K1's streams in a {phase} step: {len(streams.calls)} calls, {sorted(set(streams.calls))}")
    set_scan(model.model, scan_cuda.ss2d_scan_pair)
    wrappers = (scan_cuda.ss2d_scan_pair, scan_cuda.ss2d_scan_pair_bwd)
    for w in wrappers:  # the main path's counts start here
        w.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = model.optimize_parameters(batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["total"]))
    k1, k2 = (w.launches for w in wrappers)  # read just after
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(times))
    net = opt["network_g"]
    emit({"phase": phase, "yml": yml, "compute_dtype": net["compute_dtype"],
          "scan_dtype": net.get("scan_dtype", "float32 (the default)"), "remat": cfg.remat,
          "remat_policy": cfg.remat_policy, "loader": type(loader).__name__,
          "batch": TRAIN_BATCH, "size": [TRAIN_SIZE, TRAIN_SIZE], "steps": TRAIN_STEPS,
          "loss_first": warm_loss, "losses": losses, "step_ms": times, "ms_per_step": ms,
          "images_per_s": TRAIN_BATCH / ms * 1e3, "peak_memory_bytes": peak, "k1_launches": k1,
          "k2_launches": k2, "k1_per_step": k1 / TRAIN_STEPS, "k2_per_step": k2 / TRAIN_STEPS,
          "k1_streams": streams_note})
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "losses finite")
    check(losses[-1] < warm_loss, f"the loss fell on the repeated batch: {warm_loss} -> {losses[-1]}")
    check((k1, k2) == (28 * TRAIN_STEPS, 28 * TRAIN_STEPS), f"{k1} K1 / {k2} K2 launches in {TRAIN_STEPS} steps")
    return dict(k1_launches=k1, k2_launches=k2, ms_per_step=ms, model=model, batch=batch)


# The xxl4 yml's dataset: 3,200 pairs of 512x512 (its comment: "3200x512^2x3
# uint8 x2 ~= 4.8 GB staged in HBM"); 400 pairs where the host cannot hold it.
CACHE_PAIRS, CACHE_PAIRS_CUT = 3200, 400
CACHE_CHECK_BATCHES, CACHE_TIMED_BATCHES = 4, 50


def np_dihedral(img, mode):
    """`transforms.data_augmentation`'s mode of an HWC image, in numpy."""
    rot = np.rot90(img, k=mode // 2)
    return np.flipud(rot) if mode % 2 else rot


def host_bytes_available():
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_device_cache(seed=61):
    """The xxl4 yml's device-resident dataset at its own scale: seeded uint8
    pairs staged on the card by `DeviceCachedLoader.from_arrays`, the staging
    seconds, the bytes on the card and the ms a batch of TRAIN_BATCH; one
    epoch's first batches against the same loader on CPU tensors and against
    numpy's crop and dihedral modes, bit for bit."""
    from wavemamba_torch.data import DeviceCachedLoader, EnlargedSampler

    opt = fast_train_opt(seed)
    dataset_opt = opt["datasets"]["train"]
    pairs = CACHE_PAIRS
    need = 2 * pairs * TRAIN_SIZE * TRAIN_SIZE * 3
    available = host_bytes_available()
    if available < 3 * need:  # the arrays, and room for the rest of the run
        pairs = CACHE_PAIRS_CUT
    shape = (pairs, TRAIN_SIZE, TRAIN_SIZE, 3)
    t0 = time.perf_counter()
    # uniform bytes, drawn 8 at a time (uint8 draws took 23 s for the 5 GB)
    words = np.random.default_rng(seed).integers(0, 2**64 - 1, need // 16, dtype=np.uint64,
                                                 endpoint=True)
    gt = words.view(np.uint8).reshape(shape)
    lq = gt >> 2  # a darker copy
    make_s = time.perf_counter() - t0
    paths = [{"lq_path": f"synthetic/lq/{i:04d}.png", "gt_path": f"synthetic/gt/{i:04d}.png"}
             for i in range(pairs)]
    loaders = {}
    for device in ("cuda", "cpu"):
        sampler = EnlargedSampler(pairs, 1, 0, ratio=dataset_opt["dataset_enlarge_ratio"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaders[device] = DeviceCachedLoader.from_arrays(
            lq, gt, paths, dataset_opt, TRAIN_BATCH, sampler=sampler, seed=opt["manual_seed"],
            device=device, budget_gb=dataset_opt.get("device_cache_budget_gb", 8.0))
        torch.cuda.synchronize()
        if device == "cuda":
            stage_s = time.perf_counter() - t0
    card, host = loaders["cuda"], loaders["cpu"]
    check(card.lq_all.is_cuda and card.nbytes == 2 * lq.nbytes, "the dataset is on the card")
    for loader in (card, host):
        loader.set_epoch(0)

    # One epoch's first batches: the card's against the CPU tensors' and numpy's.
    indices = np.asarray(list(iter(card.sampler)))
    draws = np.random.RandomState(opt["manual_seed"] ^ 0x5EED)
    checked = []
    for b, got, want in zip(range(CACHE_CHECK_BATCHES), card, host):
        idx = indices[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH]
        tops = draws.randint(0, card.crop_max_top + 1, size=TRAIN_BATCH)
        lefts = draws.randint(0, card.crop_max_left + 1, size=TRAIN_BATCH)
        modes = draws.randint(1, 8, size=TRAIN_BATCH)
        np_lq = np.stack([np_dihedral(lq[i, t:t + TRAIN_SIZE, l:l + TRAIN_SIZE], m)
                          for i, t, l, m in zip(idx, tops, lefts, modes)])
        np_gt = np.stack([np_dihedral(gt[i, t:t + TRAIN_SIZE, l:l + TRAIN_SIZE], m)
                          for i, t, l, m in zip(idx, tops, lefts, modes)])
        same = {"vs_cpu": all(torch.equal(got[k].cpu(), want[k]) for k in ("lq", "gt")),
                "vs_numpy": all(np.array_equal(got[k].cpu().numpy(), ref)
                                for k, ref in (("lq", np_lq), ("gt", np_gt))),
                "paths": got["lq_path"] == want["lq_path"] == [paths[i]["lq_path"] for i in idx],
                "modes": sorted(set(modes.tolist()))}
        checked.append(same)
        check(got["lq"].is_cuda and got["lq"].dtype == torch.uint8
              and tuple(got["lq"].shape) == (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
              "uint8 NHWC batches on the card")
        check(same["vs_cpu"] and same["vs_numpy"] and same["paths"],
              f"device_cache batch {b}: bit for bit against the CPU loader and numpy: {same}")
    del host, loaders

    # ms a batch: the host's draws, their one copy to the card and the gathers.
    batches = iter(card)
    next(batches)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CACHE_TIMED_BATCHES):
        next(batches)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / CACHE_TIMED_BATCHES
    emit({"phase": "device_cache", "yml": TRAIN_YMLS["train_fast"][0], "pairs": pairs,
          "size": [TRAIN_SIZE, TRAIN_SIZE], "batch": TRAIN_BATCH,
          "cut": None if pairs == CACHE_PAIRS else
          f"{CACHE_PAIRS} pairs need {need} B and the host has {available} B available",
          "host_bytes_available": available, "make_s": make_s, "stage_s": stage_s,
          "bytes_on_card": card.nbytes, "stage_gb_per_s": card.nbytes / stage_s / 1e9,
          "ms_per_batch": ms, "batches_per_epoch": len(card), "checked_batches": checked})
    del card
    torch.cuda.empty_cache()


# The data phase (`phase_data`). The card against the CPU on the same inputs,
# with the CPU tests' tolerances against the JAX package
# (`tests/test_torch_data_extra.py`): filter2d and duf_downsample by max abs
# difference (depthwise sums of <= 441 products of values in [0, 1] with
# weights that sum to 1, taken in another order); diff_jpeg's output by max
# abs and its gradient by max abs over the gradient's max abs, both outside
# the 8x8 (luma) and 16x16 (chroma) blocks where the two devices round a
# quantized coefficient to different integers (`jpeg_coefficients` within
# float32 error of a half: the rounding steps there by 0.75 of the table's
# step, as the function defines). The native crop against its numpy version,
# bit for bit.
DATA_OPS_ATOL = 1e-6
DIFFJPEG_ATOL, DIFFJPEG_GRAD_RTOL = 1e-5, 1e-4
UHD_HW = (2160, 3840)  # UHD-LL's frames
NATIVE_PAIRS = 8
# The generator's arguments: 16 train pairs and one val pair of 512x512 with
# the BSRGAN toolbox, the bsrgan sets' size and the XL set's seed.
PROC_ARGS = ["--bsrgan", "--n-train", "16", "--n-val", "1", "--size", "512", "--seed", "2"]
DATA_TRAIN_STEPS = 3


def tree_digests(root):
    """{relative path: sha256} of every file under `root`."""
    import hashlib

    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def start_generator(out):
    """`python -m wavemamba_torch.scripts.make_proc_dataset` with PROC_ARGS
    into `out` (emptied first), as a child process."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    return subprocess.Popen([sys.executable, "-m", "wavemamba_torch.scripts.make_proc_dataset",
                             "--out", out, *PROC_ARGS], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONPATH": ROOT})


def host_ms(fn, reps=3):
    """Median host milliseconds of `fn` over `reps` runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def data_native(seed=71):
    """The fused C++ crop (`data/native.py`, built from `native/wavedata.cc`)
    on NATIVE_PAIRS seeded uint8 pairs of UHD-LL's size at the train crop
    (TRAIN_SIZE): `paired_crop_augment` in each dihedral mode and
    `batch_paired_crop_augment` (threaded, and on one thread) against their
    numpy versions bit for bit; the host ms of a batch by the native batch
    call, by the dataset's native route (a call an item) and by its numpy
    route (the whole frame to float32, crop, turn, channel swap)."""
    import random

    from wavemamba_torch.data import native
    from wavemamba_torch.data.transforms import paired_random_crop, random_augmentation

    t0 = time.perf_counter()
    check(native.available(), "the native crop builds from native/wavedata.cc and loads")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    gts = [rng.integers(0, 256, (*UHD_HW, 3), dtype=np.uint8) for _ in range(NATIVE_PAIRS)]
    lqs = [g >> 3 for g in gts]  # a darker copy
    S = TRAIN_SIZE
    modes = []
    for mode, (g, q) in enumerate(zip(gts, lqs)):
        top, left = int(rng.integers(0, UHD_HW[0] - S + 1)), int(rng.integers(0, UHD_HW[1] - S + 1))
        got = native.paired_crop_augment(g, q, top, left, S, mode)
        want = native.paired_crop_augment_plain(g, q, top, left, S, mode)
        modes.append(all(np.array_equal(a, b) for a, b in zip(got, want)))
    batch_seed = int(rng.integers(0, 2**63))
    got = native.batch_paired_crop_augment(gts, lqs, S, seed=batch_seed)
    one_thread = native.batch_paired_crop_augment(gts, lqs, S, seed=batch_seed, n_threads=1)
    draws = native.batch_draws([UHD_HW[0]] * NATIVE_PAIRS, [UHD_HW[1]] * NATIVE_PAIRS, S, batch_seed)
    want = [native.paired_crop_augment_plain(g, q, t, l, S, m) for g, q, (t, l, m) in zip(gts, lqs, draws)]
    batch_same = (all(np.array_equal(got[0][i], w[0]) and np.array_equal(got[1][i], w[1])
                      for i, w in enumerate(want))
                  and all(np.array_equal(a, b) for a, b in zip(got, one_thread)))

    def dataset_native():  # PairedImageDataset's native route, an item at a time
        random.seed(seed)
        out = []
        for g, q in zip(gts, lqs):
            top, left = random.randint(0, UHD_HW[0] - S), random.randint(0, UHD_HW[1] - S)
            out.append(native.paired_crop_augment(g, q, top, left, S, random.randint(1, 7)))
        return out

    def dataset_numpy():  # its numpy route, the same draws
        random.seed(seed)
        out = []
        for g, q in zip(gts, lqs):
            fg, fq = paired_random_crop(g.astype(np.float32) / 255.0, q.astype(np.float32) / 255.0,
                                        S, 1)
            fg, fq = random_augmentation(fg, fq)
            out.append((np.ascontiguousarray(fg[..., ::-1]), np.ascontiguousarray(fq[..., ::-1])))
        return out

    # The numpy route divides by 255 where the C++ pass multiplies by 1/255:
    # the same crops, within a float32 rounding.
    route_err = max(float(np.abs(a - b).max()) for pair_n, pair_p in zip(dataset_native(), dataset_numpy())
                    for a, b in zip(pair_n, pair_p))
    row = {"pairs": NATIVE_PAIRS, "frame": list(UHD_HW), "gt_size": S, "build_s": build_s,
           "modes_bit_equal": modes, "batch_bit_equal": batch_same,
           "numpy_route_max_abs_err": route_err,
           "host_ms_batch": {"native_batch": host_ms(lambda: native.batch_paired_crop_augment(
               gts, lqs, S, seed=batch_seed)), "native_items": host_ms(dataset_native),
               "numpy": host_ms(dataset_numpy)}}
    check(all(modes), f"paired_crop_augment against its numpy version in modes 0-7: {modes}")
    check(batch_same, "batch_paired_crop_augment against its numpy version and on one thread")
    check(route_err <= 2.0 ** -23, f"the numpy route's items within a float32 rounding: {route_err}")
    return row


def data_device_ops(seed=72):
    """filter2d (a shared 21x21 kernel and per-sample ones), duf_downsample
    and diff_jpeg (forward and gradient) on CUDA tensors against the same
    functions on the CPU, and the ms of each on the card."""
    from wavemamba_torch.data.data_util import duf_downsample
    from wavemamba_torch.data.degradations import gaussian_kernel
    from wavemamba_torch.ops.diffjpeg import diff_jpeg, jpeg_coefficients
    from wavemamba_torch.utils.img_process_util import filter2d

    rs = np.random.RandomState(seed)
    img = torch.from_numpy(rs.rand(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32))
    shared = torch.from_numpy(gaussian_kernel(21, 2.0, 4.0, 0.5))
    per_sample = torch.from_numpy(np.stack([gaussian_kernel(21, 0.5 + i, 3.0 - 0.3 * i, 0.4 * i)
                                            for i in range(TRAIN_BATCH)]))
    frames = torch.from_numpy(rs.rand(7, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32))
    rows = {}
    for name, fn, args in (("filter2d_21x21", filter2d, (img, shared)),
                           ("filter2d_per_sample", filter2d, (img, per_sample)),
                           ("duf_downsample_x4", lambda x: duf_downsample(x, 13, 4), (frames,))):
        want = fn(*args)
        cargs = tuple(a.cuda() for a in args)
        got = fn(*cargs)
        check(got.is_cuda and got.shape == want.shape, f"{name} on the card, {tuple(want.shape)}")
        err = float((got.cpu() - want).abs().max())
        rows[name] = {"shape": list(want.shape), "max_abs_err": err, "atol": DATA_OPS_ATOL,
                      "ms": cuda_ms(lambda: fn(*cargs), 20)}
        check(err <= DATA_OPS_ATOL, f"{name}: card against CPU {err} <= {DATA_OPS_ATOL}")

    # diff_jpeg at quality 50 on x in [0.1, 0.9], the gradient of sum(out * w).
    x = torch.from_numpy((rs.rand(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3) * 0.8 + 0.1).astype(np.float32))
    w = torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
    outs, grads, coefs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev, copy=True).requires_grad_()
        out = diff_jpeg(xd, 50)
        (out * w.to(dev)).sum().backward()
        outs[dev], grads[dev] = out.detach().cpu(), xd.grad.cpu()
        coefs[dev] = [torch.round(c.detach()).cpu() for c in jpeg_coefficients(x.to(dev), 50)]
    b, h, w_ = x.shape[:3]
    mask = torch.zeros(b, h, w_, dtype=torch.bool)
    flips = 0
    for plane, (got, want) in enumerate(zip(coefs["cuda"], coefs["cpu"])):
        block = 8 if plane == 0 else 16  # pixels a block of the plane spans
        differs = (got != want).any(dim=(2, 3))  # (B, blocks)
        flips += int((got != want).sum())
        grid = differs.reshape(b, h // block, w_ // block)
        mask |= grid.repeat_interleave(block, 1).repeat_interleave(block, 2)
    keep = ~mask[..., None].expand_as(x)
    out_err = float((outs["cuda"] - outs["cpu"]).abs()[keep].max())
    grad_err = float((grads["cuda"] - grads["cpu"]).abs()[keep].max()) / float(grads["cpu"].abs().max())
    xc, wc = x.cuda(), w.cuda()

    def fwd_bwd():
        xg = xc.clone().requires_grad_()
        (diff_jpeg(xg, 50) * wc).sum().backward()

    rows["diff_jpeg_q50"] = {
        "shape": list(x.shape), "max_abs_err": out_err, "atol": DIFFJPEG_ATOL,
        "grad_max_rel_err": grad_err, "grad_rtol": DIFFJPEG_GRAD_RTOL,
        "coefficients_rounded_apart": flips, "pixels_excluded_share": float(mask.float().mean()),
        "ms": cuda_ms(lambda: diff_jpeg(xc, 50), 20), "ms_forward_backward": cuda_ms(fwd_bwd, 20)}
    check(out_err <= DIFFJPEG_ATOL, f"diff_jpeg: card against CPU {out_err} <= {DIFFJPEG_ATOL}")
    check(grad_err <= DIFFJPEG_GRAD_RTOL,
          f"diff_jpeg gradient: card against CPU {grad_err} <= {DIFFJPEG_GRAD_RTOL} of its max")
    return rows


def data_train_opt(seed, dataroot):
    """`options/train_wavemamba_uhdll.yml`'s `network_g`, `train` and
    `datasets.train` sections as `parse_options` hands them on (block
    recompute as the yml leaves it: on, 'save_scan'; no `transfer_dtype`, so
    the train phase takes the native crop), its dataroots pointing at
    `dataroot`."""
    root = os.path.join(ROOT, "build", "chip_smoke", "experiments", "data_train")
    return {
        "name": "data_train", "model_type": "FeMaSRModel", "scale": 1, "manual_seed": seed,
        "is_train": True, "device": "cuda",
        "network_g": {"type": "WaveMamba", "in_chn": 3, "wf": 32, "n_l_blocks": [1, 2, 4],
                      "n_h_blocks": [1, 1, 2], "ffn_scale": 2.0},
        "datasets": {"train": {"name": "General_Image_Train", "type": "PairedImageDataset",
                               "phase": "train", "scale": 1,
                               "dataroot_gt": os.path.join(dataroot, "train", "gt"),
                               "dataroot_lq": os.path.join(dataroot, "train", "input"),
                               "io_backend": {"type": "disk"}, "gt_size": TRAIN_SIZE,
                               "geometric_augs": True, "batch_size_per_gpu": TRAIN_BATCH,
                               "num_worker_per_gpu": 8, "dataset_enlarge_ratio": 1}},
        "path": {"pretrain_network_g": None, "resume_state": None, "experiments_root": root,
                 "models": os.path.join(root, "models"),
                 "training_states": os.path.join(root, "training_states"),
                 "visualization": os.path.join(root, "visualization")},
        "train": {"optim_g": {"type": "AdamW", "lr": 5e-4, "weight_decay": 1e-3, "betas": [0.9, 0.99]},
                  "scheduler": {"type": "CosineAnnealingRestartCyclicLR", "periods": [100, 100000],
                                "restart_weights": [1, 1], "eta_mins": [0.0005, 0.0000001]},
                  "total_iter": 101000, "warmup_iter": -1,
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
                  "fft_opt": {"type": "FFTLoss", "loss_weight": 0.1, "reduction": "mean"}},
    }


def data_train(dataroot, seed=73):
    """The uhdll yml's sections train DATA_TRAIN_STEPS steps from the
    generated folder: `build_dataset` (`PairedImageDataset`, whose train phase
    takes the native crop) -> `EnlargedSampler` -> `ThreadedLoader` ->
    `device_prefetch` -> `optimize_parameters`, under 'save_scan'. K1 / K2
    launches are counted from 0 just before the first step and read after
    the last."""
    from wavemamba_torch.data import EnlargedSampler, ThreadedLoader, build_dataset, device_prefetch
    from wavemamba_torch.data import native
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd
    from wavemamba_torch.runner import build_model

    opt = data_train_opt(seed, dataroot)
    model = build_model(opt)
    cfg = model.model.cfg
    check((cfg.remat, cfg.remat_policy) == (True, "save_scan"), "data_train: recompute as the yml says")
    dataset_opt = opt["datasets"]["train"]
    train_set = build_dataset(dataset_opt)
    sampler = EnlargedSampler(len(train_set), 1, 0, ratio=dataset_opt["dataset_enlarge_ratio"])
    loader = ThreadedLoader(train_set, batch_size=TRAIN_BATCH, sampler=sampler,
                            num_workers=dataset_opt["num_worker_per_gpu"], drop_last=True,
                            seed=opt["manual_seed"])
    crop, native_items = native.paired_crop_augment, []

    def counted_crop(*args, **kw):  # the dataset's native route calls it once an item
        native_items.append(1)  # from the loader's threads: append is atomic
        return crop(*args, **kw)

    def batches():
        for epoch in range(DATA_TRAIN_STEPS):
            loader.set_epoch(epoch)
            prefetch = device_prefetch(loader, "cuda")
            try:
                yield from prefetch
            finally:
                prefetch.close()

    native.paired_crop_augment = counted_crop
    stream = batches()
    try:
        losses, times = [], []
        ss2d_scan_pair.launches = ss2d_scan_pair_bwd.launches = 0  # the path's counts start here
        for _, batch in zip(range(DATA_TRAIN_STEPS), stream):
            check(batch["lq"].is_cuda and batch["lq"].dtype == torch.float32
                  and tuple(batch["lq"].shape) == (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                  "float32 NHWC batches of the native crop on the card")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(float(model.optimize_parameters(batch)["total"]))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        k1, k2 = ss2d_scan_pair.launches, ss2d_scan_pair_bwd.launches  # read just after
    finally:
        stream.close()
        native.paired_crop_augment = crop
    check(all(np.isfinite(losses)), f"data_train: losses finite {losses}")
    check((k1, k2) == (28 * DATA_TRAIN_STEPS, 28 * DATA_TRAIN_STEPS),
          f"data_train: {k1} K1 / {k2} K2 launches in {DATA_TRAIN_STEPS} steps")
    check(len(native_items) >= TRAIN_BATCH * DATA_TRAIN_STEPS,
          f"data_train: the native crop took {len(native_items)} items")
    return {"yml": "options/train_wavemamba_uhdll.yml", "pairs": len(train_set),
            "remat_policy": cfg.remat_policy, "loader": type(loader).__name__,
            "native_items": len(native_items), "steps": DATA_TRAIN_STEPS, "losses": losses,
            "step_ms": times, "ms_per_step": float(np.median(times)), "k1_launches": k1,
            "k2_launches": k2, "k1_per_step": k1 / DATA_TRAIN_STEPS, "k2_per_step": k2 / DATA_TRAIN_STEPS}


def phase_data():
    """The data layer on the card's host: the port's dataset generator
    (`python -m wavemamba_torch.scripts.make_proc_dataset`, PROC_ARGS) twice
    at once, its two trees byte for byte the same; meanwhile the native crop
    (`data_native`) and the data layer's device ops (`data_device_ops`); then
    the uhdll yml trains from the generated set (`data_train`). Needs
    OpenCV, which the card's host has."""
    import cv2

    import threading

    t0 = time.perf_counter()
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"proc_{tag}") for tag in "ab"]
    procs = [start_generator(out) for out in outs]
    runs = [{} for _ in procs]

    def wait(proc, run):  # the child's output, and its seconds from the phase's start
        run["log"] = proc.communicate(timeout=600)[0]
        run["s"] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=pr, daemon=True) for pr in zip(procs, runs)]
    try:
        for waiter in waiters:
            waiter.start()
        native_row = data_native()
        ops_rows = data_device_ops()
        for waiter in waiters:
            waiter.join(timeout=600)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(all(p.returncode == 0 for p in procs) and all("s" in r for r in runs),
          f"the generator runs: {[r.get('log', '')[-500:] for r in runs]}")
    gen_s = [r["s"] for r in runs]
    trees = [tree_digests(out) for out in outs]
    pairs = 16 + 1
    check(len(trees[0]) == 2 * pairs, f"the generator wrote {len(trees[0])} files, want {2 * pairs}")
    check(trees[0] == trees[1], "the generator's two runs wrote the same bytes")
    train_row = data_train(outs[0])
    row = {"phase": "data", "opencv": cv2.__version__, "generator_args": " ".join(PROC_ARGS),
           "generator_files": len(trees[0]),
           "generator_s": gen_s, "generator_s_per_pair": [s / pairs for s in gen_s],
           "generator_note": "two runs at once, beside the native and device-op checks",
           "native": native_row, "device_ops": ops_rows, "train": train_row,
           "phase_s": time.perf_counter() - t0}
    emit(row)
    return row


SCRIPTS_DIR = os.path.join(ROOT, "build", "chip_smoke", "scripts")
# The shipped yml whose runs a user evaluates (bf16, EMA, started from the
# XXL3 checkpoint), cut to SCRIPTS_ITERS iterations that each save and
# validate, on the data phase's generated set.
SCRIPTS_YML = os.path.join(ROOT, "options", "train_wavemamba_proc_bsrgan_xxl4.yml")
SCRIPTS_ITERS = 2
# The side of the validation crop that cross_val_ckpts and post_train_eval
# read: both are checked against the full-width model on the host's CPU.
SCRIPTS_CROP = 128
# cross_val_ckpts' XXL4 row against the same forward on the CPU, in dB.
CROSS_VAL_DB = 0.01
# K1's kernels a call in a trace: pass 1 and the replay (`chunk_scan`, one
# row once normalized) and the chunk prefix.
K1_TRACE_KERNELS = 3
K1_PER_FORWARD = 28


def script_cmd(name, *args):
    """argv of `python -m wavemamba_torch.scripts.<name> *args`, as users run it."""
    return [sys.executable, "-m", f"wavemamba_torch.scripts.{name}", *map(str, args)]


def run_script(name, *args):
    """Run a script to its end here (host-only scripts): (exit code, output)."""
    r = subprocess.run(script_cmd(name, *args), cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    return r.returncode, r.stdout + r.stderr


def script_launches(text):
    """The `launches: {...}` line a script prints: its wrappers' counts."""
    lines = [ln for ln in text.splitlines() if ln.startswith("launches: ")]
    check(bool(lines), f"a script printed no launches line: {text[-2000:]}")
    return json.loads(lines[-1].split(": ", 1)[1])


def script_json(text, key):
    """The JSON line a script prints that holds `key`."""
    for line in text.splitlines():
        if line.startswith("{") and f'"{key}"' in line:
            return json.loads(line)
    check(False, f"no {key} line in: {text[-2000:]}")


def scripts_train_yml(dataroot):
    """SCRIPTS_YML as a user would cut it for a short run on `dataroot`: every
    iteration logs, saves and validates; one loader thread. Written under
    SCRIPTS_DIR; returns its path."""
    import yaml

    from wavemamba_torch.utils.options import yaml_load

    opt = json.loads(json.dumps(yaml_load(SCRIPTS_YML)))  # plain dicts for the dumper
    opt["name"] = "scripts_run"
    for phase in ("train", "val"):
        opt["datasets"][phase]["dataroot_gt"] = os.path.join(dataroot, phase, "gt")
        opt["datasets"][phase]["dataroot_lq"] = os.path.join(dataroot, phase, "input")
    opt["datasets"]["train"]["num_worker_per_gpu"] = 1
    opt["path"]["pretrain_network_g"] = os.path.join(ROOT, opt["path"]["pretrain_network_g"])
    opt["train"]["total_iter"] = SCRIPTS_ITERS
    opt["val"]["val_freq"] = 1
    opt["logger"].update({"print_freq": 1, "save_checkpoint_freq": 1, "use_tb_logger": False})
    path = os.path.join(SCRIPTS_DIR, "scripts_run.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return path


def phase_scripts(stock, smi):
    """The ported root and measurement scripts, each run as users run it
    (`python -m wavemamba_torch.scripts.<name>`) in a child process on the
    card, on the data phase's generated sets, their printed lines read and
    checked: `dataset_manifest` (write, verify, a flipped byte exits 1),
    `merge_datasets` (the two sets, pairs summed, the merge verifies),
    `cross_val_ckpts` (the eight shipped checkpoints; XXL4 against the same
    forward on the CPU here), `tiled_localize` and `tiled_fidelity` (finite
    readings), a short run of the xxl4 yml through `pipelines.train`, then
    `eval_run_ckpts` (its numbers are the run's logged validations) and
    `post_train_eval` (strict load; the card against the CPU), `metrics_sweep`
    over the restored sample (the port's metrics here), `trace_topops` over
    `utils/profiler.trace` of one 512x512 forward (K1's kernels, 28 K1 x 3),
    and, each alone on the card, `conv1x1_sweep` (four variants, 28 K1 a
    forward, >= FAST_VS_F32_PSNR from float32) and `chain_tune` (every band_h
    that runs within the chain phase's bf16 tolerance of the plain chains).
    Returns the row with the phase's K1 and K7 launches (the scripts' own
    counts and the traced forward's)."""
    import glob
    import re
    import shutil

    import cv2

    from wavemamba_torch.metrics import calculate_psnr, calculate_ssim
    from wavemamba_torch.models.wavemamba import WaveMambaConfig
    from wavemamba_torch.scripts import common
    from wavemamba_torch.utils.img_util import imread

    t0 = time.perf_counter()
    shutil.rmtree(SCRIPTS_DIR, ignore_errors=True)
    os.makedirs(SCRIPTS_DIR)
    logs = os.path.join(SCRIPTS_DIR, "logs")
    proc_a, proc_b = (os.path.join(ROOT, "build", "chip_smoke", f"proc_{t}") for t in "ab")
    src_in, src_gt = (sorted(glob.glob(os.path.join(proc_a, "val", sub, "*.png")))[0]
                      for sub in ("input", "gt"))
    exp = os.path.join(SCRIPTS_DIR, "experiments", "scripts_run")
    # The val pair's top-left SCRIPTS_CROP square, for the scripts whose
    # checks run the full-width model on the host's CPU too.
    small = os.path.join(SCRIPTS_DIR, "val_crop")
    crop_in, crop_gt = (os.path.join(small, "val", sub, os.path.basename(src_in))
                        for sub in ("input", "gt"))
    for path, src in ((crop_in, src_in), (crop_gt, src_gt)):
        os.makedirs(os.path.dirname(path))
        cv2.imwrite(path, cv2.imread(src)[:SCRIPTS_CROP, :SCRIPTS_CROP])
    # The card's scripts that need no finished run, beside a short training run.
    first = start_children({
        "train": [sys.executable, "-m", "wavemamba_torch.pipelines.train", "-opt",
                  scripts_train_yml(proc_a)],
        "cross_val_ckpts": script_cmd("cross_val_ckpts", "--val_root", small, "-n", 6),
        "tiled_localize": script_cmd("tiled_localize", "--input", src_in),
        "tiled_fidelity": script_cmd("tiled_fidelity", "--val_dir",
                                     os.path.join(proc_a, "val", "input")),
    }, logs, cwd=SCRIPTS_DIR)
    atexit.register(stop_children, first)
    # Meanwhile, the host-only scripts.
    rc_w, out_w = run_script("dataset_manifest", "write", proc_a, "--generator-args",
                             " ".join(PROC_ARGS))
    rc_v, out_v = run_script("dataset_manifest", "verify", proc_a)
    flipped = os.path.join(SCRIPTS_DIR, "proc_a_flipped")
    shutil.copytree(proc_a, flipped)
    victim = sorted(glob.glob(os.path.join(flipped, "val", "gt", "*.png")))[0]
    with open(victim, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 1]))
    rc_f, out_f = run_script("dataset_manifest", "verify", flipped)
    n_files = len(json.load(open(os.path.join(proc_a, "MANIFEST.json")))["files"])
    manifest_row = {"files": n_files, "write": out_w.strip(), "verify": out_v.strip(),
                    "flipped_exit": rc_f, "flipped": out_f.strip()}
    check(rc_w == 0 and rc_v == 0 and out_v.startswith(f"ok: {n_files} files") and n_files == 34,
          f"dataset_manifest write / verify: {manifest_row}")
    check(rc_f == 1 and out_f.startswith("FAIL: 1 modified, 0 missing"),
          f"dataset_manifest catches a flipped byte: {manifest_row}")
    merged = os.path.join(SCRIPTS_DIR, "merged")
    rc_m, out_m = run_script("merge_datasets", proc_a, proc_b, "--out", merged)
    rc_mv, out_mv = run_script("dataset_manifest", "verify", merged)
    pairs = {d: len(os.listdir(os.path.join(d, "train", "gt"))) for d in (proc_a, proc_b, merged)}
    merge_row = {"pairs": list(pairs.values()), "verify": out_mv.strip(), "exit": [rc_m, rc_mv]}
    check(rc_m == 0 and rc_mv == 0 and pairs[merged] == pairs[proc_a] + pairs[proc_b]
          and len(os.listdir(os.path.join(merged, "train", "input"))) == pairs[merged]
          and out_mv.startswith(f"ok: {2 * pairs[merged]} files"), f"merge_datasets: {merge_row} {out_m}")
    # cross_val_ckpts' XXL4 row, here on the CPU: the same forward and PSNR
    t_cpu = time.perf_counter()
    cpu_model = common.load_model(CKPT, WaveMambaConfig(), "cpu")
    images = [(common.read_rgb(crop_in), common.read_rgb(crop_gt))]
    xxl4_cpu_db = float(np.mean([common.psnr(np.clip(common.restore(cpu_model, x), 0, 1), g)
                                 for x, g in images]))
    cpu_s = time.perf_counter() - t_cpu
    del cpu_model
    outs = wait_children(first, timeout=600)
    texts = {name: text for name, (_, text) in outs.items()}
    seconds = {name: s for name, (s, _) in outs.items()}
    cross = {m.group(1): float(m.group(2)) for m in
             re.finditer(r"ckpt (\d+): PSNR ([-+\w.]+) dB \(n=\d+\)", texts["cross_val_ckpts"])}
    cross_row = {"psnr_db": cross, "xxl4_cpu_db": xxl4_cpu_db, "cpu_s": cpu_s, "images": len(images),
                 "xxl4_abs_db": abs(cross.get("011", float("nan")) - xxl4_cpu_db), "tol_db": CROSS_VAL_DB}
    check(len(cross) == 8 and all(np.isfinite(v) for v in cross.values())
          and cross_row["xxl4_abs_db"] <= CROSS_VAL_DB, f"cross_val_ckpts: {cross_row}")
    local = {int(m.group(1)): [float(v) for v in m.groups()[1:]] for m in re.finditer(
        r"tile=(\d+): PSNR ([-+\w.]+) dB  mean\|d\| seam-band ([-+\w.]+) vs interior ([-+\w.]+)",
        texts["tiled_localize"])}
    check(sorted(local) == [64, 128] and np.isfinite(list(local.values())).all(),
          f"tiled_localize: {local} {texts['tiled_localize'][-1500:]}")
    fidelity = script_json(texts["tiled_fidelity"], "tiled_fidelity")["tiled_fidelity"]
    check(fidelity["finite"] and all(np.isfinite(fidelity[k]) for k in ("psnr", "max_abs")),
          f"tiled_fidelity: {fidelity}")
    logged = {}
    for log in glob.glob(os.path.join(exp, "train_*.log")):
        with open(log) as f:
            for m in re.finditer(r"Validation @ iter (\d+) \([\d.]+s\): psnr: ([-\d.]+), ssim: ([-\d.]+)",
                                 f.read()):
                logged.setdefault(int(m.group(1)), (m.group(2), m.group(3)))
    check(sorted(logged) == list(range(1, SCRIPTS_ITERS + 1)),
          f"the run validated at every iteration: {logged} {texts['train'][-1500:]}")

    # The run's checkpoints; the trace of one forward, here.
    x = torch.from_numpy((np.random.RandomState(131).rand(1, 512, 512, 3) * 0.12)
                         .astype(np.float32)).cuda()
    trace_dir = os.path.join(SCRIPTS_DIR, "trace")
    _, _, traced, sessions = trace_forward(stock, x, trace_dir)
    samples, exported = os.path.join(SCRIPTS_DIR, "samples"), os.path.join(SCRIPTS_DIR, "exported.pth")
    second = run_children({
        "eval_run_ckpts": script_cmd("eval_run_ckpts", exp, "--root", SCRIPTS_DIR, "--work_dir",
                                     os.path.join(SCRIPTS_DIR, "eval_work")),
        "post_train_eval": script_cmd("post_train_eval", "--exp", exp, "--out", exported, "--val",
                                      os.path.join(small, "val"), "--n-samples", 1, "--prefix",
                                      "scripts", "--samples_dir", samples),
        "trace_topops": script_cmd("trace_topops", trace_dir, "--top", 0),
    }, logs, timeout=600, cwd=SCRIPTS_DIR)
    for name, (s, text) in second.items():
        texts[name], seconds[name] = text, s
    evaluated = {m.group(1): (m.group(2), m.group(3)) for m in re.finditer(
        r"^(net_g(?:_ema)?_\d+): psnr=([-\d.]+), ssim=([-\d.]+)", texts["eval_run_ckpts"], re.M)}
    pairs_ev = {it: (evaluated.get(f"net_g_ema_{it}"), logged[it]) for it in logged}
    eval_row = {"labels": sorted(evaluated), "ema_vs_logged": pairs_ev,
                "same_digits": all(a == b for a, b in pairs_ev.values()),
                "best": [ln for ln in texts["eval_run_ckpts"].splitlines() if ln.startswith("BEST by")]}
    check(len(evaluated) == 2 * SCRIPTS_ITERS and eval_row["best"]
          and all(a is not None and max(abs(float(p) - float(q)) for p, q in zip(a, b)) <= 1e-4
                  for a, b in pairs_ev.values()),
          f"eval_run_ckpts gives the run's logged validations: {eval_row}")
    post = texts["post_train_eval"]
    m = re.search(r"img0: \w+ vs cpu max\|d\|=([-+\w.]+)", post)
    post_row = {"strict_load": "strict load ok" in post, "max_abs_vs_cpu": float(m.group(1)) if m else None,
                "atol": MODEL_ATOL, "exported": os.path.exists(exported)}
    check(post_row["strict_load"] and post_row["exported"] and post_row["max_abs_vs_cpu"] is not None
          and post_row["max_abs_vs_cpu"] <= MODEL_ATOL, f"post_train_eval: {post_row} {post[-1500:]}")
    rows_t = [ln.split() for ln in texts["trace_topops"].splitlines()
              if ln.endswith("%") and len(ln.split()) == 4]
    k1_calls = sum(int(r[2]) for r in rows_t if r[0] in ("chunk_scan", "chunk_prefix"))
    want_calls = K1_TRACE_KERNELS * (traced // sessions)
    trace_row = {"rows": len(rows_t), "k1_kernel_calls": k1_calls, "want": want_calls,
                 "k1_rows": [r for r in rows_t if r[0].startswith("chunk_")], "top": rows_t[:5],
                 "k1_launches": traced, "sessions": sessions,
                 "short_profile": k1_calls < want_calls,
                 "total": [ln for ln in texts["trace_topops"].splitlines() if "total device" in ln]}
    check(0 < k1_calls <= want_calls and want_calls == K1_TRACE_KERNELS * K1_PER_FORWARD,
          f"trace_topops finds K1's kernels: {trace_row} {texts['trace_topops'][-1500:]}")
    # metrics_sweep over the restored sample against its GT, and the same metrics here
    name = os.path.basename(crop_gt)
    for sub, src in (("pred", os.path.join(samples, "scripts_00_restored.png")), ("gt", crop_gt)):
        os.makedirs(os.path.join(SCRIPTS_DIR, "sweep", sub))
        shutil.copy(src, os.path.join(SCRIPTS_DIR, "sweep", sub, name))
    rc_s, out_s = run_script("metrics_sweep", "-p", os.path.join(SCRIPTS_DIR, "sweep", "pred"),
                             "-g", os.path.join(SCRIPTS_DIR, "sweep", "gt"), "-m", "psnr", "ssim",
                             "-o", os.path.join(SCRIPTS_DIR, "sweep", "metrics.csv"))
    swept = {m.group(1): float(m.group(2)) for m in re.finditer(r"Average (\w+): ([-\d.]+)", out_s)}
    pred, gt = (imread(os.path.join(SCRIPTS_DIR, "sweep", sub, name)) for sub in ("pred", "gt"))
    here = {"psnr": calculate_psnr(pred, gt, crop_border=0, test_y_channel=False),
            "ssim": calculate_ssim(pred, gt, crop_border=0, test_y_channel=False)}
    sweep_row = {"sweep": swept, "here": here}
    check(rc_s == 0 and sorted(swept) == ["psnr", "ssim"]
          and all(abs(swept[k] - here[k]) <= 1e-6 for k in here), f"metrics_sweep: {sweep_row} {out_s}")

    # The measurements, each alone on the card.
    # five forwards a timed rep (the script's default is JAX's ten)
    third = run_children({"conv1x1_sweep": script_cmd("conv1x1_sweep", "--iters", 5)}, logs,
                         timeout=600)
    third.update(run_children({"chain_tune": script_cmd("chain_tune")}, logs, timeout=600))
    for name, (s, text) in third.items():
        texts[name], seconds[name] = text, s
    sweep = script_json(texts["conv1x1_sweep"], "conv1x1_sweep")["conv1x1_sweep"]
    check(len(sweep) == 4 and all(r["finite"] and r["k1_per_forward"] == K1_PER_FORWARD
                                  and r["psnr_vs_float32"] >= FAST_VS_F32_PSNR for r in sweep),
          f"conv1x1_sweep: {sweep}")
    tune = script_json(texts["chain_tune"], "chain_tune")
    tol = lambda e: (e["vs_plain"]["share_beyond_step"] <= 1.0 - CHAIN_TIGHT_SHARE  # noqa: E731
                     and e["vs_plain"]["excess_over_step"] <= CHAIN_LOOSE_REL)
    check(all("fail" not in r["band"]["16"] for r in tune["chain_tune"])
          and all(tol(e) for r in tune["chain_tune"] for e in r["band"].values() if "fail" not in e)
          and all("ms" in f for f in tune["forward"].values()),
          f"chain_tune: {tune}")
    counts = {name: script_launches(texts[name]) for name in texts  # the scripts on the card
              if name not in ("train", "trace_topops")}
    row = {"phase": "scripts", "smi": smi, "manifest": manifest_row, "merge": merge_row,
           "cross_val_ckpts": cross_row, "tiled_localize": local, "tiled_fidelity": fidelity,
           "eval_run_ckpts": eval_row, "post_train_eval": post_row, "trace_topops": trace_row,
           "metrics_sweep": sweep_row, "conv1x1_sweep": sweep, "chain_tune": tune,
           "launches_by_script": counts, "child_s": seconds,
           "k1_launches": traced + sum(c["K1"] for c in counts.values()),
           "k7_launches": sum(c["K7"] for c in counts.values()),
           "phase_s": time.perf_counter() - t0}
    emit(row)
    return row


PARALLEL_DIR = os.path.join(ROOT, "build", "chip_smoke", "parallel")
# Steps of the NCCL child's bit check and of the two gloo ranks' check, and
# timed steps each of the grouped and the ungrouped trainer, in turns whose
# order alternates (ABBA).
PARALLEL_STEPS, PARALLEL_TIMED = 3, 12
# Two gloo ranks (batch 4 each) against the ungrouped batch-8 steps on the
# same 8 images: only the order of the gradient mean differs. The losses
# rtol 1e-5, as tests/test_torch_parallel.py's data-parallel step. The
# parameters 1e-4 absolute, a fifth of the yml's lr (the card read 4.07e-5
# on 3 of 1,512,718 parameters: AdamW turns a last-bit difference in a
# near-zero gradient into a fraction of lr). The planted fault, each rank
# stepping on its own gradients, must land beyond it. The line also counts
# the parameters beyond 2e-5.
PARALLEL_LOSS_RTOL, PARALLEL_PARAM_ATOL = 1e-5, 1e-4
SEQ_ATOL = 3e-5  # the sequence-sharded forward against 'chunked': JAX's tests/test_seq_scan.py
TILE_MESH_ATOL = 1e-5  # the ranks' tiles against one process's, float32
PARALLEL_SEQ_SIZE = 512  # the seq-sharded forward gathers y: 566 MB a scan at 1080p level 1
PARALLEL_BATCH_SEED = 81


def child_cmd(fn, *args):
    """argv of a fresh interpreter that runs `chip_smoke.<fn>(*args)` (as
    strings): the card is initialised in this process, so children are never
    forked from it."""
    return [sys.executable, "-c", f"import sys, chip_smoke; chip_smoke.{fn}(*sys.argv[1:])",
            *map(str, args)]


def start_children(cmds, log_dir, env=None, cwd=ROOT):
    """Start every {name: argv} at once, each writing its output to
    `log_dir/<name>.log`."""
    env = {**os.environ, "PYTHONPATH": ROOT, **(env or {})}
    os.makedirs(log_dir, exist_ok=True)
    procs = {}
    for name, argv in cmds.items():
        log = os.path.join(log_dir, f"{name}.log")
        with open(log, "w") as f:
            procs[name] = (time.perf_counter(), log,
                           subprocess.Popen(argv, cwd=cwd, env=env, stdout=f,
                                            stderr=subprocess.STDOUT))
    return procs


def wait_children(procs, timeout=900):
    """Wait for every child of `start_children`. The first that exits
    non-zero (or the time limit) stops the others and fails the run with
    the end of its output. {name: (seconds, output)}."""
    ends, deadline = {}, time.perf_counter() + timeout
    try:
        while len(ends) < len(procs):
            for name, (t0, _, proc) in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter() - t0
            bad = [n for n in ends if procs[n][2].returncode != 0]
            if bad or time.perf_counter() > deadline:
                name = bad[0] if bad else next(n for n in procs if n not in ends)
                with open(procs[name][1]) as f:
                    text = f.read()
                check(False, f"child {name} exited {procs[name][2].returncode}: {text[-3000:]}")
            time.sleep(0.2)
    finally:
        stop_children(procs)
    out = {}
    for name, (_, log, _) in procs.items():
        with open(log) as f:
            out[name] = (ends[name], f.read())
    return out


def stop_children(procs):
    """Kill every child of `start_children` that is still running."""
    for _, _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_children(cmds, log_dir, timeout=900, env=None, cwd=ROOT):
    """`start_children` then `wait_children`."""
    return wait_children(start_children(cmds, log_dir, env, cwd), timeout)


def parallel_opt(device):
    """The uhdll yml's `network_g` and `train` sections (block recompute as
    the yml leaves it: 'save_scan') for a `RestorationModel` on `device`."""
    opt = data_train_opt(PARALLEL_BATCH_SEED, PARALLEL_DIR)
    opt["device"] = str(device)
    return opt


def parallel_batches():
    """PARALLEL_STEPS seeded batches of TRAIN_BATCH x 512x512 on the card."""
    return [synthetic_batch(PARALLEL_BATCH_SEED + s, TRAIN_BATCH, TRAIN_SIZE)
            for s in range(PARALLEL_STEPS)]


def _numpy_params(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _timed_step(runner, lq, gt):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = runner.optimize_parameters({"lq": lq, "gt": gt})
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, metrics


def parallel_nccl_child(init, out):
    """A process group of one rank over NCCL: the uhdll yml's trainer steps
    PARALLEL_STEPS seeded batches without the group (twice, to show the
    steps repeat) and with it (`make_mesh()`: the gradients through NCCL's
    all_reduce), under deterministic algorithms, from the same seeded
    weights; then PARALLEL_TIMED steps of each in turns (ABBA), K1 / K2
    launches counted over the grouped ones, and the gradient mean timed
    alone. Writes a pickle to `out`."""
    import pickle
    import warnings

    from wavemamba_torch import parallel
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd
    from wavemamba_torch.runner import RestorationModel

    set_parity_mode()
    device = parallel.initialize(init, 1, 0, device="cuda")
    mesh = parallel.make_mesh()
    row = {"backend": torch.distributed.get_backend(), "device": str(device)}
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    batches = parallel_batches()

    def run(with_mesh):
        runner = RestorationModel(parallel_opt(device), mesh=mesh if with_mesh else None)
        losses = [float(runner.reduce_metrics(runner.optimize_parameters({"lq": lq, "gt": gt}))
                        ["total"]) for lq, gt in batches]
        return runner, losses

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = {}
        for name, with_mesh in (("ungrouped", False), ("ungrouped_again", False), ("grouped", True)):
            runner, losses = run(with_mesh)
            runs[name] = (losses, _numpy_params(runner.model))
            del runner
            torch.cuda.empty_cache()
    row["nondeterministic_ops"] = sorted({str(w.message).split(" does not have")[0][:160]
                                          for w in caught if "deterministic" in str(w.message)})
    same = lambda a, b: all(np.array_equal(a[1][k], b[1][k]) for k in a[1])  # noqa: E731
    row["ungrouped_repeats_bitwise"] = same(runs["ungrouped"], runs["ungrouped_again"])
    row["grouped_equals_ungrouped_bitwise"] = same(runs["grouped"], runs["ungrouped"])
    row["losses_equal"] = runs["grouped"][0] == runs["ungrouped"][0]
    row["losses"] = runs["ungrouped"][0]
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.benchmark = True
    runners = {name: RestorationModel(parallel_opt(device), mesh=m)
               for name, m in (("ungrouped", None), ("grouped", mesh))}
    lq, gt = batches[0]
    for runner in runners.values():  # warm-up
        _timed_step(runner, lq, gt)
    ms = {name: [] for name in runners}
    k1 = k2 = 0
    for turn in range(PARALLEL_TIMED):
        for name in sorted(runners, reverse=turn % 2 == 1):
            runner = runners[name]
            if name == "grouped":
                ss2d_scan_pair.launches = ss2d_scan_pair_bwd.launches = 0
            step_ms, _ = _timed_step(runner, lq, gt)
            ms[name].append(step_ms)
            if name == "grouped":
                k1, k2 = k1 + ss2d_scan_pair.launches, k2 + ss2d_scan_pair_bwd.launches
    # what the group adds to a step: the mean of the gradients (`parallel.mesh.mean_`:
    # a concatenation, one all_reduce, a copy back per tensor), timed alone
    from wavemamba_torch.parallel.mesh import mean_

    grads = [torch.zeros_like(p) for p in runners["grouped"].model.parameters()]
    row["grad_mean_ms"] = cuda_ms(lambda: mean_(mesh, grads), 20)
    row.update({"step_ms": ms, "ms_per_step": {k: float(np.median(v)) for k, v in ms.items()},
                "k1_launches": k1, "k2_launches": k2, "k1_per_step": k1 / PARALLEL_TIMED,
                "k2_per_step": k2 / PARALLEL_TIMED, "steps_timed": PARALLEL_TIMED})
    with open(out, "wb") as f:
        pickle.dump({"row": row, "ungrouped_params": runs["ungrouped"][1]}, f)
    parallel.dist.shutdown()


def gloo_collectives(device):
    """Which collectives gloo runs on CUDA tensors here, each tried once."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    trials = {
        "broadcast": lambda t: dist.broadcast(t, 0),
        "all_reduce": lambda t: dist.all_reduce(t),
        "all_gather": lambda t: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda t: dist.all_gather_into_tensor(
            t.new_empty(world * t.numel()), t),
        "reduce_scatter_tensor": lambda t: dist.reduce_scatter_tensor(
            t.new_empty(t.numel() // world), t),
    }
    out = {}
    for name, fn in trials.items():
        try:
            fn(torch.full((4 * world,), float(rank), device=device))
            torch.cuda.synchronize()
            out[name] = True
        except Exception as e:  # noqa: BLE001 - recorded, not relied on
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def seq_input():
    rs = np.random.RandomState(91)
    return (rs.rand(1, PARALLEL_SEQ_SIZE, PARALLEL_SEQ_SIZE, 3) * 0.12).astype(np.float32)


def tile_frame():
    """`phase_tile`'s seeded 2160x3840 request."""
    return (np.random.RandomState(7).rand(1, 2160, 3840, 3) * 0.12).astype(np.float32)


def cache_arrays():
    """A small synthetic uint8 set: 6 pairs of 64x64 (lq, gt, paths, opt)."""
    rs = np.random.RandomState(93)
    gt = rs.randint(0, 256, (6, 64, 64, 3), np.uint8)
    lq = (gt // 4).astype(np.uint8)
    paths = [{"lq_path": f"lq{i}", "gt_path": f"gt{i}"} for i in range(6)]
    opt = {"phase": "train", "gt_size": 32, "scale": 1, "geometric_augs": True}
    return lq, gt, paths, opt


def cache_loader(device, mesh=None):
    from wavemamba_torch.data import DeviceCachedLoader, EnlargedSampler

    lq, gt, paths, opt = cache_arrays()
    loader = DeviceCachedLoader.from_arrays(lq, gt, paths, opt, 4, sampler=EnlargedSampler(6, 1, 0, 2),
                                            seed=7, device=device, mesh=mesh)
    loader.set_epoch(1)
    return loader


# (f) Training through the sequence-sharded scan: SEQ_TRAIN_STEPS trainer
# steps of the XXL4 checkpoint at batch SEQ_TRAIN_BATCH of 256x256, float32
# parity mode, on two gloo ranks (each handed its row; the step gathers the
# global batch), against the same steps in one process with the 'chunked'
# scan, on the parameters within PARALLEL_PARAM_ATOL. A planted fault, the
# output gather's gradient summed over the ranks (n times the true
# gradient), must land beyond it.
SEQ_TRAIN_BATCH, SEQ_TRAIN_SIZE, SEQ_TRAIN_STEPS = 2, 256, 2


def seq_train_batches():
    return [synthetic_batch(PARALLEL_BATCH_SEED + 20 + s, SEQ_TRAIN_BATCH, SEQ_TRAIN_SIZE)
            for s in range(SEQ_TRAIN_STEPS)]


def seq_train(device, mesh=None, fault=False):
    """SEQ_TRAIN_STEPS steps of `make_train_step(TrainConfig(), mesh)` (the
    uhdll yml's defaults) from the XXL4 checkpoint on `seq_train_batches()`:
    with a mesh, `scan_impl: seq_sharded` over it, each rank handed its rows;
    without, 'chunked' on the whole batch. `fault` plants the summed output
    gradient. (each step's ms, the parameters as numpy)."""
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.models import build_network
    from wavemamba_torch.parallel import mesh as pmesh
    from wavemamba_torch.parallel import seq_scan
    from wavemamba_torch.train import trainer

    net = ({"type": "WaveMamba", "scan_impl": "chunked"} if mesh is None else
           {"type": "WaveMamba", "scan_impl": "seq_sharded", "scan_mesh": mesh})
    model = build_network(net, load_network(CKPT, device=device), device=device)
    tcfg = trainer.TrainConfig()
    state = trainer.create_train_state(model, tcfg)
    step = trainer.make_train_step(tcfg, mesh)
    real = seq_scan.selective_scan_seq_sharded

    def summed(*args, **kwargs):
        y = real(*args, **kwargs)
        y.register_hook(lambda g: pmesh.all_reduce_sum_(mesh, g.clone()))
        return y

    seq_scan.selective_scan_seq_sharded = summed if fault else real
    ms = []
    try:
        for lq, gt in seq_train_batches():
            batch = pmesh.shard_batch(mesh, {"lq": lq.to(device), "gt": gt.to(device)})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch["lq"], batch["gt"])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        seq_scan.selective_scan_seq_sharded = real
    return ms, _numpy_params(model)


def parallel_gloo_child(init, rank, out_dir):
    """Rank `rank` of two over gloo, both on cuda:0: (b) PARALLEL_STEPS
    steps of the uhdll yml's trainer at batch_size_per_gpu 4 (global 8),
    each rank on its rows of `parallel_batches()`, then the same steps
    without the mesh (the planted fault: each rank on its own gradients); (c) the XXL4 checkpoint
    with `scan_impl: seq_sharded` on `seq_input()`; (d) `tiled_apply_mesh`
    of `tile_frame()` at 240 / 16; (e) the device cache's slices of the
    global batch; (f) `seq_train` over the mesh, and again with its planted
    fault; and which collectives gloo runs on CUDA tensors. Writes
    `rank<r>.pkl` (and rank 0 the arrays) under `out_dir`."""
    import pickle

    from wavemamba_torch import parallel
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.tiling import tiled_apply_mesh
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.ops.scan_cuda import ss2d_scan_pair, ss2d_scan_pair_bwd
    from wavemamba_torch.runner import RestorationModel

    rank = int(rank)
    set_parity_mode()
    device = parallel.initialize(init, 2, rank, backend="gloo", device="cuda:0")
    mesh = parallel.make_mesh()
    row = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(device),
           "mesh": repr(mesh), "gloo_cuda_collectives": gloo_collectives(device)}
    arrays = {}
    # (b) data parallel on one card
    runner = RestorationModel(parallel_opt(device), mesh=mesh)
    losses, ms = [], []
    ss2d_scan_pair.launches = ss2d_scan_pair_bwd.launches = 0
    for lq, gt in parallel_batches():
        batch = parallel.shard_batch(mesh, {"lq": lq, "gt": gt})
        step_ms, metrics = _timed_step(runner, batch["lq"], batch["gt"])
        losses.append(float(runner.reduce_metrics(metrics)["total"]))
        ms.append(step_ms)
    row["train"] = {"batch_size_per_gpu": int(batch["lq"].shape[0]), "losses": losses,
                    "step_ms": ms, "k1_launches": ss2d_scan_pair.launches,
                    "k2_launches": ss2d_scan_pair_bwd.launches}
    arrays["params"] = _numpy_params(runner.model)
    del runner
    # the planted fault: the same steps with each rank on its own gradients
    runner = RestorationModel(parallel_opt(device))
    for lq, gt in parallel_batches():
        runner.optimize_parameters(parallel.shard_batch(mesh, {"lq": lq, "gt": gt}))
    arrays["params_unaveraged"] = _numpy_params(runner.model)
    del runner
    torch.cuda.empty_cache()
    sd = load_network(CKPT, device=device)
    # (c) the sequence-sharded forward
    seq = build_network({"type": "WaveMamba", "scan_impl": "seq_sharded", "scan_mesh": mesh}, sd,
                        device=device)
    x = torch.from_numpy(seq_input()).to(device)
    wavemamba_apply(seq, x[:, :64, :64])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = wavemamba_apply(seq, x)
    torch.cuda.synchronize()
    row["seq_sharded"] = {"image": [PARALLEL_SEQ_SIZE] * 2, "ms": (time.perf_counter() - t0) * 1e3}
    arrays["seq"] = y.cpu().numpy()
    del seq, y
    # (d) the sharded tiles, K1 in each
    stock = build_network({"type": "WaveMamba"}, sd, device=device)
    tiled_apply_mesh(wavemamba_apply, stock, tile_frame()[:, :240, :480], mesh, tile_size=240,
                     tile_pad=16)  # warm-up
    torch.cuda.synchronize()
    ss2d_scan_pair.launches = 0
    t0 = time.perf_counter()
    tiles = tiled_apply_mesh(wavemamba_apply, stock, tile_frame(), mesh, tile_size=240, tile_pad=16)
    row["tiles"] = {"s": time.perf_counter() - t0, "k1_launches": ss2d_scan_pair.launches}
    if rank == 0:
        np.save(os.path.join(out_dir, "tiles.npy"), tiles)
    del stock
    # (e) the device cache under the group
    arrays["cache"] = [(b["lq"].cpu().numpy(), b["gt"].cpu().numpy(), b["lq_path"])
                       for b in cache_loader(device, mesh)]
    # (f) training through the sequence-sharded scan
    torch.cuda.empty_cache()
    ms, arrays["seq_train"] = seq_train(device, mesh)
    fault_ms, arrays["seq_train_fault"] = seq_train(device, mesh, fault=True)
    row["seq_train"] = {"step_ms": ms, "fault_step_ms": fault_ms}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"row": row, "arrays": arrays}, f)
    parallel.barrier()
    parallel.dist.shutdown()


def phase_parallel(stock, smi):
    """Multi-GPU on the one card. (a) `torchrun --standalone
    --nproc_per_node=1 -m wavemamba_torch.pipelines.train -opt
    options/train_wavemamba_uhdll.yml` (NCCL at world size 1) for 1 + 4
    iterations on the data phase's generated set, beside (b)-(f) on two gloo
    ranks sharing cuda:0 (`parallel_gloo_child`); then the NCCL child's bit
    check and step times, alone on the card (`parallel_nccl_child`). This
    process holds each against its own one-process references."""
    import pickle
    import shutil

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.tiling import tiled_apply
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.parallel.dist import local_init_method

    t0 = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    run_dir, gloo_dir = (os.path.join(PARALLEL_DIR, d) for d in ("torchrun", "gloo"))
    for d in (run_dir, gloo_dir):
        os.makedirs(d)
    torch.cuda.empty_cache()
    proc = os.path.join(ROOT, "build", "chip_smoke", "proc_a")
    force = [f"datasets:train:dataroot_gt={proc}/train/gt",
             f"datasets:train:dataroot_lq={proc}/train/input",
             f"datasets:val:dataroot_gt={proc}/val/gt", f"datasets:val:dataroot_lq={proc}/val/input",
             "train:total_iter=5", "logger:print_freq=1", "logger:use_tb_logger=false"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
                "-m", "wavemamba_torch.pipelines.train", "-opt",
                os.path.join(ROOT, "options", "train_wavemamba_uhdll.yml"), "--force_yml", *force]
    init = local_init_method()
    gloo = {f"gloo_rank{r}": child_cmd("parallel_gloo_child", init, r, gloo_dir) for r in range(2)}
    procs = start_children({"torchrun": torchrun, **gloo}, PARALLEL_DIR, cwd=run_dir)
    # one process's references, while the children run
    sd = load_network(CKPT, device="cuda")
    chunked = build_network({"type": "WaveMamba", "scan_impl": "chunked"}, sd, device="cuda")
    seq_want = wavemamba_apply(chunked, torch.from_numpy(seq_input()).cuda()).cpu().numpy()
    del chunked
    tiles_want = tiled_apply(
        lambda t: wavemamba_apply(stock, torch.from_numpy(np.ascontiguousarray(t)).cuda()).cpu().numpy(),
        tile_frame(), tile_size=240, tile_pad=16)
    cache_want = [(b["lq"].cpu().numpy(), b["gt"].cpu().numpy(), b["lq_path"])
                  for b in cache_loader("cuda")]
    del sd
    torch.cuda.empty_cache()
    seq_train_ms, seq_train_want = seq_train(torch.device("cuda"))
    torch.cuda.empty_cache()
    children = wait_children(procs)
    # (a) the entry point
    text = children["torchrun"][1]
    exp = os.path.join(run_dir, "experiments", "001_WaveMamba_UHDLL")
    iters = sum(1 for ln in text.splitlines() if "iter:" in ln and "lr:(" in ln)
    row_a = {"command": "torchrun --standalone --nproc_per_node=1 -m wavemamba_torch.pipelines.train "
                        "-opt options/train_wavemamba_uhdll.yml --force_yml " + " ".join(force),
             "s": children["torchrun"][0], "iterations_logged": iters,
             "global_batch_logged": "global batch 8 (1 process(es) x 8)" in text,
             "nccl_logged": "process group: nccl, 1 rank(s)" in text,
             "checkpoint": os.path.exists(os.path.join(exp, "models", "net_g_latest.pth"))}
    check(iters == 5 and row_a["global_batch_logged"] and row_a["nccl_logged"]
          and row_a["checkpoint"], f"the torchrun entry point: {row_a} {text[-2000:]}")
    # (b)-(e) the two gloo ranks
    ranks = []
    for r in range(2):
        with open(os.path.join(gloo_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    # the NCCL child, alone on the card
    nccl_out = os.path.join(PARALLEL_DIR, "nccl.pkl")
    nccl_s = run_children({"nccl": child_cmd("parallel_nccl_child", local_init_method(),
                                             nccl_out)},
                          PARALLEL_DIR, env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})["nccl"][0]
    with open(nccl_out, "rb") as f:
        nccl = pickle.load(f)
    row_n = {**nccl["row"], "s": nccl_s}
    check(row_n["backend"] == "nccl" and row_n["grouped_equals_ungrouped_bitwise"]
          and row_n["losses_equal"], f"NCCL at world size 1: the grouped steps' bits {row_n}")
    check((row_n["k1_per_step"], row_n["k2_per_step"]) == (28, 28),
          f"{row_n['k1_per_step']} K1 / {row_n['k2_per_step']} K2 a grouped step")
    want = nccl["ungrouped_params"]
    b_rows = []
    for res in ranks:
        got = res["arrays"]["params"]
        diff = np.array([np.abs(got[k] - want[k]).max() for k in want])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(res["row"]["train"]["losses"],
                                                             row_n["losses"]))
        fault = res["arrays"]["params_unaveraged"]
        b_rows.append({**res["row"]["train"], "loss_rel_vs_batch8": loss_rel,
                       "param_max_abs_vs_batch8": float(diff.max()),
                       "unaveraged_param_max_abs_vs_batch8": float(max(
                           np.abs(fault[k] - want[k]).max() for k in want)),
                       "params_beyond_2e-5": int(sum(int((np.abs(got[k] - want[k]) > 2e-5).sum())
                                                     for k in want))})
    same_ranks = all(np.array_equal(ranks[0]["arrays"]["params"][k], ranks[1]["arrays"]["params"][k])
                     for k in want)
    seq_err = [float(np.abs(res["arrays"]["seq"] - seq_want).max()) for res in ranks]
    tiles = np.load(os.path.join(gloo_dir, "tiles.npy"))
    tile_err = float(np.abs(tiles - tiles_want).max())
    cache_same = all(
        np.array_equal(np.concatenate([ranks[0]["arrays"]["cache"][i][j], ranks[1]["arrays"]["cache"][i][j]]),
                       want_b[j]) for i, want_b in enumerate(cache_want) for j in (0, 1)) and all(
        ranks[0]["arrays"]["cache"][i][2] + ranks[1]["arrays"]["cache"][i][2] == w[2]
        for i, w in enumerate(cache_want))
    seq_diff = lambda got: float(max(np.abs(got[k] - seq_train_want[k]).max()  # noqa: E731
                                     for k in seq_train_want))
    f_rows = [{**res["row"]["seq_train"],
               "param_max_abs_vs_chunked": seq_diff(res["arrays"]["seq_train"]),
               "fault_param_max_abs_vs_chunked": seq_diff(res["arrays"]["seq_train_fault"])}
              for res in ranks]
    row_f = {"ranks": f_rows, "chunked_step_ms": seq_train_ms, "batch": SEQ_TRAIN_BATCH,
             "image": [SEQ_TRAIN_SIZE] * 2, "steps": SEQ_TRAIN_STEPS, "atol": PARALLEL_PARAM_ATOL,
             "ranks_same_bits": all(np.array_equal(v, ranks[1]["arrays"]["seq_train"][k])
                                    for k, v in ranks[0]["arrays"]["seq_train"].items()),
             "fault": "the output gather's gradient summed over the ranks"}
    row = {"phase": "parallel", "smi": smi, "a_torchrun_nccl": row_a,
           "a_nccl_world1": row_n,
           "b_gloo_two_ranks": {"ranks": b_rows, "ranks_same_bits": same_ranks,
                                "note": "two ranks sharing one card: a correctness run, "
                                        "not a scaling figure"},
           "c_seq_sharded": {**ranks[0]["row"]["seq_sharded"], "max_abs_vs_chunked": seq_err,
                             "atol": SEQ_ATOL},
           "d_tiles": {"ranks": [res["row"]["tiles"] for res in ranks],
                       "max_abs_vs_one_process": tile_err, "atol": TILE_MESH_ATOL},
           "e_device_cache": {"batches": len(cache_want), "slices_equal_global_batch": cache_same},
           "f_seq_sharded_train": row_f,
           "gloo_cuda_collectives": ranks[0]["row"]["gloo_cuda_collectives"],
           "children_s": {k: v[0] for k, v in children.items()},
           "phase_s": time.perf_counter() - t0}
    row["k1_launches"] = row_n["k1_launches"] + sum(r["k1_launches"] for r in b_rows) + sum(
        r["k1_launches"] for r in row["d_tiles"]["ranks"])
    row["k2_launches"] = row_n["k2_launches"] + sum(r["k2_launches"] for r in b_rows)
    emit(row)
    for r in b_rows:
        check(r["loss_rel_vs_batch8"] <= PARALLEL_LOSS_RTOL,
              f"two gloo ranks' losses against the batch-8 steps: {r['loss_rel_vs_batch8']}")
        check(r["param_max_abs_vs_batch8"] <= PARALLEL_PARAM_ATOL,
              f"two gloo ranks' parameters against the batch-8 steps: {r['param_max_abs_vs_batch8']}")
        check(r["unaveraged_param_max_abs_vs_batch8"] > PARALLEL_PARAM_ATOL,
              f"the planted fault (unaveraged gradients) is within the tolerance: "
              f"{r['unaveraged_param_max_abs_vs_batch8']}")
        check((r["k1_launches"], r["k2_launches"]) == (28 * PARALLEL_STEPS,) * 2,
              f"a gloo rank's K1 / K2 launches: {r['k1_launches']} / {r['k2_launches']}")
    check(same_ranks, "the two gloo ranks end with the same parameters")
    check(max(seq_err) <= SEQ_ATOL, f"the seq-sharded forward against 'chunked': {seq_err}")
    check(tile_err <= TILE_MESH_ATOL, f"the sharded tiles against one process's: {tile_err}")
    tiles_n = -(-2160 // 240) * -(-3840 // 240)
    for r in row["d_tiles"]["ranks"]:
        check(r["k1_launches"] == 28 * -(-tiles_n // 8), f"a rank's K1 in the tiles: {r}")
    check(cache_same, "the device cache's slices are the global batch, bit for bit")
    for r in f_rows:
        check(r["param_max_abs_vs_chunked"] <= PARALLEL_PARAM_ATOL,
              f"seq-sharded training against one 'chunked' process: {r}")
        check(r["fault_param_max_abs_vs_chunked"] > PARALLEL_PARAM_ATOL,
              f"the planted fault (the output gradient summed over the ranks) is caught: {r}")
    return row


ART_DIR = os.path.join(ROOT, "build", "chip_smoke", "art")
# ART at 1 + 4 iterations of the uhdll yml (its `network_g` swapped for
# `{type: ART}`, ARTConfig's defaults: dim 48, 8 blocks), batch 8 of 512x512.
ART_ITERS = 5
# ART on the card against the CPU at 64x96, float32 parity (TF32 off): as
# MODEL_ATOL, cuDNN / cuBLAS against the CPU's sums over 8 blocks.
ART_CPU_ATOL = 1e-4
# The fused attention route on the card against the formula that builds the
# scores, at a training shape: max |a - b| over max |b| of the output and of
# each gradient, at the gradient rtol of `tests/test_torch_art_serve.py`.
ART_ATTN_RTOL = 1e-4
# The secondary pieces on the card against the CPU, float32 parity: the VGG19
# perceptual and style losses relative (means of sums over up to 4,608 terms
# a value, taken in another order), LPIPS absolute (a distance of order
# 0.1-1, an average over the frame), the GAN penalties and the penalty's
# gradient by their max abs difference over their max abs value.
VGG_LOSS_RTOL = 1e-4
LPIPS_ATOL = 1e-5
GAN_RTOL = 1e-4


def art_yml(name, dataroot):
    """The uhdll yml as a user would edit it for ART: `network_g: {type: ART}`,
    the generated set as its data, ART_ITERS iterations logged each, the
    final validation on the generated set's pair, and one loader thread:
    the dataset draws its crops and modes from Python's global `random` (as
    JAX's does), so with the yml's 8 threads the batches hang on the
    threads' order, and two runs differ from the first step. Written under
    ART_DIR; returns its path."""
    import yaml

    from wavemamba_torch.utils.options import yaml_load

    opt = yaml_load(os.path.join(ROOT, "options", "train_wavemamba_uhdll.yml"))
    opt = json.loads(json.dumps(opt))  # plain dicts for the dumper
    opt["name"] = name
    opt["network_g"] = {"type": "ART"}
    for phase, sub in (("train", "train"), ("val", "val")):
        opt["datasets"][phase]["dataroot_gt"] = os.path.join(dataroot, sub, "gt")
        opt["datasets"][phase]["dataroot_lq"] = os.path.join(dataroot, sub, "input")
    opt["datasets"]["train"]["num_worker_per_gpu"] = 1
    opt["train"]["total_iter"] = ART_ITERS
    opt["logger"].update({"print_freq": 1, "save_checkpoint_freq": ART_ITERS,
                          "use_tb_logger": False})
    path = os.path.join(ART_DIR, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return path


def art_train_child(yml, out):
    """`pipelines.train` of `yml` under deterministic algorithms in a fresh
    process (the card's cuBLAS reads CUBLAS_WORKSPACE_CONFIG at its first
    call): writes the final parameters and the logged losses to `out`."""
    import pickle
    import re

    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.pipelines.train import train_pipeline

    set_parity_mode()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    model = train_pipeline(ART_DIR, ["-opt", yml])
    log = model.opt["path"]["log"]
    text = "".join(open(os.path.join(log, f)).read() for f in sorted(os.listdir(log))
                   if f.endswith(".log"))
    losses = [float(v) for v in re.findall(r"\btotal: ([-+.\deE]+)", text)]
    with open(out, "wb") as f:
        pickle.dump({"params": _numpy_params(model.model), "losses": losses,
                     "validated": "Validation @ iter" in text,
                     "checkpoint": os.path.exists(os.path.join(model.opt["path"]["models"],
                                                               "net_g_latest.pth"))}, f)


def art_attention_check(attn, batch=TRAIN_BATCH, gh=8, gw=8, groups_y=16, groups_x=16):
    """One block's `Attention` (the fused route, the memory-efficient kernel
    on the card, forward and backward) against `attention_by_scores` at a
    training shape: a batch of 8 512x512 crops is a 128x128 token grid, whose
    8x8 dense windows and interval-16 sparse groups are both 16 x 16 groups
    of 8 x 8 = 64 tokens an image. With no pad, and with four pad classes
    (the last row and the last column of groups with a pad row / column of
    tokens). Reads the output and every gradient (x, qkv, proj, the bias
    MLP's weights) against the formula in float32, TF32 off, and both against
    the formula in float64 (whose bias MLP runs in float32: the port's
    `Linear` casts its weight to the input's dtype)."""
    import copy

    from wavemamba_torch.models.art import attention_by_scores, fused_attention

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off for the attention check")
    groups, n = groups_y * groups_x, gh * gw
    c = attn.qkv.in_features
    dev = attn.qkv.weight.device
    gen = torch.Generator(device=dev).manual_seed(105)
    x = torch.randn(batch * groups, n, c, device=dev, generator=gen)
    g = torch.randn(batch * groups, n, c, device=dev, generator=gen)
    marks = np.zeros((groups_y, groups_x, gh, gw), bool)
    marks[-1, :, -1, :] = True
    marks[:, -1, :, -1] = True
    attn64 = copy.deepcopy(attn).double()
    names = ["x"] + [k for k, _ in attn.named_parameters()]
    # The bias MLP's last bias adds one value to every score of a head, which
    # the softmax takes out again: its gradient is 0 but for rounding, so its
    # error is read against its layer's weight gradient, every other one
    # against its own largest value.
    scale = {"d_pos.pos3.2.bias": "d_pos.pos3.2.weight"}

    def run(module, fn, xx, key_pad):
        xx = xx.detach().requires_grad_()
        params = [xx] + list(module.parameters())
        out = fn(module, xx, key_pad)
        return [out] + list(torch.autograd.grad(out, params, g.to(out.dtype)))

    rows = {}
    for pads, key_pad in (("none", None), ("classes", marks.reshape(groups, n))):
        calls = fused_attention.calls
        fused = run(attn, lambda m, xx, kp: m(xx, gh, gw, kp), x, key_pad)
        calls = fused_attention.calls - calls
        formula = run(attn, lambda m, xx, kp: attention_by_scores(m, xx, gh, gw, kp), x, key_pad)
        exact = run(attn64, lambda m, xx, kp: attention_by_scores(m, xx, gh, gw, kp), x.double(),
                    key_pad)
        keys = ["out"] + [f"d_{k}" for k in names]

        def errs(got, want):
            want = {k: t.detach() for k, t in zip(keys, want)}
            return {k: float((a.detach() - want[k]).abs().max() / want[scale.get(k, k)].abs().max())
                    for k, a in zip(keys, got)}

        rows[pads] = {"calls": calls, "rel_err": errs(fused, formula),
                      "fused_vs_f64": errs(fused, exact), "formula_vs_f64": errs(formula, exact)}
        del fused, formula, exact
    torch.cuda.empty_cache()
    return {"shape": [batch * groups, n, c], "heads": attn.num_heads, "rtol": ART_ATTN_RTOL,
            **rows}


def phase_art(smi):
    """ART, the second model family, at its default width on the card: the
    uhdll yml with `network_g: {type: ART}` through `pipelines.train` for
    1 + 4 iterations from the data phase's generated set, twice in child
    processes under deterministic algorithms (finite losses, the same
    parameters' bits, a checkpoint, the final validation through
    `runner.test`); then, here, ms a step and peak memory at batch 8 of
    512x512 through `build_model`, a 2160x3840 request through the CLI's path
    (`img2batch`, `enhance` with the bucket ladder, `batch2img`) timed with
    its peak memory, one block's attention forward and backward against the
    formula that builds the scores at the training shape
    (`art_attention_check`), and a 64x96 forward against the CPU. ART runs no kernel
    of the port: its attention is torch's memory-efficient kernel, one call
    for each grouping (`models/art.py:fused_attention`)."""
    import pickle
    import shutil

    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models import ART, ARTConfig, art_apply, param_count
    from wavemamba_torch.models.art import fused_attention
    from wavemamba_torch.models.buckets import BucketLadder
    from wavemamba_torch.runner import build_model
    from wavemamba_torch.utils.img_util import batch2img, img2batch

    t0 = time.perf_counter()
    shutil.rmtree(ART_DIR, ignore_errors=True)
    os.makedirs(ART_DIR)
    proc = os.path.join(ROOT, "build", "chip_smoke", "proc_a")
    runs = ("art_a", "art_b")
    ymls = {n: art_yml(n, proc) for n in runs}
    cmds = {n: child_cmd("art_train_child", ymls[n], os.path.join(ART_DIR, f"{n}.pkl"))
            for n in runs}
    children = run_children(cmds, ART_DIR, env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    res = []
    for n in runs:
        with open(os.path.join(ART_DIR, f"{n}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    same = all(np.array_equal(res[0]["params"][k], res[1]["params"][k]) for k in res[0]["params"])
    finite = all(np.isfinite(r["losses"]).all() and len(r["losses"]) == ART_ITERS for r in res)
    # ms a step and peak memory, at the yml's batch, from build_model
    opt = data_train_opt(101, proc)
    opt["network_g"] = {"type": "ART"}
    torch.cuda.empty_cache()
    runner = build_model(opt)
    check(isinstance(runner.model, ART) and runner.cfg == ARTConfig(), f"ART built: {runner.cfg}")
    lq, gt = synthetic_batch(102, TRAIN_BATCH, TRAIN_SIZE)
    _timed_step(runner, lq, gt)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ms = [_timed_step(runner, lq, gt)[0] for _ in range(ART_ITERS - 1)]
    peak_train = torch.cuda.max_memory_allocated()
    model = runner.model.eval()
    del runner, lq, gt
    torch.cuda.empty_cache()
    # a 2160x3840 request through the CLI's path; the 2176x3840 bucket's
    # sparse groups hold 34 x 60 = 2,040 tokens
    frame = np.random.RandomState(103).randint(0, 40, (2160, 3840, 3), np.uint8)
    ladder = BucketLadder()
    y = enhance(model, img2batch(frame), ladder)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    calls = fused_attention.calls
    request_ms = []
    for _ in range(3):
        t = time.perf_counter()
        y = enhance(model, img2batch(frame), ladder)
        answer = batch2img(y)
        request_ms.append((time.perf_counter() - t) * 1e3)
    peak_request = torch.cuda.max_memory_allocated()
    calls = (fused_attention.calls - calls) // 3
    attention = art_attention_check(model.restoration_network.feats[0].attn)
    # the card against the CPU, same weights, 64x96
    small = (np.random.RandomState(104).rand(1, 64, 96, 3)).astype(np.float32)
    cpu = ART(ARTConfig())
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_err = float(np.abs(art_apply(model, torch.from_numpy(small).cuda()).cpu().numpy()
                           - art_apply(cpu.eval(), torch.from_numpy(small)).numpy()).max())
    row = {"phase": "art", "smi": smi, "config": dataclasses.asdict(ARTConfig()),
           "params": param_count(model),
           "pipeline": {"command": "python -m wavemamba_torch.pipelines.train -opt "
                                   f"{os.path.relpath(ymls['art_a'], ROOT)}",
                        "iterations": ART_ITERS, "batch": TRAIN_BATCH, "size": TRAIN_SIZE,
                        "losses": [r["losses"] for r in res], "runs_same_bits": same,
                        "validated": [r["validated"] for r in res],
                        "checkpoint": [r["checkpoint"] for r in res],
                        "children_s": {k: v[0] for k, v in children.items()}},
           "ms_per_step": float(np.median(ms)), "step_ms": ms,
           "images_per_s": TRAIN_BATCH / (float(np.median(ms)) / 1e3),
           "peak_memory_train_bytes": peak_train,
           "request_2160x3840": {"ms": float(np.median(request_ms)), "ms_each": request_ms,
                                 "peak_memory_bytes": peak_request, "buckets": ladder.buckets,
                                 "attention_calls": calls, "finite": bool(np.isfinite(y).all()),
                                 "answer_shape": list(answer.shape),
                                 "sparse_group_tokens": (2176 // 4 // 16) * (3840 // 4 // 16)},
           "attention_train_shape": attention,
           "cpu_64x96": {"max_abs_err": cpu_err, "atol": ART_CPU_ATOL},
           "phase_s": time.perf_counter() - t0}
    emit(row)
    check(finite, f"ART's losses: {[r['losses'] for r in res]}")
    check(same, "ART's two deterministic runs end with the same parameters' bits")
    check(all(r["validated"] and r["checkpoint"] for r in res),
          "ART's pipeline validates through runner.test and writes its checkpoint")
    req = row["request_2160x3840"]
    check(req["finite"] and req["answer_shape"] == [2160, 3840, 3],
          f"ART's 2160x3840 request is finite and whole: {req['answer_shape']}")
    check(req["attention_calls"] == 2 * ARTConfig().n_blocks,
          f"one fused attention call for each grouping of each block: {req['attention_calls']}")
    for pads in ("none", "classes"):
        got = attention[pads]
        check(got["calls"] == (1 if pads == "none" else 4),
              f"one fused call for each pad class ({pads}): {got['calls']}")
        check(max(got["rel_err"].values()) <= ART_ATTN_RTOL,
              f"ART's fused attention and its gradients against the scores formula ({pads}): "
              f"{got['rel_err']}")
    check(cpu_err <= ART_CPU_ATOL, f"ART on the card against the CPU: {cpu_err}")
    return row


def _rel(a, b):
    """max |a - b| over max |b| (numpy or tensors)."""
    a, b = (np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
            for v in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _he_conv_weights(net, seed):
    """He-scaled seeded weights (deep activations stay of order 1; there are
    no pretrained VGG19 / LPIPS weights in the repository)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.from_numpy(rs.randn(*m.weight.shape).astype(np.float32)
                                                * np.float32(np.sqrt(2.0 / fan_in))))
                m.bias.copy_(torch.from_numpy(rs.randn(*m.bias.shape).astype(np.float32) * 0.01))
    return net


def _small_disc():
    """A small conv discriminator for the GAN penalties, seeded."""
    return _he_conv_weights(torch.nn.Sequential(
        torch.nn.Conv2d(3, 64, 3, padding=1), torch.nn.LeakyReLU(0.2),
        torch.nn.Conv2d(64, 128, 4, stride=2, padding=1), torch.nn.LeakyReLU(0.2),
        torch.nn.Conv2d(128, 1, 3, padding=1)), 111)


def trace_forward(model, x, trace_dir):
    """`utils/profiler.trace` around one forward of `model` on `x` (annotated
    'wavemamba_forward') into `trace_dir` (emptied first); a session that
    recorded none of K1's kernels (CUPTI may drop a session's records) is
    taken again, up to PROFILE_SESSIONS times. Returns
    (the trace's files, its events, K1's launches as the wrapper counted them
    over every session, sessions)."""
    import shutil

    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.ops import scan_cuda
    from wavemamba_torch.utils import profiler

    wavemamba_apply(model, x)
    traced = 0
    for sessions in range(1, PROFILE_SESSIONS + 1):  # a session may record no device event
        shutil.rmtree(trace_dir, ignore_errors=True)
        before = scan_cuda.ss2d_scan_pair.launches
        with profiler.trace(trace_dir):
            with profiler.annotate("wavemamba_forward"):
                wavemamba_apply(model, x)
        traced += scan_cuda.ss2d_scan_pair.launches - before
        files = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        if any(e.get("cat") == "kernel" and "chunk_scan" in e.get("name", "") for e in events):
            break
    return files, events, traced, sessions


def phase_secondary(stock, smi):
    """The secondary pieces on the card, each against the CPU on the same
    inputs and weights: the VGG19 perceptual and style losses at batch 8 of
    512x512 (`models/vgg.py`, every tap to conv5_4), LPIPS at 1080x1920
    (`metrics/lpips.py`), the R1 and WGAN-GP penalties and the penalty's own
    gradient on a small conv discriminator (`losses/losses.py`); then
    `utils/profiler.trace` around one WaveMamba forward, whose trace must
    name K1's kernels. Returns the row with `k1_launches` (the traced
    forward's)."""
    import copy
    import re

    from wavemamba_torch.losses import gradient_penalty_loss, r1_penalty
    from wavemamba_torch.metrics.lpips import LPIPS, lpips
    from wavemamba_torch.models.vgg import VGG19, perceptual_loss

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # VGG19 perceptual + style, batch 8 of 512x512
    vgg = _he_conv_weights(VGG19(), 121).eval()
    layers = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1.0, "conv4_4": 1.0, "conv5_4": 1.0}
    rs = np.random.RandomState(122)
    pred, target = (rs.rand(TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3).astype(np.float32)
                    for _ in range(2))
    vgg_cuda = VGG19().cuda().eval()
    vgg_cuda.load_state_dict(vgg.state_dict())
    pc, tc = torch.from_numpy(pred).cuda(), torch.from_numpy(target).cuda()

    def vgg_loss():
        p, s = perceptual_loss(vgg_cuda, pc, tc, layers, style_weight=1.0)
        return p, s

    with torch.no_grad():
        got = vgg_loss()
        vgg_ms = cuda_ms(vgg_loss, 3)
        t_cpu = time.perf_counter()
        want = perceptual_loss(vgg, torch.from_numpy(pred), torch.from_numpy(target), layers,
                               style_weight=1.0)
        vgg_cpu_s = time.perf_counter() - t_cpu
    vgg_row = {"batch": TRAIN_BATCH, "size": TRAIN_SIZE, "layers": layers, "ms": vgg_ms,
               "cpu_s": vgg_cpu_s, "perceptual": [float(got[0]), float(want[0])],
               "style": [float(got[1]), float(want[1])],
               "rel_err": [abs(float(g) / float(w) - 1.0) for g, w in zip(got, want)],
               "rtol": VGG_LOSS_RTOL}
    del vgg_cuda, pc, tc
    torch.cuda.empty_cache()
    # LPIPS at 1080x1920
    net = _he_conv_weights(LPIPS(), 123).eval()
    with torch.no_grad():
        for lin in net.lins:
            lin.copy_(torch.from_numpy(np.abs(rs.randn(lin.numel())).astype(np.float32) * 0.1))
    net_cuda = LPIPS().cuda().eval()
    net_cuda.load_state_dict(net.state_dict())
    a = (rs.rand(1, 1080, 1920, 3) * 2 - 1).astype(np.float32)
    b = np.clip(a + rs.randn(*a.shape).astype(np.float32) * 0.1, -1, 1)
    ac, bc = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    with torch.no_grad():
        lp = float(lpips(net_cuda, ac, bc)[0])
        lp_ms = cuda_ms(lambda: lpips(net_cuda, ac, bc), 5)
        lp_cpu = float(lpips(net, torch.from_numpy(a), torch.from_numpy(b))[0])
    lpips_row = {"image": [1080, 1920], "value": [lp, lp_cpu], "abs_err": abs(lp - lp_cpu),
                 "ms": lp_ms, "atol": LPIPS_ATOL}
    del net_cuda, ac, bc
    # R1 and WGAN-GP on a small discriminator, batch 8 of 128x128
    disc = _small_disc()
    disc_cuda = copy.deepcopy(disc).cuda()
    wrap = lambda m: (lambda x: m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))  # noqa: E731 NHWC
    real = rs.rand(TRAIN_BATCH, 128, 128, 3).astype(np.float32)
    fake = rs.rand(TRAIN_BATCH, 128, 128, 3).astype(np.float32)
    gan = {}
    for name, d, dev in (("cuda", disc_cuda, "cuda"), ("cpu", disc, "cpu")):
        r, f = torch.from_numpy(real).to(dev), torch.from_numpy(fake).to(dev)
        r1 = r1_penalty(wrap(d), r)
        gp = gradient_penalty_loss(wrap(d), r, f, torch.Generator().manual_seed(124))
        g_w = torch.autograd.grad(r1 + gp, d[0].weight)[0]  # the penalties train the discriminator
        gan[name] = (r1.detach(), gp.detach(), g_w)
    gan_row = {"batch": TRAIN_BATCH, "size": 128,
               "r1": [float(gan["cuda"][0]), float(gan["cpu"][0])],
               "gp": [float(gan["cuda"][1]), float(gan["cpu"][1])],
               "rel_err": {k: _rel(gan["cuda"][i], gan["cpu"][i])
                           for i, k in enumerate(("r1", "gp", "grad_first_conv"))},
               "rtol": GAN_RTOL}
    # utils/profiler.trace around one forward: K1's kernels by name in the trace
    trace_dir = os.path.join(ROOT, "build", "chip_smoke", "trace")
    x = torch.from_numpy((rs.rand(1, 512, 512, 3) * 0.12).astype(np.float32)).cuda()
    files, events, traced, sessions = trace_forward(stock, x, trace_dir)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1_names = sorted({m.group(0) for m in map(re.compile(r"chunk_(scan|prefix)(<[^>]*>)?")
                                               .search, kernels) if m})
    trace_row = {"files": files, "kernels": len(kernels), "k1_kernel_names": k1_names,
                 "k1_kernels_in_trace": sum("chunk_scan" in n or "chunk_prefix" in n
                                            for n in kernels),
                 "k1_launches": traced, "sessions": sessions,
                 "annotated": any(e.get("name") == "wavemamba_forward" for e in events)}
    row = {"phase": "secondary", "smi": smi, "vgg19": vgg_row, "lpips": lpips_row,
           "gan": gan_row, "profiler": trace_row, "k1_launches": traced,
           "phase_s": time.perf_counter() - t0}
    emit(row)
    check(max(vgg_row["rel_err"]) <= VGG_LOSS_RTOL, f"VGG19 losses, card vs CPU: {vgg_row}")
    check(lpips_row["abs_err"] <= LPIPS_ATOL, f"LPIPS, card vs CPU: {lpips_row}")
    check(max(gan_row["rel_err"].values()) <= GAN_RTOL, f"GAN penalties, card vs CPU: {gan_row}")
    check(trace_row["annotated"] and k1_names and trace_row["k1_kernels_in_trace"] > 0,
          f"the profiler's trace names K1's kernels: {trace_row}")
    return row


DEPLOY_DIR = os.path.join(ROOT, "build", "chip_smoke", "deploy")
DEPLOY_ATOL = 1e-5  # the artifact against the eager forward on the same request, float32
DEPLOY_BUCKET = (1152, 1920)
# The artifacts of the deploy phase, as `export_model export` builds them on
# a host with no card: name -> the CLI's flags beyond -w / -o.
DEPLOY_EXPORTS = {
    "xxl4": ["--shapes", "1152x1920", "--target", "cuda", "--allow_custom_calls", "--tile", "240"],
    "fast_u8": ["--shapes", "1152x1920", "--fast", "--target", "cuda", "--allow_custom_calls",
                "--io", "uint8"],
    # the tile program sharded over two ranks (each runs batch 4 of every 8)
    "xxl4_mesh2": ["--shapes", "1152x1920", "--target", "cuda", "--allow_custom_calls", "--tile",
                   "240", "--mesh_devices", "2"],
}
# The sharded tile program's 2160x3840 frame against the one-process
# artifact's tiles: max abs (each rank's batch of 4 takes other cuDNN
# algorithms than a batch of 8, in float32 parity). A planted fault, the two
# shares gathered in swapped order, must land far beyond it.
DEPLOY_MESH_ATOL = 1e-6


# The artifacts that keep kernels beside K1 as ops, which the export CLI has
# no flag for (nor has the JAX package's, for conv_impl): name -> its io
# dtype. `export_child` makes each through `deploy.export_model` with
# allow_custom_calls, one DEPLOY_BUCKET program and no tile program.
DEPLOY_OP_EXPORTS = {
    "fused_fast_u8": "uint8",  # WaveMambaConfig.fast(conv_impl="fused"): K1 and the chain op (K7)
    "k3": "float32",  # WaveMambaConfig(scan_impl="pallas"): K3's op
}
# K1, K3 and K7 in the replay of each against the eager forward: counted by
# the wrappers at the capture and by kernel name in a profiled replay.
DEPLOY_OP_KERNELS = {"fused_fast_u8": {"K1": 28, "K3": 0, "K6": 0, "K7": 76},
                     "k3": {"K1": 0, "K3": 14, "K6": 0, "K7": 0}}


def deploy_op_named(name):
    """DEPLOY_OP_KERNELS[name] as `named_launches` counts them (K6 and K7
    are one kernel by name)."""
    want = DEPLOY_OP_KERNELS[name]
    return {"K1": want["K1"], "K3": want["K3"], "chain": want["K6"] + want["K7"]}


def deploy_op_config(name):
    from wavemamba_torch.models.wavemamba import WaveMambaConfig

    return (WaveMambaConfig.fast(conv_impl="fused") if name == "fused_fast_u8"
            else WaveMambaConfig(scan_impl="pallas"))


def export_child(name):
    """Export DEPLOY_OP_EXPORTS[name] from CKPT (see there), on the host."""
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.deploy import export_model

    t0 = time.perf_counter()
    manifest = export_model(load_network(CKPT, device="cpu"), deploy_op_config(name),
                            [DEPLOY_BUCKET], export_path(name), allow_custom_calls=True,
                            io_dtype=DEPLOY_OP_EXPORTS[name])
    print(f"wrote {export_path(name)}: platforms {manifest['platforms']}, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def export_cmds():
    """{name: argv} of `python -m wavemamba_torch.scripts.export_model
    export` for each of DEPLOY_EXPORTS, and of `export_child` for each of
    DEPLOY_OP_EXPORTS, from CKPT into DEPLOY_DIR (emptied here), for
    `start_children` with EXPORT_ENV: children that see no card (a build
    host), started together, which trace on the host while the phases before
    `deploy` run."""
    import shutil

    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    os.makedirs(DEPLOY_DIR)
    cli = {name: [sys.executable, "-m", "wavemamba_torch.scripts.export_model", "export", "-w",
                  CKPT, "-o", export_path(name), *flags]
           for name, flags in DEPLOY_EXPORTS.items()}
    return {**cli, **{name: child_cmd("export_child", name) for name in DEPLOY_OP_EXPORTS}}


EXPORT_ENV = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


def export_path(name):
    return os.path.join(DEPLOY_DIR, f"{name}.wmt")


def check_deploy(row):
    """Hold the deploy phase's readings to its contract; raise on any miss."""
    for req in row["requests"]:
        check(req["max_abs_vs_eager"] <= DEPLOY_ATOL,
              f"{req['image']}: artifact vs eager {req['max_abs_vs_eager']} > {DEPLOY_ATOL}")
        check(req["k1_in_graph"] == 28, f"{req['image']}: {req['k1_in_graph']} K1 in the graph")
    check(row["same_bits_twice"], "the graph's replay gives the same bits twice")
    check(row["pipelined_matches"], "two dispatches before one fetch give the calls' results")
    check(row["tiled"]["max_abs_vs_eager_tiled"] <= DEPLOY_ATOL,
          f"tiled artifact vs eager tiles {row['tiled']['max_abs_vs_eager_tiled']}")
    check(row["fast_u8"]["psnr_vs_float32_db"] >= FAST_VS_F32_PSNR,
          f"fast uint8 artifact {row['fast_u8']['psnr_vs_float32_db']} dB < {FAST_VS_F32_PSNR}")
    check(row["fast_u8"]["k1_in_graph"] == 28, "28 K1 in the fast uint8 graph")
    cache = row["compile_cache"]
    check(cache["cold_built_k1"] and not cache["warm_built"],
          f"the first process builds K1 into the cache, the second builds nothing: {cache}")
    mesh = row["mesh_tiles"]
    for r in mesh["ranks"]:
        check(r["max_abs_vs_one_process"] <= DEPLOY_MESH_ATOL,
              f"the sharded tile program against the one-process artifact: {r}")
        check(r["fault_max_abs_vs_one_process"] > 100 * DEPLOY_MESH_ATOL,
              f"the planted fault (the shares gathered in swapped order) is caught: {r}")
        check(r["k1_in_graph"] == 28 and r["replays"] == mesh["tile_batches"],
              f"K1 in every tile batch of the rank: {r}")
    check(mesh["ranks_same_bits"], "the two ranks return the same frame, bit for bit")


def first_request_s(text):
    """The seconds `export_model run` prints for its first frame."""
    import re

    return float(re.search(r"^\S+\.png: ([\d.]+)s$", text, re.M).group(1))


def serve_subprocess(artifact, folder, cache):
    """`export_model run` of `folder` from `artifact` with `--compile_cache
    cache`, a fresh process: (first frame's seconds, process seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "wavemamba_torch.scripts.export_model", "run",
                           "-a", artifact, "-i", folder, "-o", os.path.join(DEPLOY_DIR, "served"),
                           "--compile_cache", cache], cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": ROOT}, timeout=600)
    check(proc.returncode == 0, f"export_model run exited {proc.returncode}: {proc.stderr[-2000:]}")
    return first_request_s(proc.stdout), time.perf_counter() - t0


def named_launches(rows):
    """K1's, K3's and the chain kernel's launches by kernel name in
    `profile_rows`' rows: one replay kernel a call of K1 / K3
    (`chunk_scan<..., true, ...>`, `selective_chunk<16, true>`), one
    `chain_kernel` a call of K6 or K7."""
    count = lambda *pats: sum(n for _, n, name in rows if all(p in name for p in pats))  # noqa: E731
    return {"K1": count("chunk_scan<", "true"), "K3": count("selective_chunk<", "true"),
            "chain": count("chain_kernel")}


def replay_profile(fn, unprofiled_ms):
    """Busy time, idle share and the kernels' launches by name
    (`named_launches`) of one call of `fn` under torch.profiler
    (`profile_rows`)."""
    wall_ms, rows, _ = profile_rows(fn)
    busy_ms = sum(r[0] for r in rows) / 1e3
    named = named_launches(rows)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "unprofiled_ms": unprofiled_ms, "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
            "k1_launches_profiled": named["K1"], "launches_profiled": named,
            "kernels": sum(r[1] for r in rows)}


def deploy_ops(art, fast_fused, img, f32_ref):
    """The DEPLOY_OP_EXPORTS artifacts, each one CUDA graph for DEPLOY_BUCKET,
    on the request `img` (reflect-padded), held against the eager forward
    on the same padded input: `fused_fast_u8` on `img`'s bytes against
    `fast_fused` (`fast(conv_impl="fused")`) quantized the same way, within
    one level on every pixel, and against `f32_ref` (the float32 artifact's
    bytes) in dB; `k3` against the eager `scan_impl='pallas'` forward within
    DEPLOY_ATOL. For each: the kernels' counts in the graph (the wrappers at
    the capture) against the eager forward's, and by kernel name in a
    profiled replay and a profiled eager forward; replay and eager ms (CUDA
    events, median of 7), each one's idle share, and the load s. The
    wrappers' counts are set to 0 just before each artifact's first call and
    read just after (its warm-up and its capture). Returns {name: row,
    "launches": each kernel's launches on the artifact route}."""
    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.deploy import _COUNTERS, _reflect_pad
    from wavemamba_torch.models import build_network
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    counts = lambda: {k: f.launches for k, f in _COUNTERS.items()}  # noqa: E731
    h, w = img.shape[1:3]
    u8 = np.round(img * 255.0).astype(np.uint8)
    unfused = build_network({"type": "WaveMamba", "scan_impl": "pallas"},
                            load_network(CKPT, device="cuda"), device="cuda")
    out = {"launches": dict.fromkeys(_COUNTERS, 0)}
    for name, request, eager in (("fused_fast_u8", u8, fast_fused), ("k3", img, unfused)):
        model = art[name]["model"]
        run = model.runners[DEPLOY_BUCKET]
        for f in _COUNTERS.values():
            f.launches = 0  # the main path's count starts here
        got = model(request)
        wrapper = counts()  # read just after the main path
        again = model(request)
        x = torch.from_numpy(_reflect_pad(request, *DEPLOY_BUCKET)).cuda()
        x = x.float() / 255.0 if name == "fused_fast_u8" else x
        for f in _COUNTERS.values():
            f.launches = 0
        y = wavemamba_apply(eager, x)
        eager_counts = counts()
        replay_ms = cuda_ms(run.graph.replay, 7)
        eager_ms = cuda_ms(lambda: wavemamba_apply(eager, x), 7)
        profiles = {"replay": replay_profile(run.graph.replay, replay_ms),
                    "eager": replay_profile(lambda: wavemamba_apply(eager, x), eager_ms)}
        for prof in profiles.values():
            prof["short_profile"] = prof["launches_profiled"] != deploy_op_named(name)
        row = {"image": [h, w], "bucket": list(DEPLOY_BUCKET), "io_dtype": DEPLOY_OP_EXPORTS[name],
               "config": {k: model.manifest["config"][k]
                          for k in ("scan_impl", "conv_impl", "compute_dtype", "scan_dtype")},
               "platforms": model.manifest["platforms"], "load_s": art[name]["load_s"],
               "in_graph": run.in_graph, "eager_counts": eager_counts,
               "wrapper_counts_main_path": wrapper, "want_in_graph": DEPLOY_OP_KERNELS[name],
               "same_bits_again": bool(np.array_equal(got, again)),
               "forward_ms": {"replay": replay_ms, "eager": eager_ms}, "profile": profiles}
        if name == "fused_fast_u8":
            want = torch.round(y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)[:, :h, :w].cpu().numpy()
            diff = np.abs(got.astype(int) - want.astype(int))
            row.update(max_abs_levels_vs_eager=int(diff.max()),
                       share_differing_vs_eager=float((diff > 0).mean()),
                       psnr_vs_float32_db=psnr_db(got / 255.0, f32_ref / 255.0))
        else:
            row["max_abs_vs_eager"] = float(np.abs(got - y[:, :h, :w].cpu().numpy()).max())
        for k in _COUNTERS:
            out["launches"][k] += run.in_graph[k] * (1 + run.replays)
        row["replays"] = run.replays
        out[name] = row
    return out


def check_deploy_ops(ops):
    """Hold `deploy_ops`' readings to their contract; raise on any miss."""
    for name, want in DEPLOY_OP_KERNELS.items():
        row = ops[name]
        check(row["platforms"] == ["cuda"], f"{name}: platforms {row['platforms']}")
        check(row["in_graph"] == want and row["eager_counts"] == want,
              f"{name}: kernels in the graph {row['in_graph']}, in the eager forward "
              f"{row['eager_counts']}, want {want}")
        check(all(row["wrapper_counts_main_path"][k] == 2 * n for k, n in want.items()),
              f"{name}: the wrappers counted {row['wrapper_counts_main_path']} over the warm-up "
              f"and the capture, want twice {want}")
        # By name: each kernel of the graph is there and no other; a profiler
        # session late in the script may drop a few records (it kept 73 of 76
        # chain kernels, 27 of 28 K1 and 13 of 14 K3 on the card), so fewer
        # than the count is flagged (`short_profile`), not failed, as
        # `profiled_launches` does.
        named = deploy_op_named(name)
        for run in ("replay", "eager"):
            got = row["profile"][run]["launches_profiled"]
            check(all((got[k] > 0) == (n > 0) and got[k] <= n for k, n in named.items()),
                  f"{name}: {run} kernels by name {got}, want {named}")
        check(row["same_bits_again"], f"{name}: the replay gives the same bits twice")
    fused = ops["fused_fast_u8"]
    check(fused["max_abs_levels_vs_eager"] <= 1,
          f"fused_fast_u8 against the eager fused fast bytes: {fused['max_abs_levels_vs_eager']}")
    check(fused["psnr_vs_float32_db"] >= FAST_VS_F32_PSNR,
          f"fused_fast_u8 {fused['psnr_vs_float32_db']} dB from float32 < {FAST_VS_F32_PSNR}")
    check(ops["k3"]["max_abs_vs_eager"] <= DEPLOY_ATOL,
          f"k3 artifact against the eager forward: {ops['k3']['max_abs_vs_eager']}")


def phase_deploy(jobs, stock, fast, fast_fused=None):
    """The deployment route: the artifacts of `export_cmds`, traced on the
    host (the XXL4 checkpoint with K1's op for the 1152x1920 bucket and a
    240 / 16 tile program; the `fast` preset with uint8 I/O) loaded on the
    card, each program one CUDA graph. Two seeded requests (1080x1920,
    720x1280) and a 2160x3840 one through `tiled`, held against the eager
    forward (`stock`) on the same padded input; the replay against the eager
    forward in ms and idle share; K1 in each graph; the fast uint8 artifact
    against the float32 one; the artifacts that keep the chain op and K3's
    op (`deploy_ops`, against the eager `fast_fused` and 'pallas' forwards);
    and `export_model run` twice on a fresh `--compile_cache` (a cold K1
    build, then none). Returns the row, with `k1_launches`: K1's launches on
    the path (the warm-ups' and each replay's 28; a replay does not pass
    through the wrapper's count), and `k3_launches` / `k7_launches` those of
    the op artifacts' graphs."""
    from wavemamba_torch.deploy import SUFFIX, _reflect_pad, load_exported
    from wavemamba_torch.inference import enhance
    from wavemamba_torch.models.wavemamba import wavemamba_apply
    from wavemamba_torch.ops import scan_cuda

    t_phase = time.perf_counter()
    art = {}
    for name, (_, text) in wait_children(jobs).items():
        path = export_path(name)
        check(os.path.exists(path), f"export {name} wrote no artifact: {text[-2000:]}")
        line = next(ln for ln in text.splitlines() if ln.startswith("wrote "))
        if name == "xxl4_mesh2":  # served by two ranks at the end of the phase
            continue
        t0 = time.perf_counter()
        model = load_exported(path)
        art[name] = {"model": model, "load_s": time.perf_counter() - t0,
                     "bytes": os.path.getsize(path), "cli": line,
                     **{k: model.manifest["build"][k] for k in ("trace_s", "save_s")}}
    em, fm = art["xxl4"]["model"], art["fast_u8"]["model"]
    check(em.manifest["platforms"] == ["cuda"]
          and em.manifest["config"]["scan_impl"] == "pallas_fused",
          f"the card artifact keeps K1's op: {em.manifest['platforms']}, {em.manifest['config']}")
    rs = np.random.RandomState(17)
    images = [(rs.rand(1, h, w, 3) * 0.12).astype(np.float32)
              for h, w in [(1080, 1920), (720, 1280)]]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()

    scan_cuda.ss2d_scan_pair.launches = 0  # the main path's count starts here
    run = em.runners[DEPLOY_BUCKET]
    served = []
    for i, img in enumerate(images * 2):  # each request twice: the first call captures
        t0 = time.perf_counter()
        out = em(img)
        served.append((img, out, time.perf_counter() - t0))
        if i == 0:
            reserved = {"bucket": torch.cuda.memory_reserved() - reserved0}
    wrapper = scan_cuda.ss2d_scan_pair.launches  # read just after the main path
    peak = torch.cuda.max_memory_allocated()
    main_launches = run.in_graph["K1"] * (1 + run.replays)
    check(wrapper == 2 * run.in_graph["K1"] and main_launches > 0,
          f"K1 on the main path: the wrapper counted {wrapper} (the warm-up's and the "
          f"capture's {run.in_graph['K1']} each), {run.replays} replays")
    requests = []
    for img, out, s in served[:2]:
        h, w = img.shape[1:3]
        x = torch.from_numpy(_reflect_pad(img, *DEPLOY_BUCKET)).cuda()
        want = wavemamba_apply(stock, x)[:, :h, :w].cpu().numpy()
        again = next(o for im, o, _ in served[2:] if im is img)
        requests.append({"image": [h, w], "bucket": list(DEPLOY_BUCKET), "latency_s": s,
                         "latency_again_s": next(t for im, _, t in served[2:] if im is img),
                         "max_abs_vs_eager": float(np.abs(out - want).max()),
                         "bit_equal_eager": bool(np.array_equal(out, want)),
                         "same_bits_again": bool(np.array_equal(out, again)),
                         "k1_in_graph": run.in_graph["K1"]})
    first = served[0][1]
    handles = [em.dispatch(images[0]), em.dispatch(images[1])]  # two in flight, then fetch
    pipelined = [h.fetch() for h in handles]
    pipelined_matches = bool(np.array_equal(pipelined[0], first)
                             and np.array_equal(pipelined[1], served[1][1]))

    # Replay against eager, device time by CUDA events, and each one's idle share.
    x = torch.from_numpy(_reflect_pad(images[0], *DEPLOY_BUCKET)).cuda()
    replay_ms = cuda_ms(run.graph.replay, 7)
    eager_ms = cuda_ms(lambda: wavemamba_apply(stock, x), 7)
    profiles = {"replay": replay_profile(run.graph.replay, replay_ms),
                "eager": replay_profile(lambda: wavemamba_apply(stock, x), eager_ms)}

    # The tile program: 2160x3840 through `tiled` (its first call captures).
    big = (np.random.RandomState(18).rand(1, 2160, 3840, 3) * 0.12).astype(np.float32)
    t0 = time.perf_counter()
    tiled = em.tiled(big)
    tiled_first_s = time.perf_counter() - t0
    reserved["tile"] = torch.cuda.memory_reserved() - reserved0
    t0 = time.perf_counter()
    tiled_again = em.tiled(big)
    tiled_s = time.perf_counter() - t0
    eager_tiled = enhance(stock, big, None, tile=240)
    tile_run = em.runners["tile"]

    # fast uint8: bytes in and out, against the float32 artifact's output.
    u8_in = np.round(images[0] * 255.0).astype(np.uint8)
    u8_out = fm(u8_in)
    reserved["fast_u8"] = torch.cuda.memory_reserved() - reserved0
    f32_ref = np.round(np.clip(em(u8_in.astype(np.float32) / 255.0), 0.0, 1.0) * 255.0)
    fast_run = fm.runners[DEPLOY_BUCKET]
    xb = torch.from_numpy(_reflect_pad(images[0], *DEPLOY_BUCKET)).cuda()
    fast_replay_ms = cuda_ms(fast_run.graph.replay, 7)
    fast_eager_ms = cuda_ms(lambda: wavemamba_apply(fast, xb), 7) if fast is not None else None
    torch.cuda.empty_cache()
    ops = deploy_ops(art, fast_fused, images[0], f32_ref)
    emit({"phase": "deploy_ops", **ops})
    check_deploy_ops(ops)
    # K1 on the artifact route: each graph's warm-up call and its replays
    # (the capture records K1 into the graph and launches nothing).
    runners = [r for m in (em, fm) for r in m.runners.values() if r.graph is not None]
    launches = sum(r.in_graph["K1"] * (1 + r.replays) for r in runners) + ops["launches"]["K1"]

    # --compile_cache: one request in a fresh process, twice on one fresh
    # directory, in a thread that waits on them while the sharded tile
    # program's ranks run (the script's time limit: both are child processes
    # that mostly load; their first-request seconds are read beside the ranks).
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    folder, cache = os.path.join(DEPLOY_DIR, "request"), os.path.join(DEPLOY_DIR, "kernels")
    os.makedirs(folder)
    cv2.imwrite(os.path.join(folder, "a.png"), u8_in[0][..., ::-1])
    torch.cuda.empty_cache()  # room for the child processes

    def cold_then_warm():
        cold = serve_subprocess(export_path("fast_u8"), folder, cache)
        libs = sorted(os.listdir(cache))
        return cold, libs, serve_subprocess(export_path("fast_u8"), folder, cache)

    with ThreadPoolExecutor(1) as pool:
        served_cache = pool.submit(cold_then_warm)
        mesh = deploy_mesh(tiled)
        (cold_s, cold_proc_s), libs, (warm_s, warm_proc_s) = served_cache.result()
    launches += mesh["k1_launches"]
    row = {"phase": "deploy", "suffix": SUFFIX,
           "artifacts": {k: {kk: vv for kk, vv in v.items() if kk != "model"} for k, v in art.items()},
           "requests": requests, "same_bits_twice": all(r["same_bits_again"] for r in requests),
           "pipelined_matches": pipelined_matches, "k1_launches": launches,
           "k3_launches": ops["launches"]["K3"], "k6_launches": ops["launches"]["K6"],
           "k7_launches": ops["launches"]["K7"],
           "ops": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                   for k, v in ops.items() if k != "launches"},
           "k1_launches_main_path": main_launches, "k1_wrapper_count_main_path": wrapper,
           "replays": {"bucket": run.replays, "tile": tile_run.replays, "fast_u8": fast_run.replays},
           "peak_memory_bytes_main_path": peak,
           # memory the allocator holds above the phase's start after each graph's
           # first call (its warm-up's blocks and its private pool)
           "reserved_bytes_after_capture": reserved,
           "forward_ms": {"replay": replay_ms, "eager": eager_ms, "fast_u8_replay": fast_replay_ms,
                          "fast_eager": fast_eager_ms},
           "profile": profiles,
           "tiled": {"image": [2160, 3840], "first_s": tiled_first_s, "s": tiled_s,
                     "forwards": tile_run.replays // 2,
                     "same_bits_again": bool(np.array_equal(tiled, tiled_again)),
                     "max_abs_vs_eager_tiled": float(np.abs(tiled - eager_tiled).max()),
                     "finite": bool(np.isfinite(tiled).all())},
           "fast_u8": {"psnr_vs_float32_db": psnr_db(u8_out / 255.0, f32_ref / 255.0),
                       "max_abs_levels": int(np.abs(u8_out.astype(int) - f32_ref.astype(int)).max()),
                       "k1_in_graph": fast_run.in_graph["K1"], "tol_psnr_db": FAST_VS_F32_PSNR},
           "compile_cache": {"beside": "the sharded tile program's two ranks",
                             "first_request_cold_s": cold_s, "first_request_warm_s": warm_s,
                             "process_cold_s": cold_proc_s, "process_warm_s": warm_proc_s,
                             "cold_built_k1": any(n.startswith("ss2d_scan_") and n.endswith(".so")
                                                  for n in libs),
                             "warm_built": sorted(os.listdir(cache)) != libs, "libraries": libs},
           "mesh_tiles": mesh, "phase_s": time.perf_counter() - t_phase}
    emit(row)
    check_deploy(row)
    return row


def deploy_mesh_child(init, rank, want_path, out):
    """Rank `rank` of two over gloo, both on cuda:0: the `xxl4_mesh2`
    artifact's sharded tile program serves `want_path`'s frame (its batch-4
    share of every tile batch of 8 through its own CUDA graph, the shares
    gathered in rank order), then again with the shares gathered in
    swapped order (a planted fault). Writes a pickle of the readings."""
    import hashlib
    import pickle

    from wavemamba_torch import parallel
    from wavemamba_torch.deploy import load_exported
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.parallel import mesh as pmesh

    set_parity_mode()
    device = parallel.initialize(init, 2, int(rank), backend="gloo", device="cuda:0")
    t0 = time.perf_counter()
    model = load_exported(export_path("xxl4_mesh2"), device=device)
    load_s = time.perf_counter() - t0
    want = np.load(want_path)
    big = (np.random.RandomState(18).rand(1, 2160, 3840, 3) * 0.12).astype(np.float32)
    t0 = time.perf_counter()
    got = model.tiled(big)
    first_s = time.perf_counter() - t0
    run = model.runners["tile"]
    replays = run.replays
    t0 = time.perf_counter()
    again = model.tiled(big)
    again_s = time.perf_counter() - t0
    gather = pmesh.gather_rows
    pmesh.gather_rows = lambda mesh, t, axis="data": gather(mesh, t, axis).flip(0)
    try:
        fault = model.tiled(big)
    finally:
        pmesh.gather_rows = gather
    row = {"rank": int(rank), "device": str(device), "load_s": load_s, "first_s": first_s,
           "s": again_s, "replays": replays, "k1_in_graph": run.in_graph["K1"],
           "k1_launches": run.in_graph["K1"] * (1 + replays),  # the warm-up and the first frame's
           "tile_rank_batch": model.manifest["tile_rank_batch"],
           "max_abs_vs_one_process": float(np.abs(got - want).max()),
           "bit_equal_one_process": bool(np.array_equal(got, want)),
           "same_bits_again": bool(np.array_equal(got, again)),
           "fault_max_abs_vs_one_process": float(np.abs(fault - want).max()),
           "sha256": hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest(),
           "finite": bool(np.isfinite(got).all())}
    with open(out, "wb") as f:
        pickle.dump(row, f)
    parallel.barrier()
    parallel.dist.shutdown()


def deploy_mesh(want):
    """The `xxl4_mesh2` artifact (the 240 / 16 tile program sharded over two
    ranks) served by two gloo ranks sharing cuda:0 (`deploy_mesh_child`) on
    the deploy phase's 2160x3840 frame, held against `want`, the
    one-process artifact's tiles of it. Returns the readings, with
    `k1_launches`: both ranks' warm-ups and replays, 28 each."""
    import pickle

    from wavemamba_torch.parallel.dist import local_init_method

    t0 = time.perf_counter()
    mesh_dir = os.path.join(DEPLOY_DIR, "mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    want_path = os.path.join(mesh_dir, "want.npy")
    np.save(want_path, want)
    torch.cuda.empty_cache()  # room for the ranks' graphs
    init = local_init_method()
    outs = [os.path.join(mesh_dir, f"rank{r}.pkl") for r in range(2)]
    children = run_children({f"mesh_rank{r}": child_cmd("deploy_mesh_child", init, r, want_path,
                                                        outs[r]) for r in range(2)}, mesh_dir)
    ranks = []
    for out in outs:
        with open(out, "rb") as f:
            ranks.append(pickle.load(f))
    tiles = -(-2160 // 240) * -(-3840 // 240)
    return {"image": [2160, 3840], "tile": 240, "tile_batch": 8, "mesh_devices": 2,
            "tile_batches": -(-tiles // 8), "ranks": ranks,
            "ranks_same_bits": ranks[0]["sha256"] == ranks[1]["sha256"],
            "k1_launches": sum(r["k1_launches"] for r in ranks), "atol": DEPLOY_MESH_ATOL,
            "children_s": {k: v[0] for k, v in children.items()},
            "s": time.perf_counter() - t0}


def phase_probe():
    """P1-P5 (`wavemamba_torch.scripts.gpu_probe.run_all`): each at the TPU
    probe's K and at `K_COMPUTE`. Its launches: the timed ones (the
    comparison's and the clock windows' are left out). P1's, P3's and P4's
    rows also carry their registers, spills, warps an SM and their hot
    loop's SASS (`gpu_probe.probe_resources`); P1's and P3's rows at
    `K_COMPUTE` the SM clock and power draw under their load."""
    from wavemamba_torch.scripts import gpu_probe

    rows = gpu_probe.run_all()
    resources = {name: gpu_probe.probe_resources(name) for name in gpu_probe.RESOURCE_KERNELS}
    for name in ("flat", "exp"):
        args = tuple(torch.from_numpy(a).cuda() for a in gpu_probe.probe_inputs(name))
        K = gpu_probe.K_COMPUTE[name]
        row = next(r for r in rows if r["probe"] == name and r["K"] == K)
        row["clocks_sm_mhz"], row["power_draw_w"] = clocks_under_load(
            lambda: gpu_probe.WRAPPERS[name](*args, K=K))
        del args
        torch.cuda.empty_cache()
    for row in rows:
        if row["probe"] in resources:
            row["resources"] = resources[row["probe"]]
        emit({"phase": "probe", **row})
        check(row["launches"] > 0, f"probe {row['probe']} K={row['K']} launched")
    return rows


def phase_bench():
    """`wavemamba_torch.bench`'s measurement in `fast` and `parity` modes."""
    from wavemamba_torch import bench

    rows = {}
    for mode in ("fast", "parity"):
        rows[mode] = bench.run(mode)
        emit({"phase": "bench", **rows[mode]})
    return rows


def profile_rows(fn):
    """Run `fn` under torch.profiler: (wall ms, [(device us, calls, kernel
    name)], {"k1": K1's launches, "k3": K3's} as their wrappers counted them
    while `fn` ran). A session that recorded no device event at all is taken
    again, up to PROFILE_SESSIONS times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wavemamba_torch.ops import scan_cuda

    wrappers = {"k1": scan_cuda.ss2d_scan_pair, "k3": scan_cuda.selective_scan_cuda}
    for _ in range(PROFILE_SESSIONS):
        before = {k: w.launches for k, w in wrappers.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        counted = {k: w.launches - before[k] for k, w in wrappers.items()}
        by_name = {}
        for e in prof.events():
            # Kernels and copies only: the profiler mirrors host annotations
            # (`Optimizer.step#AdamW.step`) onto the device's timeline as spans.
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                    or e.name.startswith("Optimizer."):
                continue
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time_total, n + 1)
        if by_name:
            break
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()), reverse=True)
    return start.elapsed_time(end), rows, counted


def profiled_launches(rows, counted):
    """K1's and K3's launches as the profile recorded them (each call runs
    one replay kernel: `chunk_scan<..., true, ...>`, `selective_chunk<16, true>`)
    beside their wrappers' counts, and whether the profile is short: it
    recorded fewer than the wrappers launched, so its busy time may read low
    and its idle share high. A short profile is flagged, not failed."""
    replays = {"k1": "chunk_scan<", "k3": "selective_chunk<"}
    recorded = {k: sum(n for _, n, name in rows if pat in name and "true" in name)
                for k, pat in replays.items()}
    return {"profiled_launches": recorded, "wrapper_launches": counted,
            "short_profile": any(recorded[k] < counted[k] for k in replays)}


def phase_profile(model, x, forward_ms, runs, pipe, fused, fast, fast_fused, train_fast, train_mixed):
    """Device time by kernel over one 1152x1920 forward of each conv route
    (stock convs, and the fused chains: K7), of `fast()` and of
    `fast(conv_impl="fused")`, one training step of the fused scan route
    (K1 + K2) under each recompute policy (`runs`), of the unfused route (K3 + K4, through the runner), of the
    bf16 yml (`train_fast`) and of the proc512 yml (`train_mixed`), and the
    share of each one's wall time in which the card ran no kernel; beside
    each, K1's and K3's launches as the profile recorded them and as their
    wrappers counted them (`profiled_launches`)."""
    from wavemamba_torch.models.wavemamba import wavemamba_apply

    def report(what, wall_ms, rows, counted, unprofiled_ms, **extra):
        busy_ms = sum(r[0] for r in rows) / 1e3
        named = lambda *keys: sum(r[0] for r in rows if any(k in r[2] for k in keys)) / 1e3
        # K2 and K4 name their kernels alike (each in its own library): a
        # profile holds one route, so the adjoint's time is that route's.
        adjoint = named("bwd_local", "bwd_prefix", "bwd_main", "bwd_reduce")
        k2_ms = 0.0 if what == "train_step_unfused" else adjoint
        row = {"phase": "profile", "what": what, **extra, "wall_ms": wall_ms, "busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms,
              # against the same work's time without the profiler's overhead
              "unprofiled_ms": unprofiled_ms, "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
              "k1_ms": named("chunk_scan", "(anonymous namespace)::chunk_prefix("),
              "k2_ms": k2_ms, "k2_share_of_busy": k2_ms / busy_ms,
              "k3_ms": named("selective_chunk<", "selective_prefix("),
              "k4_ms": adjoint if what == "train_step_unfused" else 0.0,
              "flip_ms": named("flip"),
              # dtype casts and other copies (the bf16 path casts each weight where it is used)
              "copy_ms": named("copy"), "copy_launches": sum(r[1] for r in rows if "copy" in r[2]),
              "chain_ms": named("chain_kernel"), "chain_launches": sum(
                  r[1] for r in rows if "chain_kernel" in r[2]),
              "conv_ms": sum(r[0] for r in rows if "chain_kernel" not in r[2] and (
                  "conv" in r[2].lower() or "xmma" in r[2] or "wgrad" in r[2]
                  or "dgrad" in r[2])) / 1e3,
              "kernels": len(rows), "launches": sum(r[1] for r in rows),
              **profiled_launches(rows, counted),
              "top": [{"us": us, "calls": n, "name": name[:90]} for us, n, name in rows[:20]]}
        emit(row)
        if what == "train_step_unfused":
            check(row["k3_ms"] > 0 and row["k4_ms"] > 0 and row["k1_ms"] == 0,
                  f"the unfused step's profile finds K3 and K4 by name, and no K1: {row['k3_ms']}, "
                  f"{row['k4_ms']}, {row['k1_ms']}")
        return row

    report("forward", *profile_rows(lambda: wavemamba_apply(model, x)), forward_ms,
           image=[1152, 1920])
    report("forward_fused", *profile_rows(lambda: wavemamba_apply(fused["model"], x)),
           fused["forward_ms"], image=[1152, 1920])
    steps = {}
    for policy, what in ((None, "train_step"), ("full", "train_step_full"),
                         ("save_scan", "train_step_save_scan")):
        r = runs[policy]
        steps[what] = report(what, *profile_rows(lambda: r["step"](r["state"], r["lq"], r["gt"])),
                             r["ms_per_step"], batch=TRAIN_BATCH, size=[TRAIN_SIZE, TRAIN_SIZE],
                             remat_policy=policy)
    run = runs["save_scan"]
    batch = {"lq": run["lq"], "gt": run["gt"]}
    report("train_step_unfused", *profile_rows(lambda: pipe["model"].optimize_parameters(batch)),
           pipe["ms_per_step"], batch=run["lq"].shape[0], size=[TRAIN_SIZE, TRAIN_SIZE], remat=False)
    report("forward_fast", *profile_rows(lambda: wavemamba_apply(fast["model"], x)), fast["forward_ms"],
           image=[1152, 1920])
    report("forward_fast_fused", *profile_rows(lambda: wavemamba_apply(fast_fused["model"], x)),
           fast_fused["forward_ms"], image=[1152, 1920])
    fast_step = report("train_step_fast", *profile_rows(lambda: train_fast["model"].optimize_parameters(
        train_fast["batch"])), train_fast["ms_per_step"], batch=TRAIN_BATCH, size=[TRAIN_SIZE, TRAIN_SIZE],
        remat_policy="save_scan")
    mixed_step = report("train_step_mixed", *profile_rows(lambda: train_mixed["model"].optimize_parameters(
        train_mixed["batch"])), train_mixed["ms_per_step"], batch=TRAIN_BATCH, size=[TRAIN_SIZE, TRAIN_SIZE],
        remat_policy="save_scan")
    # K2's device time in each fused training step, beside the step's.
    return {what: {k: r[k] for k in ("k2_ms", "busy_ms", "k2_share_of_busy", "wall_ms", "unprofiled_ms",
                                     "idle_share_unprofiled", "short_profile")}
            for what, r in (*steps.items(), ("train_step_fast", fast_step),
                            ("train_step_mixed", mixed_step))}


def kernel_errors(k1_rows, k1_bf16_rows, k2_rows, k2_bf16_rows):
    """The `kernels` line's errors of K1 and K2: at the top level the float32
    rows' own (the k1 phase's, and K1's y and carries as the k2 phase checks
    them; the k2 phase's), and for each `bf16` sub-dict the worst bf16 reading
    over every shape, which is one bf16 step on values up to ~50."""
    return {"K1": {"max_abs_err": max([r["max_abs_err"] for r in k1_rows]
                                      + [max(r["k1"].values()) for r in k2_rows]),
                   "bf16_max_abs_err": max([r["max_abs_err"] for r in k1_bf16_rows]
                                           + [r["k1"]["y"] for r in k2_bf16_rows])},
            "K2": {"max_abs_err": max(max(r["max_abs_err"].values()) for r in k2_rows),
                   "max_rel_err": max(max(r["max_rel_err"].values()) for r in k2_rows),
                   "bf16_max_abs_err": max(max(r["max_abs_err"].values()) for r in k2_bf16_rows),
                   "bf16_max_rel_err": max(max(r["max_rel_err"].values()) for r in k2_bf16_rows)}}


def main():
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    t_start = time.perf_counter()

    from wavemamba_torch.checkpoint import load_network
    from wavemamba_torch.inference import set_parity_mode
    from wavemamba_torch.models import build_network

    set_parity_mode()
    smi = phase_device()
    # the deploy phase's artifacts, traced on the host while the phases below run
    exports = start_children(export_cmds(), DEPLOY_DIR, env=EXPORT_ENV)
    atexit.register(stop_children, exports)
    k1_rows = phase_k1()
    k1_bf16_rows = phase_k1_bf16()
    k1_mixed_rows = phase_k1_bf16(y_dtype=torch.float32)
    k2_rows = phase_k2()
    k2_bf16_rows = phase_k2_bf16()
    k2_mixed_rows = phase_k2_bf16(dy_dtype=torch.float32)
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
    runs = phase_train()
    run = runs["save_scan"]
    phase_resume(run)
    pipe = phase_pipeline(runs[None]["ms_per_step"])  # both without recompute
    probe_rows = phase_probe()
    from wavemamba_torch.models.wavemamba import WaveMambaConfig

    fast_model = build_network({"type": "WaveMamba", **dataclasses.asdict(WaveMambaConfig.fast())},
                               load_network(CKPT, device="cuda"), device="cuda")
    fast = phase_serve_fast(fast_model, model)
    fast["model"] = fast_model
    fast_fused_model = build_network(
        {"type": "WaveMamba", **dataclasses.asdict(WaveMambaConfig.fast(conv_impl="fused"))},
        load_network(CKPT, device="cuda"), device="cuda")
    fast_fused = phase_serve_fast_fused(fast_fused_model, fast_model, model)
    fast_fused["model"] = fast_fused_model
    phase_grad("fast")
    phase_grad("mixed")
    train_fast = phase_train_yml("train_fast")
    train_mixed = phase_train_yml("train_mixed")
    phase_device_cache()
    data = phase_data()
    scripts = phase_scripts(model, smi)
    par = phase_parallel(model, smi)
    phase_art(smi)
    secondary = phase_secondary(model, smi)
    deploy = phase_deploy(exports, model, fast_model, fast_fused_model)
    k2_steps = phase_profile(model, x1080, forward_ms, runs, pipe, fused, fast, fast_fused, train_fast,
                             train_mixed)
    bench = phase_bench()

    # K1 and K5 at level 1 of the 1080p forward; K2, K3 and K4 at level 1 of
    # the training step. Launches: each path's own, counted from 0 just before
    # it: K1 the serve paths' (float32 and fast) and the training paths'
    # (fused, fast, mixed and the data phase's uhdll yml from the generated
    # set) and the fused fast serve path's, K2 the training paths' (K1 and K2
    # also the parallel phase's child processes, each counted there), K3 and K4 the pipeline path's (steps, validation, the request), K7 the
    # two fused serve paths' (float32 and fast), K1, K3 and K7 also the
    # artifact route's graphs (the deploy phase), P1-P5 the
    # probe path's timed calls.
    level1 = k1_rows[0]
    k2_level1 = k2_rows[0]
    # the train path's launches: its three policies' runs, each counted from 0
    train_k1, train_k2 = (sum(r[k] for r in runs.values()) for k in ("k1_launches", "k2_launches"))
    k3_level1 = next(r for r in k3_rows if r["case"] == "train_level1")
    k4_level1 = next(r for r in k4_rows if r["case"] == "train_level1")
    k5_f32 = [r for r in k5_rows if "x" not in r]
    k5_level1 = k5_f32[0]
    k5_bf16, k5_mixed = (next(r for r in k5_rows if r["case"] == f"level1_{tag}")
                         for tag in ("bf16", "mixed"))
    # K6 / K7: one call of the slowest chain of a 1080p forward, paconv_chain
    # at level 1, float32 at the top and bf16 in `bf16`; the `chain` lines
    # hold every wrapper's. Errors: the worst of each dtype's rows.
    pac, pac_bf16 = (next(r for r in chain_rows if r["chain"] == "paconv_chain" and r["dtype"] == dt)
                     for dt in ("float32", "bfloat16"))
    chain_err = lambda key, dt: max(max(r[k][key] for k in ("main", "odd"))
                                    for r in chain_rows if r["dtype"] == dt)
    chain_bf16 = lambda ms_key: {
        "ms": pac_bf16[ms_key], "plain_ms": pac_bf16["plain_ms"], "bound_ms": pac_bf16["bound_ms"],
        "bound_by": pac_bf16["bound_by"], "stock_ms": pac_bf16["stock_ms"],
        "max_abs_err": chain_err("max_abs_err", "bfloat16"),
        "max_rel_err": chain_err("max_rel_err", "bfloat16"),
        "share_differing": chain_err("share_differing", "bfloat16")}
    k1_bf16, k2_bf16 = k1_bf16_rows[0], k2_bf16_rows[0]
    k1_mixed, k2_mixed = k1_mixed_rows[0], k2_mixed_rows[0]
    errs = kernel_errors(k1_rows, k1_bf16_rows, k2_rows, k2_bf16_rows)
    from wavemamba_torch.scripts.gpu_probe import NAMES as PROBES

    probes = []
    for name, tag in zip(PROBES, ("P1", "P2", "P3", "P4", "P5")):
        rows = [r for r in probe_rows if r["probe"] == name]
        first = rows[0]  # at the TPU probe's K
        probes.append({
            "name": f"probe_{name} ({tag})", "route": "cuda", "source": "wavemamba_torch/csrc/gpu_probe.cu",
            "replaces": first["replaces"], "launches": sum(r["launches"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows), "K": first["K"], "ms": first["ms"],
            "gops": first["gops"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            **({"resources": first["resources"]} if "resources" in first else {}),
            "at_compute_K": None if len(rows) == 1 else {
                k: rows[1][k] for k in ("K", "ms", "gops", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "clocks_sm_mhz", "power_draw_w")
                if k in rows[1]}})
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "ss2d_scan_pair (K1)", "route": "cuda", "source": "wavemamba_torch/csrc/ss2d_scan.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:705",
        "launches": launches + train_k1 + fast["launches"] + train_fast["k1_launches"]
        + fast_fused["k1_launches"] + train_mixed["k1_launches"] + data["train"]["k1_launches"]
        + deploy["k1_launches"] + par["k1_launches"] + secondary["k1_launches"]
        + scripts["k1_launches"],
        "launches_serve": launches, "launches_train": train_k1,
        "launches_train_by_policy": {str(p): r["k1_launches"] for p, r in runs.items()},
        "launches_serve_fast": fast["launches"], "launches_train_fast": train_fast["k1_launches"],
        "launches_serve_fast_fused": fast_fused["k1_launches"],
        "launches_train_mixed": train_mixed["k1_launches"],
        "launches_train_data": data["train"]["k1_launches"],
        "launches_deploy": deploy["k1_launches"],
        "launches_parallel": par["k1_launches"],
        "launches_secondary": secondary["k1_launches"],
        "launches_scripts": scripts["k1_launches"],
        "launches_deploy_mesh": deploy["mesh_tiles"]["k1_launches"],
        "launches_parallel_note": "child processes of the parallel phase: the NCCL rank's "
                                  "grouped steps, two gloo ranks' steps and sharded tiles",
        "launches_deploy_note": "the artifact route's CUDA graphs: each graph's warm-up and 28 "
                                "a replay (a replay does not pass through the wrapper's count); "
                                "with the sharded tile program's two ranks (child processes)",
        "launches_secondary_note": "the forward traced by utils/profiler.trace",
        "launches_scripts_note": "the scripts phase's child processes as each script counted them "
                                 "(cross_val_ckpts, tiled_localize, tiled_fidelity, eval_run_ckpts, "
                                 "post_train_eval, conv1x1_sweep, chain_tune) and its traced "
                                 "forward; not its pipelines.train child's",
        "variants": "x and y float32; both bfloat16 on the fast paths; bfloat16 x with float32 y "
                    "on the proc ymls' path (train_mixed)",
        "max_abs_err": errs["K1"]["max_abs_err"],
        "ms": level1["ms"], "plain_ms": level1["plain_ms"], "bound_ms": level1["bound_ms"],
        "bound_by": level1["bound_by"], "library_ms": None,
        **{k: level1["geometry"][k] for k in ("threads", "smem_bytes", "warps_per_sm")},
        "ms_levels": [r["ms"] for r in k1_rows if "ms" in r],
        "phases_ms": [r["phases_ms"] for r in k1_rows if "ms" in r],
        **{k: level1[k] for k in ("clocks_sm_mhz", "power_draw_w")},
        "bf16": {**{k: k1_bf16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                            "share_differing")},
                 "ms_levels": [r["ms"] for r in k1_bf16_rows if "ms" in r],
                 "phases_ms": [r["phases_ms"] for r in k1_bf16_rows if "ms" in r],
                 "max_abs_err_all_shapes": errs["K1"]["bf16_max_abs_err"]},
        "mixed": {**{k: k1_mixed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
                  "ms_levels": [r["ms"] for r in k1_mixed_rows],
                  "phases_ms": [r["phases_ms"] for r in k1_mixed_rows],
                  "max_abs_err_all_shapes": max([r["max_abs_err"] for r in k1_mixed_rows]
                                                + [r["k1"]["y"] for r in k2_mixed_rows])}}, {
        "name": "ss2d_scan_pair_bwd (K2)", "route": "cuda",
        "source": "wavemamba_torch/csrc/ss2d_scan_bwd.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:952",
        "launches": train_k2 + train_fast["k2_launches"] + train_mixed["k2_launches"]
        + data["train"]["k2_launches"] + par["k2_launches"],
        "launches_train": train_k2,
        "launches_train_by_policy": {str(p): r["k2_launches"] for p, r in runs.items()},
        "launches_train_fast": train_fast["k2_launches"],
        "launches_train_mixed": train_mixed["k2_launches"],
        "launches_train_data": data["train"]["k2_launches"],
        "launches_parallel": par["k2_launches"],
        "variants": "x, dy and dx float32; all bfloat16 on the fast training path; bfloat16 x and "
                    "dx with float32 dy on the proc ymls' path (train_mixed)",
        "max_abs_err": errs["K2"]["max_abs_err"], "max_rel_err": errs["K2"]["max_rel_err"],
        "ms": k2_level1["ms"], "plain_ms": k2_level1["plain_ms"],
        "bound_ms": k2_level1["bound_ms"], "bound_by": k2_level1["bound_by"],
        "library_ms": None,
        **{k: k2_level1["geometry"][k] for k in ("threads", "smem_bytes", "warps_per_sm", "gx")},
        "ms_levels": [r["ms"] for r in k2_rows if "ms" in r], "steps": k2_steps,
        "bf16": {**{k: k2_bf16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                            "dx_share_differing")},
                 "ms_levels": [r["ms"] for r in k2_bf16_rows if "ms" in r],
                 "max_abs_err_all_shapes": errs["K2"]["bf16_max_abs_err"],
                 "max_rel_err_all_shapes": errs["K2"]["bf16_max_rel_err"]},
        "mixed": {**{k: k2_mixed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                             "dx_share_differing")},
                  "ms_levels": [r["ms"] for r in k2_mixed_rows],
                  "max_rel_err_all_shapes": max(max(r["max_rel_err"].values()) for r in k2_mixed_rows)}}, {
        "name": "selective_scan_cuda (K3)", "route": "cuda",
        "source": "wavemamba_torch/csrc/selective_scan.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:134",
        "launches": pipe["launches"]["k3"] + deploy["k3_launches"],
        "launches_pipeline": pipe["launches"]["k3"], "launches_deploy": deploy["k3_launches"],
        "launches_deploy_note": "the k3 artifact's CUDA graph (K3's op): its warm-up and 14 a "
                                "replay",
        "max_abs_err": max(max(r["carries_err"].values()) for r in k3_rows),
        "ms": k3_level1["ms"], "plain_ms": k3_level1["plain_ms"],
        "bound_ms": k3_level1["bound_ms"], "bound_by": k3_level1["bound_by"],
        "library_ms": None,
        **{k: k3_level1["geometry"][k] for k in ("threads", "smem_bytes", "warps_per_sm")},
        "ms_levels": [r["ms"] for r in k3_rows if "ms" in r]}, {
        "name": "selective_scan_cuda_bwd (K4)", "route": "cuda",
        "source": "wavemamba_torch/csrc/selective_scan_bwd.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:317", "launches": pipe["launches"]["k4"],
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in k4_rows),
        "max_rel_err": max(max(r["max_rel_err"].values()) for r in k4_rows),
        "ms": k4_level1["ms"], "plain_ms": k4_level1["plain_ms"],
        "bound_ms": k4_level1["bound_ms"], "bound_by": k4_level1["bound_by"],
        "library_ms": None,
        **{k: k4_level1["geometry"][k] for k in ("threads", "smem_bytes", "warps_per_sm", "gx")},
        "ms_levels": [r["ms"] for r in k4_rows if "ms" in r],
        "phases_ms": [r["phases_ms"] for r in k4_rows if "ms" in r],
        **{k: k4_level1[k] for k in ("clocks_sm_mhz", "power_draw_w")}}, {
        "name": "ss2d_scan_pair_ssd (K5)", "route": "cuda",
        "source": "wavemamba_torch/csrc/ss2d_scan_ssd.cu",
        "replaces": "wavemamba_tpu/ops/scan_pallas.py:578", "launches": k5_rows[-1]["launches"],
        "launches_note": "every launch of the k5 phase (comparisons and timing): no configuration "
                         "selects K5, so no model path runs it",
        "variants": "x and y float32; both bfloat16; bfloat16 x with float32 y",
        "max_abs_err": max(max(r["carries_err"].values()) for r in k5_f32),
        "max_abs_err_vs_k1": max(max(r["vs_k1_err"].values()) for r in k5_f32),
        "ms": k5_level1["ms"], "plain_ms": k5_level1["plain_ms"],
        "bound_ms": k5_level1["bound_ms"], "bound_by": k5_level1["bound_by"],
        "library_ms": None,
        **{k: k5_level1["geometry"][k] for k in ("threads", "smem_bytes", "warps_per_sm")},
        "ms_levels": [r["ms"] for r in k5_f32 if "ms" in r],
        "phases_ms": [r["phases_ms"] for r in k5_f32 if "ms" in r],
        **{k: k5_level1[k] for k in ("clocks_sm_mhz", "power_draw_w", "sass_loop")},
        **{tag: {**{k: r[k] for k in ("ms", "f32_ms", "phases_ms", "bound_ms", "bound_by",
                                       "clocks_sm_mhz", "power_draw_w")},
                 "max_abs_err": max(max(r["carries_err"].values()) for r in k5_rows
                                    if r.get("y") == y and "carries_err" in r),
                 **({"share_differing": max(r["share_differing"] for r in k5_rows
                                            if "share_differing" in r)} if tag == "bf16" else {})}
           for tag, y, r in (("bf16", "bfloat16", k5_bf16), ("mixed", "float32", k5_mixed))}}, {
        "name": "fused_chain (K6)", "route": "cuda", "source": "wavemamba_torch/csrc/conv_chain.cu",
        "replaces": "wavemamba_tpu/experimental/conv_fused.py:96",
        "launches": fused["k6_launches"] + deploy["k6_launches"],
        "launches_note": "one 1152x1920 forward of the fused route under chain_route('tile'); "
                         "the artifact route's graphs hold K7, not K6 (launches_deploy)",
        "launches_deploy": deploy["k6_launches"],
        "shape": "paconv_chain " + "x".join(map(str, pac["shape"])),
        "max_abs_err": chain_err("max_abs_err", "float32"),
        "max_rel_err": chain_err("max_rel_err", "float32"),
        "ms": pac["k6_ms"], "plain_ms": pac["plain_ms"], "bound_ms": pac["bound_ms"],
        "bound_by": pac["bound_by"], "library_ms": pac["library_ms"], "stock_ms": pac["stock_ms"],
        "bf16": chain_bf16("k6_ms")}, {
        "name": "fused_chain_band (K7)", "route": "cuda", "source": "wavemamba_torch/csrc/conv_chain.cu",
        "replaces": "wavemamba_tpu/experimental/conv_fused.py:403",
        "launches": fused["launches"] + fast_fused["launches"] + scripts["k7_launches"]
        + deploy["k7_launches"],
        "launches_serve_fused": fused["launches"], "launches_serve_fast_fused": fast_fused["launches"],
        "launches_deploy": deploy["k7_launches"],
        "launches_deploy_note": "the fused_fast_u8 artifact's CUDA graph (the chain op): its "
                                "warm-up and 76 a replay",
        "launches_scripts": scripts["k7_launches"],
        "launches_scripts_note": "chain_tune's band_h sweep and its fast(conv_impl='fused') forwards",
        "shape": "paconv_chain " + "x".join(map(str, pac["shape"])),
        "max_abs_err": chain_err("max_abs_err", "float32"),
        "max_rel_err": chain_err("max_rel_err", "float32"),
        "ms": pac["ms"], "plain_ms": pac["plain_ms"], "bound_ms": pac["bound_ms"],
        "bound_by": pac["bound_by"], "library_ms": pac["library_ms"], "stock_ms": pac["stock_ms"],
        "bf16": chain_bf16("ms")}]
        + probes, "bench": {m: {k: r[k] for k in ("value", "device_ms", "vs_baseline")}
                            for m, r in bench.items()},
        "script_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
