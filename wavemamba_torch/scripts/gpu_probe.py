"""P1-P5 on the card: throughput probes of the SS2D scan's op patterns.

`python -m wavemamba_torch.scripts.gpu_probe` runs the five probes of
`scripts/tpu_vpu_probe.py` as hand-written Hopper kernels
(`wavemamba_torch/csrc/gpu_probe.cu`), at the TPU probes' shapes (blocks g of
(T, N*D2) = (512, 16*128) float32, GRID = 128 of them) and op counts, so the
Gop/s compare: 1 op = one multiply or add, an FMA two. Each probe runs at the
TPU probe's K and at a K that makes it compute-bound on an H100 (`K_COMPUTE`;
P5 has no K). It prints one JSON line per run: Gop/s, ms per call, the
kernel against its plain version (the same bits twice), the bound and what
sets it, the plain version's time and, for P4 and P5, one PyTorch call that
computes the same function; then P1's, P3's and P4's resources (registers,
warps an SM, the hot loop's SASS) and the card's name and power limit. It
needs a card and exits non-zero without one.

Each probe is a function of its inputs here (`probe_flat(x, a, K)` ...), where
the TPU script's builds its inputs and times itself; `probe_inputs` makes the
TPU script's inputs. A CPU tensor takes the plain version (`*_plain`), a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches.

P2 writes (GRID, R, N*D2): the TPU probe reshapes its (R, N, D2) result into
(1, T, N*D2), which fails at trace time, so that probe never ran; its op
count assumes the (R, N*D2) output.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from wavemamba_torch.utils import cxx

SOURCE = cxx.CSRC / "gpu_probe.cu"
T, N, D2 = 512, 16, 128  # chunk tokens, states, packed lanes (2 * D)
S = 8
R = T // S
ND = N * D2
GRID = 128
NAMES = ("flat", "shaped", "exp", "nsum", "mxu_seg")
K_DEFAULT = {"flat": 48, "shaped": 6, "exp": 16, "nsum": 24}  # the TPU probes' defaults
# Where each probe's pipe, not the bytes, bounds it on an H100 by a margin (the
# bound's operations term at least twice its bytes term).
K_COMPUTE = {"flat": 384, "shaped": 192, "exp": 128, "nsum": 192}
# Kernel against plain on the card, max abs difference over the plain output's
# max abs: P1 / P2 take an FMA where the plain version rounds the product, K
# times over; P3 takes exp(y a) as ex2.approx(y (a log2 e)), a few ulp from the
# plain version's exp, which the chain contracts (y a lies in [-0.5, 0]); P4
# sums over n in another order; P5 sums the hi and lo TF32 parts in the tensor
# core's order.
TOL = {"flat": 1e-4, "shaped": 1e-4, "exp": 1e-5, "nsum": 1e-5, "mxu_seg": 1e-5}
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, float32
# operations/s on the FMA pipe (an FMA counted as two), special-function
# results/s (16 per SM per clock, a sixteenth of the FMA pipe's 128 lanes),
# dense TF32 tensor-core operations/s.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
SFU_OPS_S = F32_OPS_S / 16
TF32_OPS_S = 495e12


# ---------------------------------------------------------------- plain versions


def probe_flat_plain(x, a, K=48):
    y = x
    for _ in range(K):
        y = y * a + x
    return y


def probe_shaped_plain(x, K=6):
    x4 = x.view(x.shape[0], R, S, ND)
    pa = pb = x4[:, :, 0]
    for _ in range(K):
        for i in range(1, S):
            ai = x4[:, :, i]
            pa = pa * ai
            pb = ai * pb + ai
    return pa + pb


def probe_exp_plain(x, a, K=16):
    y = x
    for _ in range(K):
        y = torch.exp(y * a)
    return y


def probe_nsum_plain(x, c, K=24):
    x3 = x.view(x.shape[0], T, N, D2)
    acc = x.new_zeros(x.shape[0], T, D2)
    for k in range(K):
        acc = acc + (x3 * (c[:, :, None] + float(k))).sum(2)
    return acc[:, :, None, :].expand(-1, T, N, D2).reshape(x.shape)


def probe_mxu_seg_plain(x):
    """The TPU probe's product: tril(S, S) @ the segment's tokens, float32."""
    tri = torch.tril(torch.ones(S, S, device=x.device, dtype=x.dtype))
    return torch.einsum("st,grtj->grsj", tri, x.view(x.shape[0], R, S, ND)).reshape(x.shape)


# ---------------------------------------------------------------- kernels


@functools.cache
def _library():
    p, i, out = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    return cxx.load(SOURCE, {"gpu_probe_flat": ([p, p, p] + [i] * 8 + [p], i),
                             "gpu_probe_shaped": ([p, p] + [i] * 4 + [p], i),
                             "gpu_probe_exp": ([p, p, p] + [i] * 8 + [p], i),
                             "gpu_probe_nsum": ([p, p, p] + [i] * 6 + [p], i),
                             "gpu_probe_mxu_seg": ([p, p] + [i] * 3 + [p], i),
                             "gpu_probe_nsum_occupancy": ([out], i),
                             "gpu_probe_stream_occupancy": ([i, out], i)}, "P1-P5 probe")


def _check(name, tensors):
    """Refuse what the kernels do not take: x first, (G, T, ND); every
    tensor float32, contiguous, on x's CUDA device."""
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"probe_{name}: unsupported device {x.device}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (T, ND):
        raise ValueError(f"probe_{name}: x must be (G, {T}, {ND}), got {tuple(x.shape)}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"probe_{name}: inputs must be contiguous float32 on {x.device}")


def _run(name, tensors, out_shape, *ints):
    """Launch `gpu_probe_<name>` on checked tensors and return its output."""
    x = tensors[0]
    lib = _library()
    out = torch.empty(out_shape, device=x.device, dtype=torch.float32)
    cxx.launch(lib, f"gpu_probe_{name}", x.device, *(t.data_ptr() for t in tensors),
               out.data_ptr(), *ints)
    return out


def _launch(name, tensors, out_shape, *ints):
    """Check the tensors (`_check`), launch `gpu_probe_<name>` and return its output."""
    _check(name, tensors)
    return _run(name, tensors, out_shape, *ints)


# P1's and P3's block, consecutive elements of a g a thread, g a tile
STREAM_THREADS, STREAM_V, STREAM_GS = 256, 4, 4


def stream_plan(G, T, ND, sm_count, blocks_per_sm):
    """P1's and P3's launch geometry (`csrc/gpu_probe.cu:flat`, `expchain`),
    from shapes and the card's residency: a tile holds `g_per_tile` g (the
    last group fewer where G is not a multiple) at `tile` in-block offsets, and a
    thread of it `V` consecutive elements of each of its g at the same
    offsets (one 16-byte access each of x and out a g, one of a for all);
    `tiles_per_g` tiles cover a group's T x ND offsets (the last one
    ragged), and `grid` persistent blocks, as many as the card holds
    resident (`sm_count` x `blocks_per_sm`) but no more than the `tiles`,
    walk them in steps of `grid`, at most `tiles_per_block` each. The
    source refuses a launch whose threads, V, g a tile or grid are not this
    plan's."""
    per_g = T * ND
    tile = STREAM_THREADS * STREAM_V
    tiles_per_g = -(-per_g // tile)
    tiles = -(-G // STREAM_GS) * tiles_per_g
    if G < 1 or per_g < 1 or per_g % STREAM_V or per_g > 2**31 - 1 - tile or tiles > 2**31 - 1 \
            or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"stream_plan: P1 / P3 take G >= 1 and T * ND a multiple of {STREAM_V} "
                         f"with 32-bit tile indices; got G={G}, T={T}, ND={ND} on {sm_count} SMs "
                         f"x {blocks_per_sm} blocks")
    grid = min(tiles, sm_count * blocks_per_sm)
    return {"threads": STREAM_THREADS, "V": STREAM_V, "g_per_tile": STREAM_GS, "tile": tile,
            "tiles_per_g": tiles_per_g, "tiles": tiles, "grid": grid,
            "tiles_per_block": -(-tiles // grid)}


@functools.cache
def _stream_resident(name, device):
    """(SMs, resident blocks an SM) of P1's (`flat`) or P3's (`exp`) kernel
    on a CUDA device, from the source's occupancy query."""
    lib = _library()
    out = (ctypes.c_int * 5)()
    with cxx.on_device(device):
        cxx.call(lib, "gpu_probe_stream_occupancy", int(name == "exp"), out)
    return out[3], out[2]


def _launch_stream(name, x, a, K):
    """P1 or P3 on the card at `stream_plan`'s geometry for x's device."""
    _check(name, (x, a))
    x, a = (t.clone() if t.data_ptr() % 16 else t for t in (x, a))  # 16-byte accesses
    plan = stream_plan(x.shape[0], T, ND, *_stream_resident(name, x.device))
    return _run(name, (x, a), x.shape, x.shape[0], T, ND, K, plan["threads"], plan["V"],
                plan["g_per_tile"], plan["grid"])


def probe_flat(x, a, K=48):
    """P1: y = x; K times y = y * a + x. x (G, T, ND), a (T, ND) -> (G, T, ND)."""
    if x.device.type == "cpu":
        return probe_flat_plain(x, a, K)
    out = _launch_stream("flat", x, a, K)
    probe_flat.launches += 1
    return out


def probe_shaped(x, K=6):
    """P2: pass 1 of the scan over the (R, S, ND) view of each block, K times.
    x (G, T, ND) -> (G, R, ND)."""
    if x.device.type == "cpu":
        return probe_shaped_plain(x, K)
    out = _launch("shaped", (x,), (x.shape[0], R, ND), x.shape[0], T, ND, K)
    probe_shaped.launches += 1
    return out


def probe_exp(x, a, K=16):
    """P3: y = x; K times y = exp(y * a). x (G, T, ND), a (T, ND)."""
    if x.device.type == "cpu":
        return probe_exp_plain(x, a, K)
    out = _launch_stream("exp", x, a, K)
    probe_exp.launches += 1
    return out


NSUM_THREADS, NSUM_V, NSUM_K_TILE = 128, 8, 192  # P4's block, d a thread, k a table


def nsum_plan(G, T, N, D2):
    """P4's launch geometry (`csrc/gpu_probe.cu:nsum`), from shapes alone: a
    block of `threads` holds one t and `g_per_block` g; a thread holds `V` d
    of one (g, t) as V / 4 chunks of 4 (one 16-byte access a row each), chunk
    v at d = 4 (col + v cols), where col < `cols` = D2 / V is its place in the
    row; `blocks` is the grid (T, ceil(G / g_per_block)); `smem_bytes` the
    table of c(t, n) + k for `k_tile` values of k. The source refuses a
    launch whose `g_per_block` is not this plan's."""
    if N != 16 or D2 % NSUM_V or not NSUM_V <= D2 <= NSUM_V * NSUM_THREADS:
        raise ValueError(f"nsum_plan: P4 takes N=16 and D2 a multiple of {NSUM_V} up to "
                         f"{NSUM_V * NSUM_THREADS}; got N={N}, D2={D2}")
    cols = D2 // NSUM_V
    gpb = NSUM_THREADS // cols
    return {"threads": NSUM_THREADS, "V": NSUM_V, "cols": cols, "g_per_block": gpb,
            "blocks": (T, -(-G // gpb)), "k_tile": NSUM_K_TILE,
            "smem_bytes": 4 * NSUM_K_TILE * N}


def probe_nsum(x, c, K=24):
    """P4: acc(t, d) = sum over k < K and n of x(t, n, d) * (c(t, n) + k),
    broadcast over n. x (G, T, N*D2), c (T, N) -> (G, T, N*D2)."""
    if x.device.type == "cpu":
        return probe_nsum_plain(x, c, K)
    if x.data_ptr() % 16:  # the kernel reads and writes 16 bytes at a time
        x = x.clone()
    plan = nsum_plan(x.shape[0], T, N, D2)
    out = _launch("nsum", (x, c), x.shape, x.shape[0], T, N, D2, K, plan["g_per_block"])
    probe_nsum.launches += 1
    return out


def probe_mxu_seg(x):
    """P5: the inclusive prefix over each segment of S tokens, on the tensor
    cores. x (G, T, ND) -> the same."""
    if x.device.type == "cpu":
        return probe_mxu_seg_plain(x)
    out = _launch("mxu_seg", (x,), x.shape, x.shape[0], T, ND)
    probe_mxu_seg.launches += 1
    return out


for _fn in (probe_flat, probe_shaped, probe_exp, probe_nsum, probe_mxu_seg):
    _fn.launches = 0
WRAPPERS = dict(zip(NAMES, (probe_flat, probe_shaped, probe_exp, probe_nsum, probe_mxu_seg)))
PLAIN = dict(zip(NAMES, (probe_flat_plain, probe_shaped_plain, probe_exp_plain, probe_nsum_plain,
                         probe_mxu_seg_plain)))
TPU_LINES = {"flat": 61, "shaped": 91, "exp": 123, "nsum": 153, "mxu_seg": 185}


# ---------------------------------------------------------------- measurement


def probe_inputs(name, grid=GRID):
    """The TPU probe's inputs for `grid` blocks, as numpy float32 arrays."""
    shape = (T, ND)

    def rand(*dims):  # a fresh stream per array, as there
        return np.random.default_rng(0).random(dims, np.float32)

    if name == "flat":
        return rand(grid, *shape), rand(*shape) * 0.5 + 0.5
    if name == "exp":
        return rand(grid, *shape) * -0.5, rand(*shape) * -0.5
    if name == "shaped":
        return (rand(grid, *shape) * 0.01 + 0.99,)
    if name == "nsum":
        return rand(grid, *shape), rand(T, N)
    return (rand(grid, *shape),)


def ops(name, grid, K=None):
    """The TPU probe's op count for `grid` blocks."""
    if name == "shaped":
        return grid * R * (S - 1) * N * D2 * K * 3
    if name == "mxu_seg":  # the sequential in-segment adds the product replaces
        return grid * T * N * D2
    return grid * T * N * D2 * K * 2


def bound(name, grid, K=None):
    """(ms, "bytes" or "operations", unit): the least time the card could take,
    each input read once and each output written once, the operations at
    their pipe's peak (`HBM_BYTES_S`, `F32_OPS_S`, `SFU_OPS_S`, `TF32_OPS_S`)."""
    n = grid * T * ND
    out = grid * R * ND if name == "shaped" else n
    extra = {"flat": T * ND, "exp": T * ND, "nsum": T * N}.get(name, 0)
    times = {"hbm": 4 * (n + out + extra) / HBM_BYTES_S, "fma": 0.0, "sfu": 0.0, "tensor": 0.0}
    if name in ("flat", "shaped", "nsum"):
        times["fma"] = ops(name, grid, K) / F32_OPS_S
    if name == "exp":  # one ex2 per exp on the SFU; the multiply by a log2(e) on the FMA pipe
        times["sfu"], times["fma"] = n * K / SFU_OPS_S, n * K / F32_OPS_S
    if name == "mxu_seg":  # one 8-deep product per output
        times["tensor"] = 2 * S * n / TF32_OPS_S
    unit = max(times, key=times.get)
    return times[unit] * 1e3, ("bytes" if unit == "hbm" else "operations"), unit


def library_call(name, args, K):
    """One PyTorch call that computes the probe's function, or None."""
    if name == "nsum":
        x, c = args  # the sum over k of (c + k) is K c + K (K - 1) / 2
        return lambda: torch.einsum("gtnd,tn->gtd", x.view(-1, T, N, D2), c * K + K * (K - 1) / 2)
    if name == "mxu_seg":
        return lambda: torch.cumsum(args[0].view(-1, R, S, ND), 2)
    return None


def cuda_ms(fn, reps=10):
    """Median device time of `fn` in ms over `reps` runs, after one warm-up."""
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


def measure(name, args, K=None):
    """One probe at one K on CUDA tensors: the kernel twice (the same bits),
    against its plain version, timed beside the plain version, the library
    call and the bound. Raises if the kernel disagrees with its plain version."""
    kw = {} if K is None else {"K": K}
    fn = WRAPPERS[name]
    got, again = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = PLAIN[name](*args, **kw)
    end.record()
    end.synchronize()
    abs_err = float((got - want).abs().max())
    err = abs_err / float(want.abs().max())
    row = {"probe": name, "replaces": f"scripts/tpu_vpu_probe.py:{TPU_LINES[name]}", "K": K,
           "grid": args[0].shape[0], "same_bits_twice": bool(torch.equal(got, again)),
           "finite": bool(torch.isfinite(got).all()), "max_abs_err": abs_err, "max_rel_err": err,
           "tol": TOL[name]}
    del got, again, want
    before = fn.launches  # the timed launches, not the comparison's
    row["ms"] = cuda_ms(lambda: fn(*args, **kw))
    row["launches"] = fn.launches - before
    row["gops"] = ops(name, row["grid"], K) / row["ms"] / 1e6
    row["plain_ms"] = start.elapsed_time(end)
    lib = library_call(name, args, K)
    row["library_ms"] = None if lib is None else cuda_ms(lib)
    row["bound_ms"], row["bound_by"], row["bound_unit"] = bound(name, row["grid"], K)
    if not (row["same_bits_twice"] and row["finite"] and err <= TOL[name]):
        raise RuntimeError(f"probe {name} K={K}: {row}")
    return row


def run_all(grid=GRID):
    """Every probe at its TPU K and at `K_COMPUTE` (P5 once) on the card:
    the `measure` rows, in order."""
    rows = []
    for name in NAMES:
        args = tuple(torch.from_numpy(a).cuda() for a in probe_inputs(name, grid))
        for K in ((K_DEFAULT[name], K_COMPUTE[name]) if name in K_DEFAULT else (None,)):
            rows.append(measure(name, args, K))
        del args
        torch.cuda.empty_cache()
    return rows


def _cuobjdump() -> str:
    return str(Path(cxx.nvcc()).with_name("cuobjdump"))


def parse_sass_loop(sass, kernel, opcode="FFMA", template="E"):
    """The hottest loop of `kernel` in a `cuobjdump -sass` listing: of the
    innermost loops (a branch back to an earlier address, and the
    instructions from there to it, holding no other such loop), the one that
    holds the most `opcode` instructions (`opcode` itself or any of its
    variants: "MUFU" counts MUFU.EX2 and MUFU.RCP). `template` picks one
    instantiation of a templated kernel by the mangled name's text after the
    kernel's name (`ILi16ELi2ELb1EffE` for <16, 2, true, float, float>; "E",
    the default, a kernel that is no template). Returns {"opcode", "count":
    its `opcode` instructions, "instructions", "per_op": issued instructions
    an `opcode`, "ffma", "lds", "per_fma": issued instructions a multiply-add
    (None without FFMAs), "ffma_one_bank": the FFMAs whose register sources
    that the operand reuse cache does not hold fall in one of the two
    register banks (even or odd register numbers), "opcodes": {opcode:
    count}}."""
    fn = next(part for part in sass.split("Function : ")[1:]
              if re.match(rf"\S*{len(kernel)}{kernel}{template}", part))
    code, loops = [], []  # (address, opcode, operands) in order; (first, last) address of each loop
    for ln in fn.splitlines():
        op = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)", ln)
        if not op:
            continue
        addr = int(op.group(1), 16)
        code.append((addr, op.group(2), op.group(3)))
        target = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", ln)
        if target and int(target.group(1), 16) <= addr:  # a backward branch closes a loop
            loops.append((int(target.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo, hi) != (a, b) and lo <= a and b <= hi for a, b in loops)]
    bodies = [[(o, args) for a, o, args in code if lo <= a <= hi] for lo, hi in inner]
    hits = lambda body: sum(o == opcode or o.startswith(opcode + ".") for o, _ in body)
    best = max(bodies, key=hits, default=None)
    if not best or not hits(best):
        raise RuntimeError(f"sass_loop: no loop with {opcode} in {kernel}")
    opcodes, one_bank = {}, 0
    for op, args in best:
        opcodes[op] = opcodes.get(op, 0) + 1
        if op == "FFMA":  # FFMA d, a, b, c: the sources not marked .reuse
            banks = [int(r) % 2 for r in re.findall(r"\bR(\d+)\b(?!\.reuse)", args.split(",", 1)[1])]
            one_bank += len(banks) > len(set(banks))
    ffma = opcodes.get("FFMA", 0)
    return {"opcode": opcode, "count": hits(best), "instructions": len(best),
            "per_op": len(best) / hits(best), "ffma": ffma,
            "lds": sum(n for op, n in opcodes.items() if op.startswith("LDS")),
            "per_fma": len(best) / ffma if ffma else None, "ffma_one_bank": one_bank,
            "opcodes": opcodes}


def sass_loop(kernel="nsum", library=None, opcode="FFMA", template="E"):
    """`parse_sass_loop` of `kernel` in a built library (the probes' by
    default), from `cuobjdump -sass`. Needs the CUDA toolkit, not a card."""
    library = library or cxx.build(SOURCE)
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return parse_sass_loop(sass, kernel, opcode, template)


# The probes whose resources are read: their kernel and the opcode of its hot loop.
RESOURCE_KERNELS = {"flat": ("flat", "FFMA"), "exp": ("expchain", "MUFU.EX2"),
                    "nsum": ("nsum", "FFMA")}


def probe_resources(name):
    """P1's, P3's or P4's resources on this card: threads, the blocks and
    warps an SM that the occupancy query reports, registers and spill bytes
    from the build's `-Xptxas -v` report, and `sass_loop` of its kernel
    picked by its opcode (`RESOURCE_KERNELS`); P4 also its static shared
    memory, P1 and P3 the elements of a g a thread (`V`), the g a tile and
    the persistent grid at `GRID` blocks."""
    kernel, opcode = RESOURCE_KERNELS[name]
    out = (ctypes.c_int * 5)()
    if name == "nsum":
        cxx.call(_library(), "gpu_probe_nsum_occupancy", out)
    else:
        cxx.call(_library(), "gpu_probe_stream_occupancy", int(name == "exp"), out)
    library = cxx.build(SOURCE)
    log = library.with_suffix(".log").read_text()
    entry = log[log.index(f"{len(kernel)}{kernel}E"):]  # from its "Compiling entry function" line on
    registers = int(re.search(r"Used (\d+) registers", entry).group(1))
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
    row = {"kernel": kernel, "threads": out[0], "blocks_per_sm": out[2],
           "warps_per_sm": out[2] * out[0] // 32, "registers": registers,
           "spill_store_bytes": int(spills.group(1)), "spill_load_bytes": int(spills.group(2))}
    if name == "nsum":
        row["smem_bytes"] = out[1]
    else:
        row["V"], row["sm_count"], row["g_per_tile"] = out[1], out[3], out[4]
        row["grid"] = stream_plan(GRID, T, ND, out[3], out[2])["grid"]
    return {**row, "sass_loop": sass_loop(kernel, library, opcode)}


def main():
    if not torch.cuda.is_available():
        sys.exit("gpu_probe: torch.cuda.is_available() is False; the probes measure the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain P5 in full float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for row in run_all():
        print(json.dumps({**row, "device": smi}), flush=True)
    for name in RESOURCE_KERNELS:
        print(json.dumps({"probe": name, **probe_resources(name)}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
