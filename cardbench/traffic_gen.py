"""The one traffic generator: what a mix file under `traffic/` describes,
made from the run's seed.

Frames (`frames`): low-light photographs stood in for by a smooth random
scene (a coarse grid of colours, upsampled bicubically, with finer detail
added from a second grid), dimmed by a brightness drawn per frame, with shot
noise: Poisson counts at `photons_at_white` photons for a white pixel at
full brightness, quantised to 8 bits. They come back as the CLI's decoder
gives them, BGR uint8 (H, W, 3) numpy arrays. Training pairs (`pairs`):
the clean scene as ground truth and its dark, noisy shot as input, RGB
uint8 as the device-resident loader takes them. Every number is drawn on
the given device from a generator seeded by the run's seed, a whole pool
or `make_batch` images a call.

`order` is the sequence of pool indices the requests take: each seed sends
the same frames, as many times each, in its own order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream `stream` of the run's seed (any whole number)."""
    seq = np.random.SeedSequence([int(seed) & (2**64 - 1), stream])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


FRAMES, ORDER, WEIGHTS, CHECK, DATA, PAIRS = 1, 2, 3, 4, 5, 6  # streams of one run's seed


def _scenes(mix: dict, n: int, gen, device) -> torch.Tensor:
    """(n, 3, height, width) float32 scenes in [0, 1]."""
    h, w = mix["height"], mix["width"]

    def grid(size, lo, hi):
        return torch.rand((n, 3, *size), generator=gen, device=device) * (hi - lo) + lo

    scene = F.interpolate(grid(mix["scene_grid"], 0.0, 1.0), size=(h, w), mode="bicubic",
                          align_corners=False)
    amp = mix["detail_amplitude"]
    scene += F.interpolate(grid(mix["detail_grid"], -amp, amp), size=(h, w), mode="bilinear",
                           align_corners=False)
    return scene.clamp_(0.0, 1.0)


def _dark(mix: dict, scene: torch.Tensor, gen) -> torch.Tensor:
    """The scene dimmed by a brightness drawn per image, with shot noise:
    Poisson photon counts, `photons_at_white` for white at full brightness."""
    lo, hi = mix["brightness"]
    bright = torch.rand((len(scene), 1, 1, 1), generator=gen, device=scene.device) * (hi - lo) + lo
    photons = mix["photons_at_white"]
    return torch.poisson(scene * bright * photons, generator=gen) / photons


def _u8(x: torch.Tensor) -> torch.Tensor:
    return (x * 255.0).round_().clamp_(0, 255).to(torch.uint8)


def frames(mix: dict, seed: int, device) -> list[np.ndarray]:
    """`mix['pool']` BGR uint8 frames of `mix['height']` x `mix['width']`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, FRAMES))
    dark = _u8(_dark(mix, _scenes(mix, mix["pool"], gen, device), gen))
    return list(dark.flip(1).permute(0, 2, 3, 1).contiguous().cpu().numpy())


def pairs(mix: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """`mix['pairs']` training pairs (lq, gt), each (N, height, width, 3)
    RGB uint8, as the loader takes decoded images: gt the clean scene, lq
    its dark, noisy shot. Made `mix['make_batch']` at a time."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, PAIRS))
    lq, gt = [], []
    for at in range(0, mix["pairs"], mix["make_batch"]):
        scene = _scenes(mix, min(mix["make_batch"], mix["pairs"] - at), gen, device)
        gt.append(_u8(scene).permute(0, 2, 3, 1).cpu())
        lq.append(_u8(_dark(mix, scene, gen)).permute(0, 2, 3, 1).cpu())
    return torch.cat(lq).numpy(), torch.cat(gt).numpy()


def order(mix: dict, seed: int, count: int) -> np.ndarray:
    """Pool indices of requests 0..count-1: whole cycles through the pool,
    each cycle a seeded permutation."""
    rng = np.random.default_rng(sub_seed(seed, ORDER))
    cycles = -(-count // mix["pool"])
    return np.concatenate([rng.permutation(mix["pool"]) for _ in range(cycles)])[:count]


def checked(seed: int, kept: int, count: int) -> list[int]:
    """`count` request numbers out of the first `kept`, drawn from the seed,
    whose answers the check compares."""
    rng = np.random.default_rng(sub_seed(seed, CHECK))
    return sorted(rng.choice(kept, size=min(count, kept), replace=False).tolist())
