"""Build a procedural low-light-enhancement dataset. The counterpart of
`scripts/make_proc_dataset.py`, with the port's BSRGAN toolbox
(`wavemamba_torch/data/degradations.py`): no JAX is needed.

Where the real LOL / UHD-LL datasets are not at hand, end-to-end training
uses procedurally-degraded pairs instead: well-lit GT crops are harvested
from natural images (`--figures`) plus synthetic multi-octave textures for
diversity, and LQ inputs are produced with a LOL-style low-light model
(gamma curve + exposure drop + sensor noise); `--bsrgan` composes blur,
noise and JPEG from the BSRGAN toolbox on top.

The flags, the draws and their order are the JAX script's, so both write
the same files, byte for byte, from the same arguments on one host (PNG and
JPEG bytes depend on the host's OpenCV build). The JAX script harvests the
original repository's `Figures/*.png` from a fixed mount; pass that glob as
`--figures` to harvest the same crops here (without it, and without that
mount there, both sets are synthetic only). Needs OpenCV.

Usage:
    python -m wavemamba_torch.scripts.make_proc_dataset --out datasets/proc_llie \
        --n-train 400 --n-val 15 [--size 512] [--seed 0] [--bsrgan] [--figures GLOB ...]

then pin the set with `python -m wavemamba_torch.scripts.dataset_manifest write
<out> --generator-args '<the flags above>'` and check it with `python -m
wavemamba_torch.scripts.dataset_manifest verify <out>`.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def _harvest_crops(rng, size, patterns):
    """Photo-like square crops from the images that the glob `patterns` find
    (the paper's figures contain natural crops)."""
    import cv2

    sources = []
    for pattern in patterns:
        sources.extend(sorted(glob.glob(pattern)))
    crops = []
    for path in sources:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            continue
        h, w = img.shape[:2]
        if min(h, w) < size // 2:
            continue
        # dense grid of candidate crops (upscale small sources)
        scale = max(1.0, size / min(h, w) * 1.05)
        if scale > 1.0:
            img = cv2.resize(img, (int(w * scale) + 1, int(h * scale) + 1),
                             interpolation=cv2.INTER_CUBIC)
            h, w = img.shape[:2]
        for y in range(0, h - size + 1, size // 2):
            for x in range(0, w - size + 1, size // 2):
                c = img[y:y + size, x:x + size].astype(np.float32) / 255.0
                # reject flat / mostly-white (text, background) regions
                if c.std() < 0.08 or c.mean() > 0.85:
                    continue
                crops.append(c[:, :, ::-1])  # BGR -> RGB
    return crops


def _synth_texture(rng, size):
    """Colored multi-octave value noise + occasional geometry — synthetic
    GT with energy at all scales (what restoration losses care about)."""
    import cv2

    img = np.zeros((size, size, 3), np.float32)
    for octave in range(5):
        n = 2 ** (octave + 2)
        coarse = rng.rand(n, n, 3).astype(np.float32)
        up = cv2.resize(coarse, (size, size), interpolation=cv2.INTER_CUBIC)
        img += up * (0.55 ** octave)
    img /= img.max() + 1e-6
    # random color balance
    img = img * rng.uniform(0.6, 1.0, (1, 1, 3)).astype(np.float32)
    # a few geometric shapes for sharp edges
    for _ in range(rng.randint(2, 7)):
        color = rng.rand(3).tolist()
        p1 = tuple(int(v) for v in rng.randint(0, size, 2))
        p2 = tuple(int(v) for v in rng.randint(0, size, 2))
        if rng.rand() < 0.5:
            cv2.rectangle(img, p1, p2, color, thickness=rng.randint(1, 6))
        else:
            cv2.circle(img, p1, int(rng.randint(8, size // 3)), color,
                       thickness=rng.randint(1, 6))
    return np.clip(img, 0.0, 1.0)


def _normalize_exposure(img, rng):
    """Scale GT into a well-lit range (mean luma ~0.35-0.55)."""
    target = rng.uniform(0.35, 0.55)
    mean = img.mean() + 1e-6
    return np.clip(img * (target / mean), 0.0, 1.0)


def degrade_lowlight(gt, rng):
    """LOL-style degradation: gamma curve + exposure drop + sensor noise.

    lq = (gt ** gamma) * exposure + shot_noise + read_noise
    """
    gamma = rng.uniform(1.8, 3.2)
    exposure = rng.uniform(0.10, 0.35)
    lq = np.power(np.clip(gt, 0.0, 1.0), gamma) * exposure
    # shot noise scales with signal, read noise is additive
    shot = rng.normal(0.0, 1.0, lq.shape).astype(np.float32) * np.sqrt(
        np.clip(lq, 1e-6, 1.0)) * rng.uniform(0.005, 0.02)
    read = rng.normal(0.0, rng.uniform(0.003, 0.012), lq.shape).astype(np.float32)
    return np.clip(lq + shot + read, 0.0, 1.0)


def degrade_lowlight_bsrgan(gt, rng):
    """Harder, more realistic LLIE degradation (round 3): the LOL-style
    photometric model composed with a random shuffle of the BSRGAN toolbox
    (`wavemamba_torch/data/degradations.py`, the port of the reference's
    `basicsr/data/bsrgan_util.py`): anisotropic blur, camera-style
    Gaussian/speckle/Poisson noise, and JPEG compression — the degradation
    families real night photos carry on top of low exposure.
    """
    from wavemamba_torch.data import degradations as dg

    # photometric low-light core (always)
    lq = degrade_lowlight(gt, rng)

    # seed the module-global RNG the toolbox uses
    np.random.seed(rng.randint(0, 2**31 - 1))
    import random as _random

    _random.seed(int(rng.randint(0, 2**31 - 1)))

    ops = []
    if rng.rand() < 0.7:
        ops.append(lambda im: dg.add_blur(im, sf=1))
    if rng.rand() < 0.6:
        ops.append(lambda im: dg.add_gaussian_noise(im, 1, rng.randint(4, 16)))
    if rng.rand() < 0.2:
        ops.append(lambda im: dg.add_speckle_noise(im, 1, rng.randint(2, 10)))
    if rng.rand() < 0.25:
        ops.append(dg.add_poisson_noise)
    rng.shuffle(ops)
    for op in ops:
        lq = op(lq)
    if rng.rand() < 0.5:  # JPEG last (like the real camera pipeline)
        lq = dg.add_jpeg_noise(lq)
    return np.clip(lq, 0.0, 1.0).astype(np.float32)


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="datasets/proc_llie")
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-val", type=int, default=15)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bsrgan", action="store_true",
                    help="compose the BSRGAN degradation toolbox (blur/"
                    "noise/JPEG) on top of the low-light model")
    ap.add_argument("--figures", nargs="*", default=[],
                    help="globs of natural images to harvest GT crops from")
    args = ap.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    crops = _harvest_crops(rng, args.size, args.figures)
    print(f"harvested {len(crops)} natural crops")

    total = args.n_train + args.n_val
    gts = []
    for i in range(total):
        if crops and i % 2 == 0:  # alternate natural / synthetic
            base = crops[rng.randint(len(crops))].copy()
            # random dihedral augmentation for variety
            if rng.rand() < 0.5:
                base = base[:, ::-1]
            base = np.rot90(base, rng.randint(4)).copy()
        else:
            base = _synth_texture(rng, args.size)
        gts.append(_normalize_exposure(base, rng))

    for split, lo, hi in (("train", 0, args.n_train),
                          ("val", args.n_train, total)):
        gt_dir = os.path.join(args.out, split, "gt")
        lq_dir = os.path.join(args.out, split, "input")
        os.makedirs(gt_dir, exist_ok=True)
        os.makedirs(lq_dir, exist_ok=True)
        degrade = degrade_lowlight_bsrgan if args.bsrgan else degrade_lowlight
        for i in range(lo, hi):
            gt = gts[i]
            lq = degrade(gt, rng)
            name = f"{i:05d}.png"
            cv2.imwrite(os.path.join(gt_dir, name),
                        (gt[:, :, ::-1] * 255.0 + 0.5).astype(np.uint8))
            cv2.imwrite(os.path.join(lq_dir, name),
                        (lq[:, :, ::-1] * 255.0 + 0.5).astype(np.uint8))
        print(f"{split}: {hi - lo} pairs -> {os.path.join(args.out, split)}")


if __name__ == "__main__":
    main()
