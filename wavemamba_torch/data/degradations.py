"""Blind-SR degradation synthesis (`basicsr/data/bsrgan_util.py`, 762 LoC).
The counterpart of `wavemamba_tpu/data/degradations.py`: the same host code
(numpy, scipy, OpenCV), with `imresize` from `utils/matlab.py` and USM
sharpening from `utils/img_process_util.py`.

The BSRGAN degradation toolbox: blur-kernel generators (isotropic /
anisotropic Gaussian, random covariance `gen_kernel`, `analytic_kernel`,
MATLAB `fspecial`), the four classical degradation models (bicubic / srmd /
dpsr / classical), noise models (Gaussian color / gray / correlated, speckle,
Poisson), JPEG, USM sharpening, and the shuffled composite pipelines
`degradation_bsrgan` / `degradation_bsrgan_plus`. The procedural dataset
generator (`scripts/make_proc_dataset.py --bsrgan`) composes them on top of
its low-light model.

Unlike the rest of the port, which passes explicit generators, every draw
here comes from the module-global streams of python's `random` and numpy's
`np.random`, in the reference's order (e.g. `add_blur` draws l1 and l2
before ksize and theta): the generator seeds those streams, and the bytes of
the datasets it writes depend on that order. `cv2` is imported by the
functions that use it, so the module imports where OpenCV is missing.
"""

from __future__ import annotations

import random

import numpy as np
from scipy import ndimage

from wavemamba_torch.utils.img_process_util import usm_sharp
from wavemamba_torch.utils.matlab import imresize


def gaussian_kernel(size=21, sigma1=1.6, sigma2=None, theta=0.0):
    """Isotropic (sigma2 None) or rotated anisotropic Gaussian kernel."""
    if sigma2 is None:
        sigma2 = sigma1
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    cov = rot @ np.diag([sigma1**2, sigma2**2]) @ rot.T
    g = np.arange(size) - size // 2
    xx, yy = np.meshgrid(g, g)
    coords = np.stack([xx, yy], axis=-1)
    inv = np.linalg.inv(cov)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", coords, inv, coords))
    return (k / k.sum()).astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel generators (`bsrgan_util.py:198-374`).


def gm_blur_kernel(mean, cov, size=15):
    """Gaussian-mixture pdf evaluated on the kernel grid
    (`bsrgan_util.py:236-247`) — vectorized closed form instead of the
    reference's per-pixel scipy.stats calls; identical values."""
    center = size / 2.0 + 0.5
    g = np.arange(size) - center + 1  # the reference's cx/cy offsets
    xx, yy = np.meshgrid(g, g)
    d = np.stack([xx, yy], axis=-1) - np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    inv = np.linalg.inv(cov)
    norm = 1.0 / (2.0 * np.pi * np.sqrt(np.linalg.det(cov)))
    k = norm * np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", d, inv, d))
    return k / k.sum()


def anisotropic_gaussian(ksize=15, theta=np.pi, l1=6, l2=6):
    """Anisotropic Gaussian kernel with eigenvalues l1/l2 rotated by theta
    (`bsrgan_util.py:214-233`; the reference builds the covariance from a
    reflection matrix V — reproduced exactly)."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    Sigma = V @ np.diag([l1, l2]) @ np.linalg.inv(V)
    return gm_blur_kernel(mean=[0, 0], cov=Sigma, size=ksize)


def analytic_kernel(k):
    """Expand an x2 kernel to the analytic x4 kernel (`bsrgan_util.py:198-211`):
    big[2r:2r+n, 2c:2c+n] += k[r,c] * k, then crop n//2 and renormalize."""
    n = k.shape[0]
    big = np.zeros((3 * n - 2, 3 * n - 2))
    for r in range(n):
        for c in range(n):
            big[2 * r : 2 * r + n, 2 * c : 2 * c + n] += k[r, c] * k
    crop = n // 2
    big = big[crop:-crop, crop:-crop]
    return big / big.sum()


def gen_kernel(k_size=(15, 15), scale_factor=(4, 4), min_var=0.6,
               max_var=10.0, noise_level=0):
    """Random-covariance shifted Gaussian kernel (`bsrgan_util.py:295-335`,
    after BlindSR_dataset_generator): eigenvalues ~ U[min_var, max_var],
    angle ~ U[0, pi], mean shifted by (sf-1)/2 for aligned downsampling,
    optional multiplicative noise."""
    k_size = np.asarray(k_size)
    scale_factor = np.asarray(scale_factor)
    l1 = min_var + np.random.rand() * (max_var - min_var)
    l2 = min_var + np.random.rand() * (max_var - min_var)
    theta = np.random.rand() * np.pi
    noise = -noise_level + np.random.rand(*k_size) * noise_level * 2

    Q = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    inv_sigma = np.linalg.inv(Q @ np.diag([l1, l2]) @ Q.T)
    mu = k_size // 2 - 0.5 * (scale_factor - 1)
    xx, yy = np.meshgrid(range(k_size[0]), range(k_size[1]))
    d = np.stack([xx, yy], axis=-1) - mu[None, None, :]
    raw = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", d, inv_sigma, d))
    raw = raw * (1 + noise)
    return raw / raw.sum()


def fspecial_gaussian(hsize, sigma):
    """MATLAB fspecial('gaussian') (`bsrgan_util.py:337-348`)."""
    siz = (hsize - 1.0) / 2.0
    x, y = np.meshgrid(np.arange(-siz, siz + 1), np.arange(-siz, siz + 1))
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def fspecial_laplacian(alpha):
    """MATLAB fspecial('laplacian') (`bsrgan_util.py:351-357`)."""
    alpha = max(0.0, min(alpha, 1.0))
    h1 = alpha / (alpha + 1)
    h2 = (1 - alpha) / (alpha + 1)
    return np.array([[h1, h2, h1], [h2, -4 / (alpha + 1), h2], [h1, h2, h1]])


def fspecial(filter_type, *args, **kwargs):
    return {"gaussian": fspecial_gaussian,
            "laplacian": fspecial_laplacian}[filter_type](*args, **kwargs)


def shift_pixel(x, sf, upper_left=True):
    """Sub-pixel shift by (sf-1)/2 via bilinear resampling
    (`bsrgan_util.py:249-275`; the reference uses scipy interp2d, removed
    in scipy>=1.14 — cv2.remap with clamped linear sampling is the same
    operation)."""
    import cv2

    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5 if upper_left else -(sf - 1) * 0.5
    xv = np.clip(np.arange(w, dtype=np.float32) + shift, 0, w - 1)
    yv = np.clip(np.arange(h, dtype=np.float32) + shift, 0, h - 1)
    mx, my = np.meshgrid(xv, yv)
    return cv2.remap(x.astype(np.float32), mx, my, cv2.INTER_LINEAR)


# ---------------------------------------------------------------------------
# Classical degradation models (`bsrgan_util.py:377-455`).


def bicubic_degradation(x, sf=3):
    """MATLAB-bicubic 1/sf downsampling (`bsrgan_util.py:377-387`)."""
    return imresize(x, 1.0 / sf).astype(np.float32)


def srmd_degradation(x, k, sf=3):
    """Blur (wrap border) then bicubic downsample (`bsrgan_util.py:390-412`)."""
    x = ndimage.convolve(x, k[:, :, None], mode="wrap")
    return bicubic_degradation(x, sf=sf)


def dpsr_degradation(x, k, sf=3):
    """Bicubic downsample then blur (`bsrgan_util.py:415-438`)."""
    return ndimage.convolve(bicubic_degradation(x, sf=sf), k[:, :, None],
                            mode="wrap")


def classical_degradation(x, k, sf=3):
    """Blur then sf-strided subsampling (`bsrgan_util.py:441-455`)."""
    x = ndimage.convolve(x, k[:, :, None], mode="wrap")
    return x[0::sf, 0::sf, ...]


def add_sharpening(img, weight=0.5, radius=50, threshold=10):
    """USM sharpening with a soft mask (`bsrgan_util.py:458-481`; shares
    the implementation with `utils/img_process_util.py`)."""
    return usm_sharp(img, weight=weight, radius=radius, threshold=threshold)


# ---------------------------------------------------------------------------
# Stochastic degradation ops (`bsrgan_util.py:484-567`). Probabilities,
# ranges, and branch structure mirror the reference exactly.


def add_blur(img, sf=4):
    """Random anisotropic or fspecial-Gaussian blur (`bsrgan_util.py:484-495`)."""
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    if random.random() < 0.5:
        l1 = wd2 * random.random()  # drawn before ksize/theta — the
        l2 = wd2 * random.random()  # reference's RNG stream order
        k = anisotropic_gaussian(ksize=2 * random.randint(2, 11) + 3,
                                 theta=random.random() * np.pi, l1=l1, l2=l2)
    else:
        k = fspecial("gaussian", 2 * random.randint(2, 11) + 3,
                     wd * random.random())
    return ndimage.convolve(img, k[:, :, None], mode="mirror")


def add_resize(img, sf=4):
    """Random up/down/identity rescale (`bsrgan_util.py:498-509`)."""
    import cv2

    rnum = np.random.rand()
    if rnum > 0.8:
        sf1 = random.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = random.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    img = cv2.resize(img, (int(sf1 * img.shape[1]), int(sf1 * img.shape[0])),
                     interpolation=random.choice([1, 2, 3]))
    return np.clip(img, 0.0, 1.0)


def _correlated_color_noise(shape_hw, noise_level2):
    """Channel-correlated Gaussian noise (`bsrgan_util.py:545-549`)."""
    from scipy.linalg import orth

    L = noise_level2 / 255.0
    D = np.diag(np.random.rand(3))
    U = orth(np.random.rand(3, 3))
    conv = U.T @ D @ U
    return np.random.multivariate_normal(
        [0, 0, 0], np.abs(L**2 * conv), shape_hw
    ).astype(np.float32)


def add_gaussian_noise(img, noise_level1=2, noise_level2=25):
    """Color / grayscale / channel-correlated Gaussian noise
    (`bsrgan_util.py:512-526`)."""
    noise_level = random.randint(noise_level1, noise_level2)
    rnum = np.random.rand()
    if rnum > 0.6:
        img = img + np.random.normal(
            0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + np.random.normal(
            0, noise_level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + _correlated_color_noise(img.shape[:2], noise_level2)
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img, noise_level1=2, noise_level2=25):
    """Multiplicative (signal-proportional) noise (`bsrgan_util.py:529-544`)."""
    noise_level = random.randint(noise_level1, noise_level2)
    img = np.clip(img, 0.0, 1.0)
    rnum = random.random()
    if rnum > 0.6:
        img = img + img * np.random.normal(
            0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + img * np.random.normal(
            0, noise_level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + img * _correlated_color_noise(img.shape[:2], noise_level2)
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img):
    """Shot noise, full-color or luma-only (`bsrgan_util.py:547-558`)."""
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * random.random() + 2.0)
    if random.random() < 0.5:
        img = np.random.poisson(img * vals).astype(np.float32) / vals
    else:
        gray = np.dot(img[..., :3], [0.299, 0.587, 0.114])
        gray = np.clip((gray * 255.0).round(), 0, 255) / 255.0
        img = img + (np.random.poisson(gray * vals).astype(np.float32) / vals
                     - gray)[:, :, None]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img):
    """Random-quality JPEG round trip (`bsrgan_util.py:561-567`).
    img: HWC RGB [0,1]."""
    import cv2

    q = random.randint(30, 95)
    bgr = (np.clip(img, 0, 1)[..., ::-1] * 255.0).round().astype(np.uint8)
    _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), q])
    dec = cv2.imdecode(enc, 1)[..., ::-1]
    return dec.astype(np.float32) / 255.0


def random_crop(lq, hq, sf=4, lq_patchsize=64):
    """Aligned LQ/HQ random crop (`bsrgan_util.py:570-578`)."""
    h, w = lq.shape[:2]
    rnd_h = random.randint(0, h - lq_patchsize)
    rnd_w = random.randint(0, w - lq_patchsize)
    lq = lq[rnd_h : rnd_h + lq_patchsize, rnd_w : rnd_w + lq_patchsize, :]
    rh, rw = int(rnd_h * sf), int(rnd_w * sf)
    hq = hq[rh : rh + lq_patchsize * sf, rw : rw + lq_patchsize * sf, :]
    return lq, hq


# ---------------------------------------------------------------------------
# Composite pipelines (`bsrgan_util.py:581-744`). The camera-ISP branch
# takes an optional isp_model with the reference's forward(img, hq) API.


def degradation_bsrgan(img, sf=4, lq_patchsize=72, isp_model=None,
                       use_crop=True):
    """BSRGAN degradation chain (`bsrgan_util.py:581-669`): optional x2
    pre-downsample (sf=4 only), 7 shuffled stages with downsample3 kept
    after downsample2, final JPEG, aligned random crop. img: HWC RGB [0,1].
    Returns (lq, hq)."""
    import cv2

    isp_prob, jpeg_prob, scale2_prob = 0.25, 0.9, 0.25
    sf_ori = sf

    h1, w1 = img.shape[:2]
    # reference quirk reproduced: the mod-crop slices rows by w1 and
    # columns by h1 (`bsrgan_util.py:601`) — identical for square inputs.
    img = img.copy()[: w1 - w1 % sf, : h1 - h1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")

    hq = img.copy()

    if sf == 4 and random.random() < scale2_prob:
        if np.random.rand() < 0.5:
            img = cv2.resize(img, (img.shape[1] // 2, img.shape[0] // 2),
                             interpolation=random.choice([1, 2, 3]))
        else:
            img = imresize(img, 0.5).astype(np.float32)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    shuffle_order = random.sample(range(7), 7)
    idx1, idx2 = shuffle_order.index(2), shuffle_order.index(3)
    if idx1 > idx2:  # keep downsample3 after downsample2
        shuffle_order[idx1], shuffle_order[idx2] = (
            shuffle_order[idx2], shuffle_order[idx1])

    a = b = None
    for i in shuffle_order:
        if i in (0, 1):
            img = add_blur(img, sf=sf)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if random.random() < 0.75:
                sf1 = random.uniform(1, 2 * sf)
                img = cv2.resize(
                    img, (int(img.shape[1] / sf1), int(img.shape[0] / sf1)),
                    interpolation=random.choice([1, 2, 3]))
            else:
                k = fspecial("gaussian", 25, random.uniform(0.1, 0.6 * sf))
                k = shift_pixel(k, sf)
                k = k / k.sum()
                img = ndimage.convolve(img, k[:, :, None], mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = cv2.resize(img, (int(a / sf), int(b / sf)),
                             interpolation=random.choice([1, 2, 3]))
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, noise_level1=2, noise_level2=25)
        elif i == 5:
            if random.random() < jpeg_prob:
                img = add_jpeg_noise(img)
        elif i == 6:
            if random.random() < isp_prob and isp_model is not None:
                img, hq = isp_model.forward(img.copy(), hq)

    img = add_jpeg_noise(img)
    if use_crop:
        img, hq = random_crop(img, hq, sf_ori, lq_patchsize)
    return img, hq


def degradation_bsrgan_plus(img, sf=4, shuffle_prob=0.5, use_sharp=True,
                            lq_patchsize=64, isp_model=None, crop=True):
    """BSRGAN+Real-ESRGAN combined chain (`bsrgan_util.py:672-744`): 13
    stages (two blur/resize/noise rounds), full or local shuffle, optional
    USM pre-sharpening. Returns (lq, hq)."""
    import cv2

    h1, w1 = img.shape[:2]
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")

    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if random.random() < shuffle_prob:
        shuffle_order = random.sample(range(13), 13)
    else:
        shuffle_order = list(range(13))
        shuffle_order[2:6] = random.sample(shuffle_order[2:6], 4)
        shuffle_order[9:13] = random.sample(shuffle_order[9:13], 4)

    poisson_prob, speckle_prob, isp_prob = 0.1, 0.1, 0.1
    for i in shuffle_order:
        if i in (0, 7):
            img = add_blur(img, sf=sf)
        elif i in (1, 8):
            img = add_resize(img, sf=sf)
        elif i in (2, 9):
            img = add_gaussian_noise(img, noise_level1=2, noise_level2=25)
        elif i in (3, 10):
            if random.random() < poisson_prob:
                img = add_poisson_noise(img)
        elif i in (4, 11):
            if random.random() < speckle_prob:
                img = add_speckle_noise(img)
        elif i in (5, 12):
            if random.random() < isp_prob and isp_model is not None:
                img, hq = isp_model.forward(img.copy(), hq)
        elif i == 6:
            img = add_jpeg_noise(img)

    # resize to the desired LQ size and final JPEG (`bsrgan_util.py:739-744`)
    img = cv2.resize(img, (int(w / sf), int(h / sf)),
                     interpolation=random.choice([1, 2, 3]))
    img = add_jpeg_noise(img)
    if crop:
        img, hq = random_crop(img, hq, sf, lq_patchsize)
    return img, hq
