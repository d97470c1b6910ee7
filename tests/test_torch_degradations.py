"""The port's BSRGAN toolbox (`wavemamba_torch/data/degradations.py`), its
MATLAB imresize (`utils/matlab.py`) and its dataset generator
(`python -m wavemamba_torch.scripts.make_proc_dataset`) against the JAX
package's on the CPU.

Both sides are the same host code (numpy, scipy, OpenCV) drawing from the
module-global `random` / `np.random` streams: under the same seeds every
result must be equal bit for bit, and both streams must be left in the same
state (the same draws, in the same order). The generator must write the same
files, byte for byte, as `scripts/make_proc_dataset.py` with the same
arguments on this host.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from wavemamba_torch.data import degradations as tdg
from wavemamba_torch.utils import matlab as tmat
from wavemamba_tpu.data import degradations as jdg
from wavemamba_tpu.utils import matlab as jmat

# The suite runs in several worker processes on a few cores: torch's intra-op
# threads spin while they wait.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from dataset_manifest import build_manifest  # noqa: E402


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _seeded(fn, seed, *args, **kw):
    """fn(*args) after seeding both global streams; returns the result and
    the streams' states after it."""
    random.seed(seed)
    np.random.seed(seed)
    out = fn(*args, **kw)
    return out, random.getstate(), np.random.get_state()


def _assert_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _assert_same_draws(port_fn, jax_fn, seed, *args, **kw):
    got, g_py, g_np = _seeded(port_fn, seed, *args, **kw)
    want, w_py, w_np = _seeded(jax_fn, seed, *args, **kw)
    _assert_equal(got, want)
    assert g_py == w_py
    assert all(np.array_equal(a, b) for a, b in zip(g_np, w_np))


@pytest.mark.parametrize("shape,scale", [((48, 64, 3), 0.25), ((48, 64, 3), 0.5), ((24, 20, 3), 2),
                                         ((37, 51, 3), 0.5), ((37, 51), 1 / 3)])
def test_imresize_is_bit_equal(shape, scale):
    """MATLAB bicubic with antialiasing, float64: equal bits at down- and
    upscales, on a ragged size and on a 2-D image."""
    img = _img(shape, 1) * 255
    for antialiasing in (True, False):
        got = tmat.imresize(img, scale, antialiasing)
        _assert_equal(got, jmat.imresize(img, scale, antialiasing))
    assert got.shape[:2] == (int(np.ceil(shape[0] * scale)), int(np.ceil(shape[1] * scale)))
    _assert_equal(tmat.imresize(img.astype(np.uint8), scale), jmat.imresize(img.astype(np.uint8), scale))


def test_kernel_generators_are_bit_equal():
    for args in ((21, 1.6), (15, 2.0, 4.0, 0.7), (9, 0.5, 3.0, 2.0)):
        _assert_equal(tdg.gaussian_kernel(*args), jdg.gaussian_kernel(*args))
    cov = np.array([[3.0, 1.0], [1.0, 2.0]])
    _assert_equal(tdg.gm_blur_kernel([0.5, -0.3], cov, 15), jdg.gm_blur_kernel([0.5, -0.3], cov, 15))
    for theta, l1, l2 in ((np.pi, 6, 6), (0.3, 2.0, 9.0), (1.1, 0.4, 3.3)):
        _assert_equal(tdg.anisotropic_gaussian(13, theta, l1, l2),
                      jdg.anisotropic_gaussian(13, theta, l1, l2))
    k = jdg.anisotropic_gaussian(7, 0.4, 1.5, 3.0)
    _assert_equal(tdg.analytic_kernel(k), jdg.analytic_kernel(k))
    for hsize, sigma in ((25, 0.3), (15, 2.5), (7, 10.0)):
        _assert_equal(tdg.fspecial_gaussian(hsize, sigma), jdg.fspecial_gaussian(hsize, sigma))
        _assert_equal(tdg.fspecial("gaussian", hsize, sigma), jdg.fspecial("gaussian", hsize, sigma))
    for alpha in (-0.5, 0.2, 0.7, 3.0):
        _assert_equal(tdg.fspecial_laplacian(alpha), jdg.fspecial_laplacian(alpha))
    for seed in range(4):
        _assert_same_draws(tdg.gen_kernel, jdg.gen_kernel, seed)
        _assert_same_draws(tdg.gen_kernel, jdg.gen_kernel, seed, (11, 11), (2, 2), 0.6, 5.0, 0.2)
    kern = jdg.fspecial_gaussian(25, 1.2).astype(np.float32)
    for sf in (2, 3, 4):
        for upper_left in (True, False):
            _assert_equal(tdg.shift_pixel(kern, sf, upper_left), jdg.shift_pixel(kern, sf, upper_left))


@pytest.mark.parametrize("sf", [2, 3, 4])
def test_classical_degradation_models_are_bit_equal(sf):
    img = _img((48, 48, 3), 2)
    k = jdg.anisotropic_gaussian(9, 0.5, 2.0, 4.0)
    _assert_equal(tdg.bicubic_degradation(img, sf), jdg.bicubic_degradation(img, sf))
    for name in ("srmd_degradation", "dpsr_degradation", "classical_degradation"):
        _assert_equal(getattr(tdg, name)(img, k, sf), getattr(jdg, name)(img, k, sf))


@pytest.mark.parametrize("name,args", [
    ("add_blur", {"sf": 1}), ("add_blur", {"sf": 4}), ("add_resize", {"sf": 2}),
    ("add_resize", {"sf": 4}), ("add_gaussian_noise", {}), ("add_gaussian_noise", {"noise_level1": 1,
                                                                                    "noise_level2": 6}),
    ("add_speckle_noise", {}), ("add_poisson_noise", {}), ("add_jpeg_noise", {}),
    ("add_sharpening", {}), ("add_sharpening", {"weight": 0.8, "radius": 10, "threshold": 3}),
])
def test_stochastic_ops_draw_the_same_and_give_the_same_bits(name, args):
    """Eight seeds each, so that every branch of an op's draws is taken."""
    img = _img((40, 44, 3), 3)
    for seed in range(8):
        _assert_same_draws(getattr(tdg, name), getattr(jdg, name), seed, img, **args)


def test_random_crop_is_bit_equal():
    lq, hq = _img((24, 28, 3), 4), _img((96, 112, 3), 5)
    for seed in range(4):
        _assert_same_draws(tdg.random_crop, jdg.random_crop, seed, lq, hq, 4, 16)


@pytest.mark.parametrize("name,kw", [
    ("degradation_bsrgan", {"sf": 2, "lq_patchsize": 32}),
    ("degradation_bsrgan", {"sf": 4, "lq_patchsize": 16}),
    ("degradation_bsrgan_plus", {"sf": 4, "lq_patchsize": 16}),
    ("degradation_bsrgan_plus", {"sf": 2, "lq_patchsize": 32, "shuffle_prob": 0.0, "use_sharp": False}),
])
def test_composite_pipelines_are_bit_equal(name, kw):
    """The shuffled BSRGAN chains on a 96x96 image, four seeds each: the same
    LQ / HQ crops and the same draws."""
    img = _img((96, 96, 3), 6)
    for seed in range(4):
        _assert_same_draws(getattr(tdg, name), getattr(jdg, name), seed, img, **kw)
    lq, hq = _seeded(getattr(tdg, name), 0, img, **kw)[0]
    assert lq.shape == (kw["lq_patchsize"],) * 2 + (3,) and hq.shape == (kw["lq_patchsize"] * kw["sf"],) * 2 + (3,)


def test_the_toolbox_refuses_a_small_image():
    for fn in (tdg.degradation_bsrgan, tdg.degradation_bsrgan_plus):
        with pytest.raises(ValueError, match="too small"):
            fn(_img((40, 40, 3)), sf=4, lq_patchsize=16)


def _run(args, cwd, env=None):
    done = subprocess.run(args, cwd=cwd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})
    assert done.returncode == 0, done.stderr[-2000:]
    return done


# The port's generator, run where `jax` and `wavemamba_tpu` cannot be imported.
_NO_JAX = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['wavemamba_tpu'] = None\n"
    "sys.argv = ['make_proc_dataset'] + sys.argv[1:]\n"
    "runpy.run_module('wavemamba_torch.scripts.make_proc_dataset', run_name='__main__')\n"
    "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'wavemamba_tpu')"
    " and sys.modules[m] is not None]\n")


@pytest.mark.parametrize("bsrgan", [True, False])
def test_the_generator_writes_the_jax_scripts_bytes_without_jax(tmp_path, bsrgan):
    """`python -m wavemamba_torch.scripts.make_proc_dataset` with `jax` and
    `wavemamba_tpu` unimportable, and `scripts/make_proc_dataset.py`, with the
    same arguments on this host: the same files, byte for byte (sha256 of
    each, `scripts/dataset_manifest.py:build_manifest`)."""
    args = ["--n-train", "2", "--n-val", "1", "--size", "64", "--seed", "3"] + (["--bsrgan"] if bsrgan else [])
    _run([sys.executable, "-c", _NO_JAX, "--out", str(tmp_path / "port"), *args], REPO,
         {"PYTHONPATH": REPO})
    _run([sys.executable, os.path.join(REPO, "scripts", "make_proc_dataset.py"),
          "--out", str(tmp_path / "jax"), *args], REPO, {"PYTHONPATH": ""})
    got, want = (build_manifest(str(tmp_path / side))["files"] for side in ("port", "jax"))
    assert len(want) == 6 and got == want
