"""wavemamba_torch: the PyTorch/CUDA port of wavemamba_tpu for NVIDIA Hopper.

The JAX package `wavemamba_tpu` is the reference; this package imports
neither it nor JAX. Modules mirror its layout (`ops/`, `models/`,
`metrics/`, `utils/`, `data/`, `train/`, `runner.py`, `pipelines/`,
`inference.py`, `deploy.py`). Kernels written by hand for sm_90a live in `csrc/` and are
built at their first launch.
"""

__version__ = "0.3.0"
