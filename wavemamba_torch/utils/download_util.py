"""Model and file download helpers. The counterpart of
`wavemamba_tpu/utils/download_util.py`.

Downloads are gated: `load_file_from_url` resolves against a local weights
cache (`WM_WEIGHTS_DIR`, default `~/.cache/wavemamba_torch`) and tries a
network fetch only when the file is not there."""

from __future__ import annotations

import os
from urllib.parse import urlparse


def weights_dir():
    return os.environ.get(
        "WM_WEIGHTS_DIR", os.path.join(os.path.expanduser("~"), ".cache", "wavemamba_torch"))


def load_file_from_url(url, model_dir=None, progress=True, file_name=None):
    """The cached file's path; a file that is not in the cache is fetched
    from `url` (a failed fetch raises `FileNotFoundError`)."""
    model_dir = model_dir or weights_dir()
    os.makedirs(model_dir, exist_ok=True)
    filename = file_name or os.path.basename(urlparse(url).path)
    cached = os.path.abspath(os.path.join(model_dir, filename))
    if os.path.exists(cached):
        return cached
    try:
        from urllib.request import urlretrieve

        print(f'Downloading: "{url}" to {cached}\n', flush=True)
        urlretrieve(url, cached)
        return cached
    except Exception as e:
        raise FileNotFoundError(
            f"{filename} is not in the local weights cache ({model_dir}) and could not be "
            f"downloaded (offline environment?): {e}") from e


def sizeof_fmt(size, suffix="B"):
    from wavemamba_torch.utils.misc import sizeof_fmt as f

    return f(size, suffix)
