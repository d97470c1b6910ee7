"""Filesystem helpers. The counterpart of `wavemamba_tpu/utils/misc.py:scandir`."""

from __future__ import annotations

import os


def scandir(dir_path, suffix=None, recursive=False, full_path=False):
    """Generator over the non-hidden file paths under `dir_path`."""
    if (suffix is not None) and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')
    root = dir_path

    def _scandir(dir_path, suffix, recursive):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                return_path = entry.path if full_path else os.path.relpath(entry.path, root)
                if (suffix is None) or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path, suffix=suffix, recursive=recursive)

    return _scandir(dir_path, suffix=suffix, recursive=recursive)
