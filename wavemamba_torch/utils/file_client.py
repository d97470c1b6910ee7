"""Storage backends. The counterpart of `wavemamba_tpu/utils/file_client.py`:
the disk backend only; lmdb and memcached raise."""

from __future__ import annotations


class DiskBackend:
    def get(self, filepath, client_key=None):
        with open(str(filepath), "rb") as f:
            return f.read()

    def get_text(self, filepath):
        with open(str(filepath), "r") as f:
            return f.read()


class FileClient:
    """Facade over a backend; `get(path)` returns the file's bytes."""

    _backends = {"disk": DiskBackend}

    def __init__(self, backend="disk", **kwargs):
        if backend in ("lmdb", "memcached"):
            raise NotImplementedError(f"the {backend} backend is not ported: it waits for ROADMAP "
                                      "queue 1, item 11 (utils/lmdb_util.py, file_client.py)")
        if backend not in self._backends:
            raise ValueError(f"Backend {backend} is not supported. Currently supported ones are "
                             f"{list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key="default"):
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)
