"""Storage backends (`basicsr/utils/file_client.py`): disk + LMDB +
memcached facade. The counterpart of `wavemamba_tpu/utils/file_client.py`.

LMDB (a C library) and the memcached clients are optional packages: each
backend raises a clear `ImportError` where its package is absent."""

from __future__ import annotations


class DiskBackend:
    def get(self, filepath, client_key=None):
        with open(str(filepath), "rb") as f:
            return f.read()

    def get_text(self, filepath):
        with open(str(filepath), "r") as f:
            return f.read()


class LmdbBackend:
    """Read-only LMDB env per db (`file_client.py:74-130`)."""

    def __init__(self, db_paths, client_keys="default", readonly=True, lock=False,
                 readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("lmdb backend requires the 'lmdb' package") from e
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        assert len(client_keys) == len(db_paths)
        self._client = {}
        for key, path in zip(client_keys, db_paths):
            self._client[key] = lmdb.open(
                str(path), readonly=readonly, lock=lock, readahead=readahead, **kwargs
            )

    def get(self, filepath, client_key):
        client = self._client[client_key]
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))

    def get_text(self, filepath):
        raise NotImplementedError


class MemcachedBackend:
    """Memcached storage (`file_client.py:22-55`): py014 `mc` client if
    present (the reference's cluster client), else `pymemcache`/`pylibmc`
    as widely-available equivalents."""

    def __init__(self, server_list_cfg=None, client_cfg=None, sys_path=None,
                 servers=("127.0.0.1:11211",), **kwargs):
        if sys_path is not None:
            import sys

            sys.path.append(sys_path)
        self._mc_pipeline = False
        try:  # the reference's client (`import mc`, file_client.py:34-40)
            import mc

            self._client = mc.MemcachedClient.GetInstance(
                server_list_cfg, client_cfg
            )
            self._buf = mc.pyvector()
            self._mc_pipeline = True
            return
        except ImportError:
            pass
        try:
            if len(servers) > 1:
                # Cluster semantics (the reference's `mc` client shards over
                # its server list): use pymemcache's consistent-hash client.
                from pymemcache.client.hash import HashClient

                pairs = []
                for s in servers:
                    host, _, port = str(s).partition(":")
                    pairs.append((host, int(port or 11211)))
                self._client = HashClient(pairs)
            else:
                from pymemcache.client.base import Client

                host, _, port = str(servers[0]).partition(":")
                self._client = Client((host, int(port or 11211)))
        except ImportError as e:
            raise ImportError(
                "memcached backend requires the 'mc' (pyarrow cluster) or "
                "'pymemcache' package"
            ) from e

    def get(self, filepath, client_key=None):
        if self._mc_pipeline:
            import mc

            self._client.Get(str(filepath), self._buf)
            return mc.ConvertBuffer(self._buf)
        value = self._client.get(str(filepath))
        if value is None:
            raise KeyError(f"memcached: no value for key {filepath!r}")
        return value

    def get_text(self, filepath):
        raise NotImplementedError


class FileClient:
    """Facade (`file_client.py:132-167`)."""

    _backends = {"disk": DiskBackend, "lmdb": LmdbBackend,
                 "memcached": MemcachedBackend}

    def __init__(self, backend="disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} is not supported. Currently supported ones are "
                f"{list(self._backends)}"
            )
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key="default"):
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)
