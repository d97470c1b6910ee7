"""Generic name -> callable registry. The counterpart of
`wavemamba_tpu/utils/registry.py`: the built-in factories use static maps;
this class lets a user register custom archs, datasets, losses, models and
metrics with a decorator."""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: dict[str, object] = {}

    def register(self, obj=None, *, name: str | None = None):
        if obj is None:  # used as @REG.register() or @REG.register(name=...)
            def deco(fn):
                self._do_register(name or fn.__name__, fn)
                return fn

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name, obj):
        if name in self._map:
            raise KeyError(f"{name!r} already registered in {self._name!r}")
        self._map[name] = obj

    def get(self, name):
        if name not in self._map:
            raise KeyError(f"{name!r} not found in registry {self._name!r}; "
                           f"known: {sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name):
        return name in self._map

    def keys(self):
        return self._map.keys()


DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
