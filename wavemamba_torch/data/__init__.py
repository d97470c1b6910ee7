"""Datasets and loaders. The counterpart of `wavemamba_tpu/data/`."""

from wavemamba_torch.data.loader import (
    EnlargedSampler,
    ThreadedLoader,
    build_dataloader,
    build_dataset,
    device_prefetch,
)

__all__ = ["EnlargedSampler", "ThreadedLoader", "build_dataloader", "build_dataset",
           "device_prefetch"]
