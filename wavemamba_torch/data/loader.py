"""Data loading: sampler, threaded host loader, device prefetch. The
counterpart of `wavemamba_tpu/data/loader.py`.

  * `EnlargedSampler`: an epoch-seeded permutation over an enlarged index
    space, strided by rank.
  * `ThreadedLoader`: batches of a map-style dataset from a thread pool (cv2
    decode and numpy release the GIL), with background prefetch.
  * `device_prefetch`: keeps `depth` batches in flight onto the card: each is
    staged in pinned host memory and copied on a side CUDA stream with
    `non_blocking=True`; the consumer's stream waits on the copy's event, so
    the copy of batch i+1 runs under the step on batch i.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from wavemamba_torch.device import resolve_device


class EnlargedSampler:
    def __init__(self, dataset_size: int, num_replicas: int, rank: int, ratio: int = 1):
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(dataset_size * ratio / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self.epoch)
        indices = rng.permutation(self.total_size)
        indices = (indices % self.dataset_size).tolist()
        return iter(indices[self.rank : self.total_size : self.num_replicas])

    def __len__(self):
        return self.num_samples


def _collate(items: list[dict]):
    """Stack numpy leaves; keep strings/paths as lists."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def _put_or_stop(q, item, stop) -> bool:
    """A bounded put that re-checks `stop`, so a consumer that went away (the
    train loop's break at total_iter) cannot leave a worker blocked on a full
    queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


_EXHAUSTED = object()  # sentinel: the upstream iterator finished


def _background(produce, depth):
    """Iterate `produce()` (a generator function) on a daemon thread, `depth`
    items ahead; an exception there is raised at the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in produce():
                if not _put_or_stop(q, item, stop):
                    return
            _put_or_stop(q, _EXHAUSTED, stop)
        except BaseException as e:  # surfaces at the consumer
            _put_or_stop(q, e, stop)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _EXHAUSTED:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class ThreadedLoader:
    """Iterate batches of a map-style dataset with background prefetch."""

    def __init__(self, dataset, batch_size=1, sampler=None, shuffle=False,
                 num_workers=4, drop_last=False, seed=None, prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self._epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _index_batches(self):
        if self.sampler is not None:
            indices = list(iter(self.sampler))
        elif self.shuffle:
            indices = np.random.RandomState(
                None if self.seed is None else self.seed + self._epoch
            ).permutation(len(self.dataset)).tolist()
        else:
            indices = list(range(len(self.dataset)))
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self):
        batches = self._index_batches()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in batches:
                    yield _collate(list(pool.map(self.dataset.__getitem__, batch_idx)))

        return _background(produce, self.prefetch)


def device_prefetch(iterator, device="cuda", depth=2):
    """Batches of numpy arrays -> batches of tensors on `device`, `depth` of
    them in flight.

    Array leaves (NHWC uint8 or float) become tensors on the device; other
    leaves (paths) pass through. On a CUDA device a worker thread stages each
    array in pinned memory and copies it on a side stream; the consumer's
    current stream waits on the copy's event before the batch is handed out,
    and the tensors are marked as used by that stream. On the CPU the arrays
    are wrapped in place. Order is kept (one worker); a worker's exception is
    raised at the consumer. A CUDA device that is missing raises at the call.
    """
    return _prefetch(iterator, resolve_device(device), depth)


def _prefetch(iterator, dev, depth):
    on_card = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if on_card else None

    def put(batch):
        out = {}
        for k, v in batch.items():
            if not (isinstance(v, np.ndarray) and v.dtype != object):
                out[k] = v
            elif on_card:
                out[k] = torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
            else:
                out[k] = torch.from_numpy(v)
        return out

    def produce():
        for batch in iterator:
            if not on_card:
                yield put(batch), None
                continue
            with torch.cuda.stream(stream):
                staged = put(batch)
                done = torch.cuda.Event()
                done.record(stream)
            yield staged, done

    for staged, done in _background(produce, depth):
        if done is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            for v in staged.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        yield staged


def build_dataset(opt: dict):
    """`{'type': 'PairedImageDataset' | 'SingleImageDataset', ...}` -> dataset."""
    from wavemamba_torch.data.paired_image_dataset import PairedImageDataset, SingleImageDataset

    dmap = {"PairedImageDataset": PairedImageDataset, "SingleImageDataset": SingleImageDataset}
    name = opt["type"]
    if name not in dmap:
        raise KeyError(f"Unknown dataset type {name!r}; known: {sorted(dmap)}")
    return dmap[name](opt)


def build_dataloader(dataset, opt: dict, num_replicas=1, rank=0, sampler=None, seed=None):
    """The loader of a phase: shuffled, whole batches for 'train'; one image
    at a time, in order, otherwise."""
    if opt.get("phase", "val") == "train":
        return ThreadedLoader(dataset, batch_size=opt.get("batch_size_per_gpu", 1),
                              sampler=sampler, shuffle=sampler is None,
                              num_workers=opt.get("num_worker_per_gpu", 4), drop_last=True,
                              seed=seed)
    return ThreadedLoader(dataset, batch_size=1, num_workers=1, shuffle=False)
