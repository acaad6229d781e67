"""A threaded prefetching loader over a batch sampler (counterpart of
opensora_tpu/datasets/dataloader.py). One background thread decodes the
next batches while the card runs the current step; samples that fail to
load (None) are dropped at collate."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from opensora_torch.datasets.sampler import (ShapeGroupedBatchSampler, StatefulDistributedSampler,
                                             VariableVideoBatchSampler)


def collate_fn_default(samples: List[Optional[dict]]) -> Optional[dict]:
    """Stack dict samples; drop Nones."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    def __init__(self, dataset, batch_sampler, prefetch: int = 2, collate_fn=collate_fn_default):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.prefetch = prefetch
        self.collate_fn = collate_fn

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator[dict]:
        work: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()

        def producer():
            try:
                for indices in self.batch_sampler:
                    work.put(self.collate_fn([self.dataset[i] for i in indices]))
                work.put(done)
            except BaseException as e:  # handed to the consumer, which raises it
                work.put(e)

        threading.Thread(target=producer, daemon=True).start()
        while (item := work.get()) is not done:
            if isinstance(item, BaseException):
                raise item
            if item is not None:
                yield item


class _Batched:
    def __init__(self, sampler, batch_size: int, drop_last: bool):
        self.sampler, self.batch_size, self.drop_last = sampler, batch_size, drop_last

    def __iter__(self):
        buf = []
        for i in self.sampler:
            buf.append(i)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf and not self.drop_last:
            yield buf

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


def prepare_dataloader(dataset, batch_size: Optional[int] = None, bucket_config: Optional[dict] = None,
                       shuffle: bool = True, seed: int = 42, drop_last: bool = False,
                       num_replicas: Optional[int] = None, rank: Optional[int] = None, prefetch: int = 2, *,
                       spatial_compression: int, **_):
    """(dataloader, sampler): bucketed batches when ``bucket_config`` is
    given (sizes snapped to ``spatial_compression``, the config's
    ``ae_spatial_compression``), else batches of one latent shape for a
    table with a ``shape`` column (a latent cache), else fixed-size batches
    of shuffled indices. ``num_replicas``
    and ``rank`` default to the data blocks of the process's mesh
    (``parallel/data.data_replicas``: without a mesh, the process group's;
    one process: 1 and 0), so each data coordinate reads its own part of
    the same epoch's order (opensora_tpu/datasets/dataloader.py:105-108
    reads by process) and the processes of one coordinate, its sp ranks,
    read the same samples."""
    from opensora_torch.parallel.context import get_mesh
    from opensora_torch.parallel.data import data_replicas

    default = data_replicas(get_mesh())
    num_replicas = default["num_replicas"] if num_replicas is None else num_replicas
    rank = default["rank"] if rank is None else rank
    kw = dict(num_replicas=num_replicas, rank=rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
    if bucket_config is not None:
        sampler = VariableVideoBatchSampler(dataset, bucket_config, spatial_compression=spatial_compression, **kw)
        return DataLoader(dataset, sampler, prefetch), sampler
    if batch_size is None:
        raise ValueError("batch_size is required without a bucket_config")
    data = getattr(dataset, "data", None)
    if data is not None and "shape" in getattr(data, "columns", ()):
        sampler = ShapeGroupedBatchSampler([row["shape"] for row in data], batch_size, **kw)
        return DataLoader(dataset, sampler, prefetch), sampler
    sampler = StatefulDistributedSampler(len(dataset), **kw)
    return DataLoader(dataset, _Batched(sampler, batch_size, drop_last), prefetch), sampler
