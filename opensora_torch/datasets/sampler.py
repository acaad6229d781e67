"""Batch samplers with mid-epoch resume (counterpart of
opensora_tpu/datasets/sampler.py; upstream opensora/datasets/sampler.py).

``VariableVideoBatchSampler`` assigns every row to a bucket with draws
seeded by (seed + epoch), pads or drops each bucket to a multiple of its
batch size, shuffles within buckets and the order of bucket accesses, and
yields "idx-T-H-W" indices that carry the bucket's shape to the dataset.
The batches equal the JAX package's for the same table and seed. Its
``last_micro_batch_access_index`` survives a checkpoint.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, Iterator, List

import numpy as np

from opensora_torch.datasets.bucket import Bucket


def _num(val, default: float) -> float:
    """A numeric cell, ``default`` where it is empty, NaN or not a number."""
    try:
        f = float(val)
    except (TypeError, ValueError):
        return default
    return default if f != f else f


class StatefulDistributedSampler:
    """Index sampler with a resumable start offset."""

    def __init__(self, dataset_size: int, num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.start_index = 0
        self.num_samples = dataset_size // num_replicas if drop_last else -(-dataset_size // num_replicas)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.dataset_size)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        if self.drop_last:
            idx = idx[: self.num_samples * self.num_replicas]
        else:
            pad = self.num_samples * self.num_replicas - len(idx)
            if pad > 0:
                idx = np.concatenate([idx, idx[:pad]])
        return iter(idx[self.rank:: self.num_replicas][self.start_index:].tolist())

    def __len__(self) -> int:
        return self.num_samples - self.start_index

    def reset(self):
        self.start_index = 0

    def state_dict(self, step: int) -> dict:
        return {"start_index": step}

    def load_state_dict(self, state: dict):
        self.start_index = state.get("start_index", 0)


class VariableVideoBatchSampler:
    """Bucketed variable-shape batch sampler."""

    def __init__(self, dataset, bucket_config: dict, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False, *, spatial_compression: int, **_):
        self.dataset = dataset
        self.bucket = Bucket(bucket_config, spatial_compression)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.last_micro_batch_access_index = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def group_by_bucket(self) -> Dict[tuple, List[int]]:
        groups: Dict[tuple, List[int]] = defaultdict(list)
        seed = self.seed + self.epoch
        fps_max = getattr(self.dataset, "fps_max", 16)
        for i, row in enumerate(self.dataset.data):
            bucket_id = self.bucket.get_bucket_id(
                int(_num(row.get("num_frames", 1), 1) or 1), int(row["height"]), int(row["width"]),
                _num(row.get("fps", 0), 0.0), path=row.get("path"),
                seed=seed + i * self.bucket.num_bucket, fps_max=fps_max,
            )
            if bucket_id is not None:
                groups[bucket_id].append(i)
        return groups

    def __iter__(self) -> Iterator[List[str]]:
        groups = self.group_by_bucket()
        rng = np.random.default_rng(self.seed + self.epoch)
        counts: Dict[tuple, int] = OrderedDict()
        for bucket_id in list(groups):
            data_list = groups[bucket_id]
            bs = self.bucket.get_batch_size(bucket_id)
            remainder = len(data_list) % bs
            if remainder:
                data_list = data_list[:-remainder] if self.drop_last else data_list + data_list[: bs - remainder]
            if self.shuffle:
                data_list = [data_list[i] for i in rng.permutation(len(data_list))]
            groups[bucket_id] = data_list
            counts[bucket_id] = len(data_list) // bs

        order = [bucket_id for bucket_id, n in counts.items() for _ in range(n)]
        if self.shuffle:
            order = [order[i] for i in rng.permutation(len(order))]
        remainder = len(order) % self.num_replicas
        if remainder:
            order = order[:-remainder] if self.drop_last else order + order[: self.num_replicas - remainder]

        num_iters = len(order) // self.num_replicas
        start_iter = self.last_micro_batch_access_index // self.num_replicas
        # the resume point, renormalized for a possibly changed world size
        self.last_micro_batch_access_index = start_iter * self.num_replicas
        consumed: Dict[tuple, int] = {}
        for bucket_id in order[: self.last_micro_batch_access_index]:
            consumed[bucket_id] = consumed.get(bucket_id, 0) + self.bucket.get_batch_size(bucket_id)

        for i in range(start_iter, num_iters):
            access = order[i * self.num_replicas:(i + 1) * self.num_replicas]
            self.last_micro_batch_access_index += self.num_replicas
            bounds = []
            for bucket_id in access:
                last = consumed.get(bucket_id, 0)
                bs = self.bucket.get_batch_size(bucket_id)
                bounds.append((last, last + bs))
                consumed[bucket_id] = last + bs
            bucket_id = access[self.rank]
            lo, hi = bounds[self.rank]
            data_list = groups[bucket_id]
            # replica padding repeats accesses without growing the lists: wrap
            micro_batch = [data_list[j % len(data_list)] for j in range(lo, hi)]
            t, h, w = self.bucket.get_thw(bucket_id)
            yield [f"{idx}-{t}-{h}-{w}" for idx in micro_batch]
        self.reset()

    def __len__(self) -> int:
        total = 0
        for bucket_id, samples in self.group_by_bucket().items():
            bs = self.bucket.get_batch_size(bucket_id)
            total += len(samples) // bs if self.drop_last else -(-len(samples) // bs)
        if self.drop_last:
            return total // self.num_replicas
        return -(-total // self.num_replicas)

    def reset(self):
        self.last_micro_batch_access_index = 0

    def state_dict(self, num_steps: int) -> dict:
        """Resume from the next micro-batch."""
        return {"seed": self.seed, "epoch": self.epoch,
                "last_micro_batch_access_index": num_steps * self.num_replicas}

    def load_state_dict(self, state: dict):
        self.seed = state.get("seed", self.seed)
        self.epoch = state.get("epoch", self.epoch)
        self.last_micro_batch_access_index = state.get("last_micro_batch_access_index", 0)


class ShapeGroupedBatchSampler:
    """Batches of one latent shape for a cached-latent table (the rows'
    ``shape`` column), so that collate can stack them; the JAX package's
    batches for the same shapes, seed and replicas
    (opensora_tpu/datasets/sampler.py:323-400). Groups are keyed by
    ``str(shape)`` and taken in sorted order, each shuffled, then the
    batches, by one generator seeded with (seed + epoch). A short tail
    stays short on one replica and is wrap-padded to a full batch with
    more (every replica's batches share a shape at a step), unless
    ``drop_last``; the batch list is wrapped to an equal count a replica."""

    def __init__(self, shapes, batch_size: int, num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.shapes = list(shapes)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.start_index = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batches(self) -> List[List[int]]:
        groups: Dict[str, List[int]] = defaultdict(list)
        for i, shape in enumerate(self.shapes):
            groups[str(shape)].append(i)
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for key in sorted(groups):
            idx = groups[key]
            if self.shuffle:
                idx = [idx[j] for j in rng.permutation(len(idx))]
            for s in range(0, len(idx), self.batch_size):
                b = idx[s:s + self.batch_size]
                if len(b) < self.batch_size:
                    if self.drop_last:
                        continue
                    if self.num_replicas > 1:  # padded from the group, cycling it where it is smaller than a batch
                        need = self.batch_size - len(b)
                        b = b + (idx * (need // len(idx) + 1))[:need]
                batches.append(b)
        if self.shuffle:
            batches = [batches[j] for j in rng.permutation(len(batches))]
        per_rank = -(-len(batches) // self.num_replicas)
        batches = batches + batches[:per_rank * self.num_replicas - len(batches)]
        return batches[self.rank::self.num_replicas]

    def __iter__(self) -> Iterator[List[int]]:
        yield from self._batches()[self.start_index:]
        self.start_index = 0

    def __len__(self) -> int:
        return len(self._batches()) - self.start_index

    def state_dict(self, step: int) -> dict:
        return {"start_index": step}

    def load_state_dict(self, state: dict):
        self.start_index = state.get("start_index", 0)
