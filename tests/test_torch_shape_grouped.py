"""Batches of one latent shape for a latent cache: the port's
``ShapeGroupedBatchSampler`` and the branch of ``prepare_dataloader`` that
picks it (a table with a ``shape`` column and no ``bucket_config``),
against the JAX package's (``opensora_tpu/datasets/sampler.py:323-400``,
``opensora_tpu/datasets/dataloader.py:129-137``).

The batches are held equal, index for index, with 1, 2 and 3 replicas,
shuffle on and off, ``drop_last`` on and off, over two epochs and from a
resume at ``start_index``; the wrap-pad of a short tail with more than one
replica is asserted by itself. Then a cache of two latent shapes, 4 rows,
as ``cnv.cache`` writes it, is read at batch 2 through both packages'
``prepare_dataloader``: the same batches, each of one shape, and the port's
trainer takes a step on each (the loader raised at collate before).

Tolerances: batches exact; the steps' losses finite.
"""

import os

import numpy as np
import pytest
import torch

from opensora_tpu.datasets.dataloader import prepare_dataloader as jprepare_dataloader
from opensora_tpu.datasets.datasets import CachedVideoTextDataset as JCached
from opensora_tpu.datasets.sampler import ShapeGroupedBatchSampler as JSampler

from opensora_torch.datasets.dataloader import prepare_dataloader
from opensora_torch.datasets.datasets import CachedVideoTextDataset, read_data_file
from opensora_torch.datasets.sampler import ShapeGroupedBatchSampler
from opensora_torch.utils.logger import close_logger
from torch_parity_utils import one_torch_thread

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
DEMO = os.path.join(REPO, "configs", "diffusion", "train", "demo.py")
BATCH = 4
# 3 latent shapes in runs of 10, 7 and 1 rows, interleaved as a cache of
# several buckets lists them: full batches, a short tail, a group smaller
# than one batch
SHAPES = ["4x9x24x42"] * 10 + ["4x9x32x32"] * 7 + ["4x1x24x42"]
SHAPES = [SHAPES[i] for i in np.random.default_rng(0).permutation(len(SHAPES))]
LATENT_SHAPES = [(4, 2, 8, 8), (4, 2, 8, 12)]  # demo.py's 4 latent channels (16 / patch 2 x 2)

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


def pair(num_replicas, rank, **kw):
    kw = dict(num_replicas=num_replicas, rank=rank, seed=11, **kw)
    return ShapeGroupedBatchSampler(SHAPES, BATCH, **kw), JSampler(SHAPES, BATCH, **kw)


@pytest.mark.parametrize("num_replicas,rank", [(1, 0), (2, 0), (2, 1), (3, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batches_equal_jax_over_two_epochs(num_replicas, rank, shuffle, drop_last):
    ours, theirs = pair(num_replicas, rank, shuffle=shuffle, drop_last=drop_last)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(ours)
        assert got == list(theirs) and len(ours) == len(theirs) == len(got) > 0
        assert all(len({SHAPES[i] for i in b}) == 1 for b in got)
        if drop_last or num_replicas > 1:
            assert all(len(b) == BATCH for b in got)
    if shuffle:  # the epoch reseeds the draws
        ours.set_epoch(0)
        first = list(ours)
        ours.set_epoch(1)
        assert first != list(ours)


@pytest.mark.parametrize("num_replicas,rank", [(1, 0), (2, 1)])
def test_resume_at_start_index_equals_jax(num_replicas, rank):
    ours, theirs = pair(num_replicas, rank)
    whole = list(ours)
    for s in (ours, theirs):
        s.set_epoch(0)
        s.load_state_dict(s.state_dict(2))
    assert len(ours) == len(theirs) == len(whole) - 2
    assert list(ours) == list(theirs) == whole[2:]
    assert ours.start_index == theirs.start_index == 0 and list(ours) == whole  # the next epoch starts whole


def test_a_short_tail_is_wrap_padded_with_replicas_only():
    one, _ = pair(1, 0, shuffle=False)
    tails = [b for b in one if len(b) < BATCH]
    # the 10-row group's tail of 2, the 7-row group's of 3, the 1-row group's of 1
    assert sorted(len(b) for b in tails) == [1, 2, 3]
    ranks = [pair(4, r, shuffle=False)[0] for r in range(4)]
    batches = [b for s in ranks for b in s]
    assert all(len(b) == BATCH for b in batches)
    single = next(b for b in batches if SHAPES[b[0]] == "4x1x24x42")
    assert len(set(single)) == 1  # a group smaller than a batch cycles its one row
    # 6 batches over 4 replicas: the list wrapped to 8, 2 a replica
    assert [len(s) for s in ranks] == [2] * 4 and len(batches) == 8 == len(list(one)) + 2


def write_cache(root: str, rng) -> str:
    """4 rows of two latent shapes, alternating, with T5 / CLIP rows of
    demo.py's widths, as ``cnv.cache`` writes its ``cache_meta.csv``."""
    lines = ["latent_path,t5_path,clip_path,text,shape"]
    for i in range(4):
        shape = LATENT_SHAPES[i % 2]
        paths = [os.path.join(root, f"{kind}_{i:06d}.npy") for kind in ("lat", "t5", "clip")]
        for p, a in zip(paths, (rng.standard_normal(shape), rng.standard_normal((16, 64)),
                                rng.standard_normal((32,)))):
            np.save(p, a.astype(np.float32))
        lines.append(",".join(paths + [f"clip {i}", "x".join(str(d) for d in shape)]))
    path = os.path.join(root, "cache_meta.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_two_shape_cache_trains_at_batch_2(tmp_path):
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    meta = write_cache(str(tmp_path), np.random.default_rng(1))
    assert "shape" in read_data_file(meta).columns
    loader, sampler = prepare_dataloader(CachedVideoTextDataset(meta), batch_size=2, seed=3, spatial_compression=16)
    _, jsampler = jprepare_dataloader(JCached(meta), batch_size=2, seed=3, num_workers=0)
    assert isinstance(sampler, ShapeGroupedBatchSampler) and isinstance(jsampler, JSampler)
    assert list(sampler) == list(jsampler)
    batches = list(loader)
    assert len(batches) == 2
    assert sorted(tuple(b["video_latents"].shape) for b in batches) == sorted((2,) + s for s in LATENT_SHAPES)
    argv = [DEMO, "--cached_video", "True", "--dataset.type", "cached_video_text", "--dataset.data_path", meta]
    trainer = Trainer(parse_configs(argv), "cpu")
    try:
        start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        for b in batches:
            metrics = trainer.run_batch(b)
            assert np.isfinite(float(metrics["loss"]))
        assert any(not torch.equal(p, start[n]) for n, p in trainer.model.named_parameters())
    finally:
        close_logger()
