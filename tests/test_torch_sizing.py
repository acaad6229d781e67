"""Sizes by the config's spatial compression: the port's sanitized
(height, width) and its bucket tables against the JAX package's, for every
config under ``configs/diffusion/``.

The JAX package reads a config's ``ae_spatial_compression`` through the
``AE_SPATIAL_COMPRESSION`` environment variable that its ``parse_configs``
sets (``opensora_tpu/utils/config.py:245-253``); the port passes
``utils.config.ae_spatial_compression(cfg)`` to ``sanitize_sampling_option``
and, through ``prepare_dataloader`` and ``VariableVideoBatchSampler``, to
``Bucket``. Every JAX call here runs under ``monkeypatch``, which sets or
deletes the variable first, so that no 32 outlives its test.

Also: the DC-AE of the high-compression configs, with their own tiles,
encodes a clip of each of the JAX package's 256px training buckets at 32
px a token (4k frames: a 4k + 1-frame bucket does not encode, ROADMAP R11).

Tolerances: sizes, tables and batches exact; the encodes within ``TOL`` =
2e-4 of the output's scale (fp32, sums in another order), as
tests/test_torch_high_compression.py holds them.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.datasets.bucket import Bucket as JBucket
from opensora_tpu.datasets.sampler import VariableVideoBatchSampler as JSampler
from opensora_tpu.models.dc_ae.model import DCAE as JDCAE
from opensora_tpu.utils import sampling as JS
from opensora_tpu.utils.config import parse_configs as jparse_configs

from opensora_torch.datasets.bucket import Bucket
from opensora_torch.datasets.dataloader import prepare_dataloader
from opensora_torch.datasets.datasets import Table
from opensora_torch.utils import sampling as S
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from test_torch_high_compression import TOL, _dcae_pair
from torch_parity_utils import max_rel_err, one_torch_thread, t

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs", "diffusion", "**", "*.py"),
                                                             recursive=True))
HC_TRAIN = os.path.join(REPO, "configs", "diffusion", "train", "high_compression.py")
HC_INF = os.path.join(REPO, "configs", "diffusion", "inference", "high_compression.py")
ENV = "AE_SPATIAL_COMPRESSION"
# the JAX package's 256px training buckets at 32 px a token, one orientation
# of each pair and the square (the transposes tile each side along the other axis)
HC_256PX = [(160, 416), (192, 352), (224, 288), (256, 256), (288, 224), (352, 192), (416, 160)]

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


def jax_parse(monkeypatch, path):
    """The JAX package's parse, its environment variable set from a clean
    slate: deleted first, then written by ``parse_configs`` where the config
    has the key (monkeypatch restores it at the test's end)."""
    monkeypatch.delenv(ENV, raising=False)
    cfg = jparse_configs([path])
    return cfg


def bucket_tables(b) -> dict:
    return dict(hw=b.hw_criteria, t=b.t_criteria, ar=b.ar_criteria, bs={k: dict(v) for k, v in b.bucket_bs.items()},
                probs={k: dict(v) for k, v in b.bucket_probs.items()}, n=b.num_bucket)


@pytest.mark.parametrize("config", CONFIGS)
def test_sizes_and_buckets_equal_jax(monkeypatch, config):
    path = os.path.join(REPO, config)
    jcfg = jax_parse(monkeypatch, path)
    cfg = parse_configs([path])
    assert ae_spatial_compression(cfg) == int(os.environ.get(ENV, 16))
    compared = 0
    for key in ("sampling_option", "sampling_option_t2i"):
        if key not in cfg:
            continue
        opt = S.SamplingOption(**cfg[key])
        if opt.resolution is None and opt.height is None:
            continue  # a plugin's partial option
        popt = S.sanitize_sampling_option(opt, ae_spatial_compression(cfg))
        jopt = JS.sanitize_sampling_option(JS.SamplingOption(**{k: v for k, v in jcfg[key].items()
                                                                 if k != "cfg_batched"}))
        assert (popt.height, popt.width) == (jopt.height, jopt.width), key
        compared += 1
    if cfg.get("bucket_config") is not None:
        ours = Bucket(cfg.bucket_config, ae_spatial_compression(cfg))
        assert bucket_tables(ours) == bucket_tables(JBucket(jcfg.bucket_config))
        compared += 1
    assert compared or "plugins" in config


def test_high_compression_256px_16_9_is_192_by_320(monkeypatch):
    jcfg = jax_parse(monkeypatch, HC_INF)
    assert os.environ[ENV] == "32"
    cfg = parse_configs([HC_INF])
    opt = S.sanitize_sampling_option(S.SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    jopt = JS.sanitize_sampling_option(JS.SamplingOption(**jcfg.sampling_option))
    assert (opt.height, opt.width) == (jopt.height, jopt.width) == (192, 320)
    # 1920 image tokens at patch 1 (6 x 10 a latent frame of 32 frames), not 16 px's 2112
    assert (opt.height // 32) * (opt.width // 32) * (opt.num_frames // 4) == 1920
    # at 16 px a token the same option is 192 x 336
    assert (S.sanitize_sampling_option(S.SamplingOption(**cfg.sampling_option), 16).width) == 336


def test_high_compression_buckets_take_32px_steps(monkeypatch):
    jcfg = jax_parse(monkeypatch, HC_TRAIN)
    cfg = parse_configs([HC_TRAIN])
    ours = Bucket(cfg.bucket_config, ae_spatial_compression(cfg))
    sizes = set(ours.ar_criteria["256px"][129].values())
    assert sizes == set(JBucket(jcfg.bucket_config).ar_criteria["256px"][129].values()) == set(HC_256PX)
    assert all(h % 32 == 0 and w % 32 == 0 for h, w in sizes)


def _table(rng, n=40):
    """Rows of varied sizes, frame counts and fps, as a video table holds them."""
    rows = []
    for i in range(n):
        h, w = [(192, 336), (224, 288), (256, 256), (360, 640), (480, 480), (160, 416), (300, 200)][i % 7]
        rows.append(dict(path=f"v{i}.mp4", text=f"clip {i}", num_frames=int(rng.integers(1, 160)), height=h, width=w,
                         fps=float(rng.choice([8.0, 16.0, 24.0, 30.0]))))
    return rows


@pytest.mark.parametrize("num_replicas,rank", [(1, 0), (2, 1)])
def test_high_compression_bucket_batches_equal_jax(monkeypatch, num_replicas, rank):
    """The training CLI's loader on the config's buckets yields the JAX
    sampler's batches, "idx-T-H-W" with the 32-px sizes."""
    import pandas as pd

    jcfg = jax_parse(monkeypatch, HC_TRAIN)
    cfg = parse_configs([HC_TRAIN])
    rows = _table(np.random.default_rng(3), n=120)
    cols = list(rows[0])

    class JData:
        data = pd.DataFrame(rows)

    class TData:
        data = Table(rows, cols)

        def __len__(self):
            return len(rows)

    kw = dict(num_replicas=num_replicas, rank=rank, seed=5)
    js = JSampler(JData(), jcfg.bucket_config, **kw)
    _, ts = prepare_dataloader(TData(), bucket_config=cfg.bucket_config,
                               spatial_compression=ae_spatial_compression(cfg), **kw)
    ours = list(ts)
    assert ours == list(js) and len(ours) >= 4
    assert all(int(i.split("-")[2]) % 32 == 0 and int(i.split("-")[3]) % 32 == 0 for b in ours for i in b)


@pytest.fixture(scope="module")
def config_tiled_dcae():
    """The configs' DC-AE tiling (256 px, 32 frames, overlap 1/4) at the tiny width."""
    return _dcae_pair(seed=3, use_spatial_tiling=True, use_temporal_tiling=True)


@pytest.mark.parametrize("size", HC_256PX)
def test_dc_ae_encodes_each_32px_bucket_of_256px(config_tiled_dcae, size):
    """R11's open half: each of the JAX package's 256px sizes at 32 px a
    token encodes through the configs' 256-px tiles (stride 192: the last
    tile of 288, 352 and 416 is 96, 160 and 224 px, each a multiple of 32),
    in both packages alike, at 4 frames."""
    jm, params, ae = config_tiled_dcae
    x = np.random.default_rng(sum(size)).uniform(-1, 1, (1, 3, 4) + size).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jm.apply({"params": params}, v, method=JDCAE.encode))(jnp.asarray(x)))
    with torch.no_grad():
        out = ae.encode(t(x)).numpy()
    assert out.shape == ref.shape == (1, 8, 1, size[0] // 32, size[1] // 32)
    assert np.isfinite(out).all() and max_rel_err(out, ref) <= TOL
