"""``configs/diffusion/train/image.py`` and ``stage1_i2v.py`` on the CPU
against the JAX package -- the configurations that ``chip_smoke.py``
trains in phases 33 and 34:

- both configs parse as the JAX package's do (the condition_config merges
  into stage1.py's in both parsers);
- image.py's buckets: a table of 1024 x 1024, 768 x 768 and 256 x 256
  rows, each row's size picked by the sampler's own draw as phase 33 picks
  its pngs' (``_image_table``), every row's bucket from the port's
  ``Bucket`` equal to the JAX package's on the same size and seed, and both
  packages' samplers yielding one batch of each resolution at the config's
  batch sizes (50, 11, 7);
- stage1_i2v.py's visual conditions: the draws of
  ``choose_mask_conditions`` from the first seed whose draws include
  i2v_loop and i2v_tail (``_i2v_draw_seed``, as phase 34 picks its seed)
  and the masks and conditions built from them, equal to the JAX
  package's;
- one train step of each configuration's kind on a small MMDiT against the
  JAX step: image.py's single frame (t2v, zero condition, the shift of one
  latent frame), and stage1_i2v.py's clips with the drawn loop and tail
  masks (the masked loss), from the same weights, batch and draws.

Tolerances: buckets, batches, draws and masks exact; the step within
``STEP_TOL`` = 1e-4 relative (fp32 sums through a small model, forward and
backward: tests/test_torch_training.py's limit).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest

from opensora_tpu.datasets.bucket import Bucket as JBucket
from opensora_tpu.datasets.sampler import VariableVideoBatchSampler as JSampler
from opensora_tpu.training import diffusion as jdiff
from opensora_tpu.utils import train as jtrain
from opensora_tpu.utils.config import parse_configs as jparse_configs

from opensora_torch.datasets.bucket import Bucket
from opensora_torch.datasets.dataloader import prepare_dataloader
from opensora_torch.datasets.datasets import read_data_file
from opensora_torch.training import diffusion as tdiff
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils import train as ttrain
from opensora_torch.utils.config import ae_spatial_compression, parse_configs
from opensora_torch.utils.sampling import build_img_ids, pack
from opensora_torch.utils.weights import mmdit_state_dict
from test_torch_training import _jax_draws, _jax_model, _port_model
from torch_parity_utils import max_rel_err, one_torch_thread, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
IMAGE = os.path.join(REPO, "configs", "diffusion", "train", "image.py")
I2V = os.path.join(REPO, "configs", "diffusion", "train", "stage1_i2v.py")
STEP_TOL = 1e-4
# phase 34's batch: phase 21's 4 clips of 129 frames, 33 latent frames (4x in time, causal)
I2V_BATCH, I2V_LATENT_T, TIME_COMPRESSION = 4, (129 - 1) // 4 + 1, 4
IMAGE_SIZES = ((1024, 1024), (768, 768), (256, 256))  # high to low, as image.py's buckets are walked

_one_thread = pytest.fixture(autouse=True)(one_torch_thread)


@pytest.mark.parametrize("path", [IMAGE, I2V])
def test_configs_parse_as_jax(monkeypatch, path):
    monkeypatch.delenv("AE_SPATIAL_COMPRESSION", raising=False)
    ours, theirs = parse_configs([path]), jparse_configs([path])
    assert ours.to_dict() == theirs.to_dict()
    if path == IMAGE:
        assert dict(ours.bucket_config) == {"256px": {1: (1.0, 50)}, "768px": {1: (0.5, 11)}, "1024px": {1: (0.5, 7)}}
    else:
        cc = dict(ours.condition_config)
        assert (cc["i2v_head"], cc["i2v_loop"], cc["i2v_tail"]) == (5, 1, 1)


def _image_table(root: str, bucket, seed: int) -> tuple:
    """Rows whose sizes land one batch in each of image.py's buckets: each
    row, in order, takes the largest size whose draw (the row's seed, as
    VariableVideoBatchSampler.group_by_bucket seeds it) lands it in a
    bucket still short of one batch. Returns (the csv's path, each row's
    resolution)."""
    need = {res: bucket.get_batch_size((res, 1)) for res in bucket.bucket_bs}
    rows, landed = [], []
    while any(need.values()):
        i = len(rows)
        for h, w in IMAGE_SIZES:
            res = bucket.get_bucket_id(1, h, w, 0.0, seed=seed + i * bucket.num_bucket)[0]
            if need[res]:
                need[res] -= 1
                rows.append(f"image_{h}x{w}.png,a still image {i},1,{h},{w},0.0")
                landed.append(res)
                break
        else:
            raise AssertionError(f"no size lands row {i} in a bucket still short: {need}")
    path = os.path.join(root, "images.csv")
    with open(path, "w") as f:
        f.write("\n".join(["path,text,num_frames,height,width,fps", *rows]) + "\n")
    return path, landed


def _i2v_draw_seed(condition_config: dict) -> int:
    """The first seed whose draws for phase 34's batch include i2v_loop and
    i2v_tail."""
    for seed in range(1000):
        draws = ttrain.choose_mask_conditions(condition_config, I2V_BATCH, I2V_LATENT_T, TIME_COMPRESSION,
                                              np.random.default_rng(seed))
        if "i2v_loop" in draws and "i2v_tail" in draws:
            return seed
    raise AssertionError("no seed below 1000 draws i2v_loop and i2v_tail")


@pytest.fixture(scope="module")
def image_table(tmp_path_factory):
    cfg = parse_configs([IMAGE])
    bucket = Bucket(cfg.bucket_config, ae_spatial_compression(cfg))
    path, landed = _image_table(str(tmp_path_factory.mktemp("images")), bucket, cfg.seed)
    return cfg, bucket, path, landed


def test_image_rows_land_in_jax_buckets(monkeypatch, image_table):
    cfg, bucket, path, landed = image_table
    monkeypatch.delenv("AE_SPATIAL_COMPRESSION", raising=False)
    jbucket = JBucket(jparse_configs([IMAGE]).bucket_config)
    rows = read_data_file(path)
    for i, row in enumerate(rows):
        seed = cfg.seed + i * bucket.num_bucket
        ours = bucket.get_bucket_id(1, row["height"], row["width"], 0.0, seed=seed)
        assert ours == jbucket.get_bucket_id(1, row["height"], row["width"], 0.0, seed=seed)
        assert ours[0] == landed[i]
    # every resolution, one batch each; the 1024 x 1024 rows reach all three
    assert {r: landed.count(r) for r in set(landed)} == {"256px": 50, "768px": 11, "1024px": 7}
    sizes = {r: {(row["height"], row["width"]) for row, lr in zip(rows, landed) if lr == r} for r in set(landed)}
    assert (1024, 1024) in sizes["1024px"] and (256, 256) in sizes["256px"]


def test_image_batches_equal_jax(monkeypatch, image_table):
    cfg, _, path, _ = image_table
    monkeypatch.delenv("AE_SPATIAL_COMPRESSION", raising=False)

    class JData:
        data = pd.read_csv(path)

    class TData:
        data = read_data_file(path)

        def __len__(self):
            return len(self.data)

    kw = dict(seed=cfg.seed, num_replicas=1, rank=0)
    _, ours = prepare_dataloader(TData(), bucket_config=cfg.bucket_config,
                                 spatial_compression=ae_spatial_compression(cfg), **kw)
    batches = list(ours)
    assert batches == list(JSampler(JData(), jparse_configs([IMAGE]).bucket_config, **kw))
    shapes = sorted((len(b), *(int(v) for v in b[0].split("-")[1:])) for b in batches)
    assert shapes == [(7, 1, 1024, 1024), (11, 1, 768, 768), (50, 1, 256, 256)]


def test_i2v_draws_and_masks_equal_jax():
    cc = dict(parse_configs([I2V]).condition_config)
    seed = _i2v_draw_seed(cc)
    ours = ttrain.choose_mask_conditions(cc, I2V_BATCH, I2V_LATENT_T, TIME_COMPRESSION, np.random.default_rng(seed))
    theirs = jtrain.choose_mask_conditions(cc, I2V_BATCH, I2V_LATENT_T, TIME_COMPRESSION,
                                           np.random.default_rng(seed))
    assert ours == theirs and "i2v_loop" in ours and "i2v_tail" in ours
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((I2V_BATCH, 4, 9, 8, 8)).astype(np.float32)  # the stand-in keeps 4 channels
    latent = rng.standard_normal((I2V_BATCH, 4, I2V_LATENT_T, 4, 4)).astype(np.float32)
    enc = lambda xi: xi[..., ::2, ::2] * 2.0  # noqa: E731  (a stand-in encoder, the same in jnp and torch)
    jm, jc = jtrain.build_visual_condition(jnp.asarray(x0), ours, enc, jnp.asarray(latent), TIME_COMPRESSION)
    tm, tc = ttrain.build_visual_condition(t(x0), ours, enc, t(latent), TIME_COMPRESSION)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    head = tm[:, 0, 0, 0, 0].numpy()
    tail = tm[:, 0, -1, 0, 0].numpy()
    for i, mc in enumerate(ours):
        assert (head[i], tail[i]) == ({"i2v_head": (1, 0), "i2v_tail": (0, 1), "i2v_loop": (1, 1)}.get(mc, (0, 0)))


def _batch(masks: np.ndarray, seed: int, T: int, H: int = 4, W: int = 4) -> dict:
    """A train step's inputs for the small MMDiT: latents of T x H x W,
    the visual condition from ``masks`` (B, 1, T, H, W), the shift of that
    latent geometry."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    B = masks.shape[0]
    L = T * (H // 2) * (W // 2)
    cond = np.concatenate([masks, masks * f(B, 4, T, H, W)], axis=1)
    cond = pack(t(cond), patch_size=2).numpy()
    return dict(x0=f(B, L, 16), img_ids=build_img_ids(T, H, W, bs=B).numpy(), txt=f(B, 8, 64),
                txt_ids=np.zeros((B, 8, 3), np.float32), y_vec=f(B, 32), cond=cond, masks=masks,
                shift_alpha=np.full((B,), tdiff.compute_shift_alpha(H, W, T), np.float32),
                null_txt=np.broadcast_to(f(1, 8, 64), (B, 8, 64)).copy(),
                null_vec=np.broadcast_to(f(1, 32), (B, 32)).copy())


def _i2v_masks() -> np.ndarray:
    cc = dict(parse_configs([I2V]).condition_config)
    seed = _i2v_draw_seed(cc)
    conds = ttrain.choose_mask_conditions(cc, I2V_BATCH, I2V_LATENT_T, TIME_COMPRESSION, np.random.default_rng(seed))
    masks = np.zeros((I2V_BATCH, 1, 3, 4, 4), np.float32)
    for i, mc in enumerate(conds):
        masks[i, :, 0] = mc in ("i2v_head", "i2v_loop")
        masks[i, :, -1] = mc in ("i2v_tail", "i2v_loop")
    return masks


@pytest.mark.parametrize("kind", ["image", "i2v"])
def test_train_step_matches_jax(kind):
    """One full-finetune step (the masked loss, clip + AdamW) of the small
    MMDiT on the configuration's kind of batch, from the same weights, batch
    and draws: the loss, the gradient norm and every parameter after."""
    masks = np.zeros((3, 1, 1, 4, 4), np.float32) if kind == "image" else _i2v_masks()
    batch = _batch(masks, seed=6 if kind == "image" else 7, T=masks.shape[2])
    jm, params = _jax_model(seed=7, remat=True, remat_policy="dots")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    prob, rng = 0.5, jax.random.PRNGKey(11)
    opt_kw = dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=0, grad_clip=0.05)
    step_kw = dict(ema_decay=0.9, text_dropout_prob=prob, use_masked_loss=True)
    state = jdiff.TrainState.create(jax.tree.map(jnp.asarray, params), optax.sgd(1.0), ema=False)
    sgd_state, metrics = jax.jit(jdiff.make_train_step(jm, optax.sgd(1.0), **step_kw))(state, jbatch, rng)
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params, to_numpy(sgd_state.params))
    from opensora_tpu.utils import optimizer as jopt

    tx = jopt.create_optimizer(**opt_kw)
    jparams = optax.apply_updates(params, tx.update(jgrads, tx.init(params), params)[0])

    tm = _port_model(params, remat=True, remat_policy="dots")
    opt = topt.create_optimizer([p for p in tm.parameters() if p.requires_grad], **opt_kw)
    tstate = tdiff.TrainState.create(tm, opt, ema=True)
    step = tdiff.make_train_step(tm, **step_kw)
    tmetrics = step(tstate, {k: t(v) for k, v in batch.items()}, draws=_jax_draws(batch, rng, 0, prob))
    assert float(tmetrics["loss"]) == pytest.approx(float(metrics["loss"]), rel=STEP_TOL)
    assert float(tmetrics["grad_norm"]) == pytest.approx(float(metrics["grad_norm"]), rel=STEP_TOL)
    want = mmdit_state_dict(to_numpy(jparams))
    for n, p in tstate.params.items():
        assert max_rel_err(p.detach().numpy(), want[n]) <= STEP_TOL, n
