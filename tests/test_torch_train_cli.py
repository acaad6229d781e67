"""The port's data layer and training CLI on the CPU: the bucket sampler's
batches and ``read_data_file`` against the JAX package (and pandas) on the
same table, and ``python -m opensora_torch.train`` on the demo config over
small mp4 files for two steps, then resumed from its checkpoint."""

import json
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from opensora_tpu.datasets.sampler import VariableVideoBatchSampler as JSampler

from opensora_torch.datasets.datasets import read_data_file
from opensora_torch.datasets.sampler import VariableVideoBatchSampler
from opensora_torch.utils.logger import close_logger

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _write_table(path, n=40, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        h, w = (int(x) for x in rng.choice([96, 144, 256, 360, 480, 720], 2))
        frames = int(rng.choice([1, 8, 40, 80, 140]))
        fps = "" if frames == 1 else f"{rng.choice([8.0, 24.0, 30.0])}"
        rows.append(f'v{i}.mp4,"clip {i}, with a comma",{h},{w},{frames},{fps}')
    with open(path, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return path


def test_read_data_file_equals_pandas(tmp_path):
    path = _write_table(str(tmp_path / "meta.csv"))
    ours, df = read_data_file(path), pd.read_csv(path)
    assert ours.columns == list(df.columns)
    for row, ref in zip(ours, df.to_dict("records")):
        assert row.keys() == ref.keys()
        for k in row:
            if isinstance(ref[k], float) and np.isnan(ref[k]):
                assert np.isnan(row[k]), k
            else:
                assert row[k] == ref[k] and type(row[k]) is type(ref[k].item() if hasattr(ref[k], "item") else ref[k])
    jl = tmp_path / "meta.jsonl"
    jl.write_text("\n".join(json.dumps(r) for r in [{"path": "a.mp4", "text": "x", "fps": 8.0}, {"path": "b.png"}]))
    rows, ref = read_data_file(str(jl)).rows, pd.read_json(str(jl), lines=True).to_dict("records")
    assert rows[0] == ref[0] and rows[1]["path"] == ref[1]["path"]
    assert np.isnan(rows[1]["fps"]) and np.isnan(ref[1]["fps"])
    with pytest.raises(NotImplementedError, match="parquet"):
        read_data_file(str(tmp_path / "meta.parquet"))


@pytest.mark.parametrize("num_replicas,rank,resume", [(1, 0, 0), (2, 1, 0), (1, 0, 3)])
def test_bucket_sampler_batches_equal_jax(tmp_path, num_replicas, rank, resume):
    path = _write_table(str(tmp_path / "meta.csv"))
    buckets = {"256px": {1: (0.5, 5), 33: ((0.8, 0.5), 3), 129: (1.0, 2)}, "144p": {1: (1.0, 4), 33: (1.0, 3)}}

    class JData:
        data = pd.read_csv(path)

    class TData:
        data = read_data_file(path)

    kw = dict(num_replicas=num_replicas, rank=rank, seed=7)
    js, ts = JSampler(JData(), buckets, **kw), VariableVideoBatchSampler(TData(), buckets, spatial_compression=16, **kw)
    for s in (js, ts):
        s.set_epoch(1)
        s.load_state_dict({"last_micro_batch_access_index": resume * num_replicas})
    ours = list(ts)
    assert ours == list(js) and len(ours) > 3
    assert len(ts) == len(js)


def _write_videos(root, n=8, frames=16, size=96):
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"v{i}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (size, size))
        base = rng.integers(0, 255, (size, size, 3), np.uint8)
        for k in range(frames):
            w.write(np.roll(base, k * 3, axis=1))
        w.release()
        rows.append(f"{path},demo video {i},{size},{size},{frames},8.0")
    csv = os.path.join(root, "meta.csv")
    with open(csv, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return csv


def _losses(exp_dir):
    with open(os.path.join(exp_dir, "log.txt")) as f:
        text = f.read()
    return [float(m) for m in re.findall(r" loss (-?\d+\.\d+|nan)", text)], text


def test_train_cli_demo_two_steps_then_resume(tmp_path):
    from opensora_torch import train as train_cli

    csv = _write_videos(str(tmp_path / "videos"))
    out = str(tmp_path / "out")
    cfg = tmp_path / "cfg.py"
    # 8 videos in one 5-frame bucket at batch 4: two steps an epoch
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', 'diffusion', 'train', 'demo.py')!r}]\n"
                   "bucket_config = {'64px': {5: (1.0, 4)}}\n")
    common = [str(cfg), "--device", "cpu", "--outputs", out, "--dataset.data_path", csv,
              "--warmup_steps", "0", "--lr", "1e-3"]
    try:
        trainer = train_cli.main(common + ["--exp_name", "a", "--epochs", "1"])
    finally:
        close_logger()
    losses, log = _losses(os.path.join(out, "a"))
    assert len(losses) == 2 and np.isfinite(losses).all(), log
    assert trainer.state.step == 2 and trainer.state.ema is not None
    ckpt = os.path.join(out, "a", "epoch0-global_step2")
    assert os.path.exists(os.path.join(ckpt, "state.pt"))

    try:
        resumed = train_cli.main(common + ["--exp_name", "b", "--epochs", "2", "--load", ckpt])
    finally:
        close_logger()
    losses_b, log_b = _losses(os.path.join(out, "b"))
    assert "resumed at epoch 0 step 2" in log_b
    assert np.isfinite(losses_b).all() and "global_step 3 " in log_b
    assert resumed.state.step == 2 + len(losses_b)
    assert resumed.state.optimizer.count == resumed.state.step
    for n, p in trainer.state.params.items():
        assert not torch.equal(p, resumed.state.params[n])  # trained on from the checkpoint


def test_train_cli_writes_its_log_after_a_trainer_was_built_in_the_process(tmp_path):
    """A Trainer built earlier in the process sets the logger up with
    stdout alone; a later ``train.main`` must still attach
    ``<exp_dir>/log.txt`` (the logger once returned early as soon as it had
    any handler, so this order lost the file)."""
    from opensora_torch import train as train_cli
    from opensora_torch.utils.config import parse_configs

    demo = os.path.join(REPO, "configs", "diffusion", "train", "demo.py")
    csv = _write_videos(str(tmp_path / "videos"), n=4)
    out = str(tmp_path / "out")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = [{demo!r}]\nbucket_config = {{'64px': {{5: (1.0, 4)}}}}\n")
    close_logger()
    try:
        train_cli.Trainer(parse_configs([demo]), "cpu")
        train_cli.main([str(cfg), "--device", "cpu", "--outputs", out, "--dataset.data_path", csv,
                        "--warmup_steps", "0", "--exp_name", "c", "--epochs", "1"])
    finally:
        close_logger()
    losses, log = _losses(os.path.join(out, "c"))
    assert len(losses) == 1 and np.isfinite(losses).all(), log
    assert log.count("experiment dir:") == 1


def test_checkpoint_io_keeps_the_newest_and_restores_state(tmp_path):
    from opensora_torch.training.diffusion import TrainState
    from opensora_torch.utils.ckpt import CheckpointIO
    from opensora_torch.utils.optimizer import create_optimizer

    model = torch.nn.Linear(3, 2)
    state = TrainState.create(model, create_optimizer(model.parameters(), lr=0.1), ema=True)
    io = CheckpointIO()
    for gs in (1, 2, 3):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        state.optimizer.step()
        state.step = gs
        io.save(str(tmp_path), state, 0, gs, gs, sampler_state={"start_index": gs}, keep_n_latest=2)
    assert sorted(os.listdir(tmp_path)) == ["epoch0-global_step2", "epoch0-global_step3"]
    fresh = torch.nn.Linear(3, 2)
    restored = TrainState.create(fresh, create_optimizer(fresh.parameters(), lr=0.1), ema=True)
    _, running, sampler_state = io.load(str(tmp_path / "epoch0-global_step3"), restored)
    assert running == {"epoch": 0, "step": 3, "global_step": 3} and sampler_state == {"start_index": 3}
    assert restored.step == 3 and restored.optimizer.count == 3
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p) and torch.equal(restored.ema[n], state.ema[n])


def test_trainer_cached_latent_path(tmp_path):
    """The cached path: precomputed latents and text embeddings go straight
    to the step (a model without cond_embed; with it the JAX package's
    cached path also fails, for want of a visual condition)."""
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    cfg = parse_configs([os.path.join(REPO, "configs", "diffusion", "train", "demo.py"), "--cached_video", "True"])
    trainer = Trainer(cfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {"video_latents": rng.standard_normal((2, 4, 2, 4, 4)).astype(np.float32),
             "text_t5": rng.standard_normal((2, 6, 64)).astype(np.float32),
             "text_clip": rng.standard_normal((2, 32)).astype(np.float32)}
    metrics = trainer.run_batch(batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert trainer.state.step == 1
