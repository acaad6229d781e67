"""The training CLI's ``profile = dict(start=, end=)`` on the CPU: the
global steps of the window, and only they, are traced into a Chrome trace
under ``<exp_dir>/profile`` (the window of scripts/diffusion/train.py:
362-371: the trace starts before the step taken at ``global_step ==
start`` and stops after the step that brings ``global_step`` to ``end``);
a window the run never opens, or never closes, writes nothing, as the JAX
script's unstarted or unstopped trace writes nothing."""

import json
import logging
import os

import pytest
import torch

from opensora_torch.train import ProfileWindow
from opensora_torch.utils.logger import close_logger
from test_torch_train_cli import REPO, _write_videos


def traced_steps(path: str) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events if e.get("name", "").startswith("train step to global_step")})


def test_train_cli_traces_the_profile_window(tmp_path):
    from opensora_torch import train as train_cli

    csv = _write_videos(str(tmp_path / "videos"), n=6)
    cfg = tmp_path / "cfg.py"
    # 6 videos in one 5-frame bucket at batch 2: three steps; the window is the second
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', 'diffusion', 'train', 'demo.py')!r}]\n"
                   "bucket_config = {'64px': {5: (1.0, 2)}}\nprofile = dict(start=1, end=2)\n")
    out = str(tmp_path / "out")
    try:
        train_cli.main([str(cfg), "--device", "cpu", "--outputs", out, "--dataset.data_path", csv,
                        "--exp_name", "p", "--epochs", "1"])
    finally:
        close_logger()
    exp = os.path.join(out, "p")
    assert os.listdir(os.path.join(exp, "profile")) == ["trace.json"]
    assert traced_steps(os.path.join(exp, "profile", "trace.json")) == ["train step to global_step 2"]
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    assert f"profile written to {exp}/profile" in log and "global_step 3 " in log


@pytest.mark.parametrize("window,steps,written", [
    (dict(start=0, end=3), 3, ["train step to global_step 1", "train step to global_step 2",
                               "train step to global_step 3"]),
    (dict(start=4, end=5), 3, None),  # after the run
    (dict(start=1, end=7), 3, None),  # its end never reached
    (None, 3, None),
])
def test_profile_window_writes_only_a_window_that_closes(tmp_path, caplog, window, steps, written):
    prof = ProfileWindow(window, str(tmp_path), torch.device("cpu"), logging.getLogger("test_profile"))
    global_step = 0
    with caplog.at_level(logging.INFO, logger="test_profile"):
        try:
            for _ in range(steps):
                prof.before_step(global_step)
                with torch.profiler.record_function(f"train step to global_step {global_step + 1}"):
                    torch.ones(4).sum()
                global_step += 1
                prof.after_step(global_step)
        finally:
            prof.close()
    trace = tmp_path / "profile" / "trace.json"
    if written is None:
        assert not trace.exists()
        assert ("its end was not reached" in caplog.text) == (window is not None and window["start"] < steps)
    else:
        assert traced_steps(str(trace)) == written and "profile written" in caplog.text
