"""The reader's staged copy to a device (``safetensors_io.Staging``: chunks
read into two host buffers in turn, each copied without waiting) equals the
file's tensors exactly, across chunk boundaries and buffer reuse; on the
card (marked ``cuda``, skipped here) through pinned buffers, and through
``load_checkpoint`` into a model on the card. JAX-free, so that the card
runs it: ``python -m pytest --noconftest tests/test_torch_staging.py``."""

import pytest
import torch

from opensora_torch.utils.safetensors_io import SafetensorsFile, Staging, save_file

DTYPES = [torch.bfloat16, torch.float32, torch.float16, torch.int8, torch.int64, torch.bool]


def _tensors():
    g = torch.Generator().manual_seed(0)
    out = {}
    for i, dtype in enumerate(DTYPES):
        x = torch.randn(37 + 13 * i, 11, generator=g) * 40
        out[f"t{i}"] = (x > 0) if dtype == torch.bool else x.to(dtype)
    out.update(scalar=torch.tensor(3.5), empty=torch.zeros(0, 4, dtype=torch.bfloat16))
    return out


@pytest.mark.parametrize("chunk", [1, 97, 4096, 1 << 20])
def test_staged_copy_equals_the_file_on_the_cpu(tmp_path, chunk):
    ts = _tensors()
    path = str(tmp_path / "x.safetensors")
    save_file(ts, path)
    staging = Staging("cpu", chunk=chunk)
    with SafetensorsFile(path) as f:
        got = {k: staging.load(f, k) for k in f.keys()}
    assert got.keys() == ts.keys()
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k


@pytest.mark.cuda
def test_staged_copy_and_load_checkpoint_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from opensora_torch.models.mmdit.model import Flux
    from opensora_torch.utils.ckpt import export_mmdit_state_dict

    ts = _tensors()
    path = str(tmp_path / "x.safetensors")
    save_file(ts, path)
    staging = Staging("cuda", chunk=97)
    with SafetensorsFile(path) as f:
        got = {k: staging.load(f, k) for k in f.keys()}
    torch.cuda.synchronize()
    assert all(got[k].is_cuda and torch.equal(got[k].cpu(), v) for k, v in ts.items())
    geom = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0, num_heads=2,
                depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], qkv_bias=True, guidance_embed=True,
                cond_embed=True, attn_backend="xla", dtype="bf16")
    torch.manual_seed(0)
    ref = Flux(**geom, device="cpu")
    mm = str(tmp_path / "mmdit.safetensors")
    save_file(export_mmdit_state_dict(ref, fused=False, rope_convention="interleaved"), mm)
    loaded = Flux(from_pretrained=mm, ckpt_rope_convention="interleaved", **geom, device="cuda")
    want, have = ref.state_dict(), loaded.state_dict()
    assert have.keys() == want.keys() and all(have[k].is_cuda and torch.equal(have[k].cpu(), want[k]) for k in want)


@pytest.mark.parametrize("route", ["read_preadv", "read_staged", "read_mmap"])
def test_ckpt_io_routes_read_the_written_tensors(tmp_path, route):
    """The three routes ``tools/ckpt_io.py`` times read the same tensors
    (here to the CPU), and its RSS sampler sees no negative peak."""
    from opensora_torch.tools import ckpt_io

    ts = _tensors()
    path = str(tmp_path / "x.safetensors")
    save_file(ts, path)
    with ckpt_io.RssSampler() as rss:
        got = getattr(ckpt_io, route)(path, "cpu")
    assert got.keys() == ts.keys() and all(torch.equal(got[k], v) for k, v in ts.items())
    assert rss.peak_above_start >= 0 and rss.start > 0
