"""The port's safetensors reader and writer (``opensora_torch.utils.
safetensors_io``, no ``safetensors`` import) against the ``safetensors``
package, and the checkpoint reader (``utils.ckpt.StateDictReader``) over
sharded directories and ``.pt`` files against the JAX package's
``load_torch_state_dict``. Every comparison is exact (bytes are copied,
never converted)."""

import json
import os

import numpy as np
import pytest
import torch

from opensora_tpu.utils.ckpt import load_torch_state_dict as jax_load_torch_state_dict

from opensora_torch.utils.ckpt import StateDictReader, load_torch_state_dict
from opensora_torch.utils.safetensors_io import SafetensorsFile, save_file, save_sharded

st_torch = pytest.importorskip("safetensors.torch")

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8, torch.uint8, torch.int16,
          torch.int32, torch.int64, torch.bool]


def _tensors(dtype, seed=0):
    """A 2-D, a 0-d, an empty and a non-contiguous tensor of ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(7, 10, generator=g) * 50
    if dtype == torch.bool:
        x = x > 0
    return {"w": x.to(dtype), "scalar": x[0, 0].to(dtype), "empty": x[:0, :3].to(dtype),
            "strided": x.to(dtype)[:, ::3].t()}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_package_reads_what_the_port_writes(tmp_path, dtype):
    ts = _tensors(dtype)
    path = str(tmp_path / "port.safetensors")
    save_file(ts, path, metadata={"format": "pt", "seed": 0})
    got = st_torch.load_file(path)
    assert got.keys() == ts.keys() and all(_equal(got[k], ts[k]) for k in ts)
    from safetensors import safe_open

    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt", "seed": "0"}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_port_reads_what_the_package_writes(tmp_path, dtype):
    ts = {k: v.contiguous().clone() for k, v in _tensors(dtype, seed=1).items()}
    path = str(tmp_path / "package.safetensors")
    st_torch.save_file(ts, path, metadata={"format": "pt"})
    got = load_torch_state_dict(path)
    assert got.keys() == ts.keys() and all(_equal(got[k], ts[k]) for k in ts)
    with SafetensorsFile(path) as f:
        assert f.metadata == {"format": "pt"} and f.info("w") == (dtype, (7, 10))


def test_sharded_directory_through_its_index(tmp_path):
    """save_sharded splits by size and writes the index; the reader, the
    package and the JAX package's loader read the same tensors."""
    ts = {f"layer.{i}.weight": torch.randn(16, 8 + i, dtype=torch.float32) for i in range(5)}
    shards = save_sharded(ts, str(tmp_path), max_shard_bytes=1200)  # tensors of 512 ... 768 bytes
    assert [os.path.basename(s) for s in shards] == [f"model-0000{i}-of-00004.safetensors" for i in range(1, 5)]
    with open(tmp_path / "model.safetensors.index.json") as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(ts) and index["metadata"]["total_size"] == sum(
        v.numel() * 4 for v in ts.values())
    ours = load_torch_state_dict(str(tmp_path))
    theirs = jax_load_torch_state_dict(str(tmp_path))
    package = {k: v for s in shards for k, v in st_torch.load_file(s).items()}
    for k, v in ts.items():
        assert _equal(ours[k], v) and _equal(package[k], v)
        np.testing.assert_array_equal(theirs[k], v.numpy())
    with StateDictReader(str(tmp_path)) as reader:
        assert sorted(reader.keys()) == sorted(ts) and reader.nbytes == index["metadata"]["total_size"]


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "state_dict_wrapper"])
def test_pt_file_with_or_without_a_state_dict_wrapper(tmp_path, wrapped):
    ts = {"a.weight": torch.randn(4, 3), "a.bias": torch.randn(4).to(torch.bfloat16), "n": torch.tensor(7)}
    path = str(tmp_path / "model.pt")
    torch.save({"state_dict": ts, "epoch": 3} if wrapped else ts, path)
    ours = load_torch_state_dict(path)
    assert ours.keys() == ts.keys() and all(_equal(ours[k], ts[k]) for k in ts)
    theirs = jax_load_torch_state_dict(path)  # the JAX package upcasts to fp32
    for k in ts:
        np.testing.assert_array_equal(theirs[k], ts[k].float().numpy())


def test_directory_of_bin_shards_and_bare_safetensors(tmp_path):
    """An HF ``pytorch_model-*.bin`` set with its index, and a directory of
    ``.safetensors`` files without one (every file read)."""
    a, b = {"x": torch.randn(3)}, {"y": torch.randn(2, 2)}
    torch.save(a, tmp_path / "pytorch_model-00001-of-00002.bin")
    torch.save(b, tmp_path / "pytorch_model-00002-of-00002.bin")
    (tmp_path / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"weight_map": {"x": "pytorch_model-00001-of-00002.bin", "y": "pytorch_model-00002-of-00002.bin"}}))
    got = load_torch_state_dict(str(tmp_path))
    assert _equal(got["x"], a["x"]) and _equal(got["y"], b["y"])
    bare = tmp_path / "bare"
    bare.mkdir()
    save_file(a, str(bare / "one.safetensors"))
    save_file(b, str(bare / "two.safetensors"))
    got = load_torch_state_dict(str(bare))
    assert _equal(got["x"], a["x"]) and _equal(got["y"], b["y"])


def test_truncated_file_and_unknown_dtype_raise(tmp_path):
    path = str(tmp_path / "x.safetensors")
    save_file({"w": torch.randn(64, 64)}, path)
    data = open(path, "rb").read()
    for n, what in ((4, "no header length"), (20, "header of"), (len(data) - 1, "truncated")):
        bad = str(tmp_path / f"cut{n}.safetensors")
        with open(bad, "wb") as f:
            f.write(data[:n])
        with pytest.raises(ValueError, match=what):
            SafetensorsFile(bad)
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}).encode()
    odd = str(tmp_path / "odd.safetensors")
    with open(odd, "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + b"\0\0")
    with pytest.raises(ValueError, match="unknown dtype 'F8_E4M3'"):
        SafetensorsFile(odd)
    with pytest.raises(FileNotFoundError):
        load_torch_state_dict(str(tmp_path / "missing.safetensors"))
    empty = tmp_path / "empty_dir"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        StateDictReader(str(empty))


def test_writer_streams_from_any_device_and_keeps_offsets_aligned(tmp_path):
    """Tensors of mixed element sizes land on offsets aligned to their
    element size (largest first), so the reader never copies twice."""
    ts = {"b": torch.ones(3, dtype=torch.int8), "a": torch.ones(5, dtype=torch.float64),
          "c": torch.ones(7, dtype=torch.bfloat16)}
    path = str(tmp_path / "mixed.safetensors")
    n = save_file(ts, path)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
    assert (8 + hlen) % 8 == 0
    for k, v in ts.items():
        assert header[k]["data_offsets"][0] % v.element_size() == 0
    assert [k for k, _ in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0])] == ["a", "c", "b"]
