"""Read and write the safetensors format without the ``safetensors`` package.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, offsets relative to the end of the header) and the raw
little-endian bytes of every tensor. A sharded checkpoint is a directory of
such files and a ``*.safetensors.index.json`` whose ``weight_map`` names the
file of each tensor.

:class:`SafetensorsFile` reads one tensor at a time straight from the file
into a tensor of its own (``os.preadv``, no intermediate buffer), so a
loader that moves each tensor to its device before reading the next holds
one tensor's bytes on the host, never the file (a memory-mapped read can
raise the process's peak RSS by the file's size, as on a 9p filesystem
even with each tensor's pages dropped after its copy). :class:`Staging`
moves tensors to a card through two pinned chunks in turn, so that reading
one chunk overlaps copying the other. :func:`save_file` streams tensors
from any device one at a time.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16, "I32": torch.int32,
    "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32, "F64": torch.float64,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_SUFFIX = ".safetensors.index.json"


class SafetensorsFile:
    """One safetensors file, open for reading. A truncated file, a header
    that does not parse, a tensor whose byte range disagrees with its dtype
    and shape, or an unknown dtype raises ``ValueError`` naming the file
    (and the tensor)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            header, n, size = self._read_header()
        except BaseException:
            self._f.close()
            raise
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        base = 8 + n
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name}: unknown dtype {info['dtype']!r}")
            dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
            begin, end = info["data_offsets"]
            nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if end - begin != nbytes or begin < 0:
                raise ValueError(f"{path}: {name}: {end - begin} bytes for {info['dtype']} {list(shape)}")
            if base + end > size:
                raise ValueError(f"{path}: {name}: truncated file ({size} bytes, the tensor ends at {base + end})")
            self._entries[name] = (dtype, shape, base + begin, base + end)

    def _read_header(self):
        f, path = self._f, self.path
        size = os.fstat(f.fileno()).st_size
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors file ({size} bytes, no header length)")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: truncated safetensors file (header of {n} bytes, file of {size})")
        try:
            return json.loads(f.read(n)), n, size
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the safetensors header does not parse: {e}") from None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._f.close()

    def keys(self) -> Iterator[str]:
        return iter(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def info(self, name: str) -> Tuple[torch.dtype, Tuple[int, ...]]:
        dtype, shape, _, _ = self._entries[name]
        return dtype, shape

    def byte_range(self, name: str) -> Tuple[int, int]:
        """[begin, end) of the tensor's bytes in the file."""
        return self._entries[name][2:]

    def nbytes(self, name: str) -> int:
        begin, end = self.byte_range(name)
        return end - begin

    def read_into(self, name: str, out: torch.Tensor, start: int = 0) -> torch.Tensor:
        """Read bytes [start, start + out.numel()) of ``name`` into ``out``,
        a contiguous CPU uint8 tensor (pinned memory, for one)."""
        begin, end = self.byte_range(name)
        if out.dtype != torch.uint8 or not out.is_contiguous() or start < 0 or begin + start + out.numel() > end:
            raise ValueError(f"{name}: bytes {start} + {out.numel()} do not lie in its {end - begin}")
        buf = memoryview(out.numpy()) if out.numel() else memoryview(b"")
        done = 0
        while done < out.numel():
            got = os.preadv(self._f.fileno(), [buf[done:]], begin + start + done)
            if got == 0:
                raise ValueError(f"{self.path}: {name}: the file ended while reading it")
            done += got
        return out

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name``, read into CPU memory of its own."""
        dtype, shape = self.info(name)
        out = torch.empty(shape, dtype=dtype)
        self.read_into(name, out.reshape(-1).view(torch.uint8))
        return out


class Staging:
    """Copies tensors from safetensors files to a device through two host
    buffers of ``chunk`` bytes used in turn: a chunk is read into one while
    the other's copy to the card runs (pinned buffers, copies that do not
    wait). Host memory stays at two chunks whatever the tensors' sizes; on
    the CPU the same chunks are copied synchronously."""

    def __init__(self, device, chunk: int = 64 << 20):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._bufs = [torch.empty(chunk, dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        self._done = [None, None] if cuda else None
        self._slot = 0

    def load(self, f: SafetensorsFile, name: str) -> torch.Tensor:
        """The tensor ``name`` of ``f`` on the device."""
        dtype, shape = f.info(name)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        dst = out.reshape(-1).view(torch.uint8)
        chunk = self._bufs[0].numel()
        for lo in range(0, dst.numel(), chunk):
            n = min(chunk, dst.numel() - lo)
            slot, self._slot = self._slot, self._slot ^ 1
            if self._done is not None and self._done[slot] is not None:
                self._done[slot].synchronize()  # the buffer's last copy has left it
            buf = f.read_into(name, self._bufs[slot][:n], lo)
            dst[lo:lo + n].copy_(buf, non_blocking=True)
            if self._done is not None:
                self._done[slot] = torch.cuda.Event()
                self._done[slot].record()
        return out


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    flat = t.detach().reshape(-1).contiguous().cpu()
    return memoryview(flat.view(torch.uint8).numpy()) if flat.numel() else memoryview(b"")


def save_file(tensors: Mapping[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (on any devices, any strides) to ``path``, one
    tensor at a time; returns the bytes written. Tensors are laid out by
    element size, largest first, then by name, so every offset is aligned."""
    items = sorted(tensors.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            f.write(_tensor_bytes(t))
    return 8 + len(blob) + offset


def save_sharded(tensors: Mapping[str, torch.Tensor], directory: str, max_shard_bytes: int,
                 prefix: str = "model") -> list:
    """Write ``tensors`` as ``prefix-0000k-of-0000n.safetensors`` shards of
    at most ``max_shard_bytes`` (a larger tensor gets a shard of its own) and
    ``prefix.safetensors.index.json``, the layout of a sharded Hugging Face
    checkpoint; returns the shard paths."""
    shards, current, size = [], [], 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if current and size + nbytes > max_shard_bytes:
            shards.append(current)
            current, size = [], 0
        current.append(name)
        size += nbytes
    if current:
        shards.append(current)
    os.makedirs(directory, exist_ok=True)
    weight_map, paths, total = {}, [], 0
    for i, names in enumerate(shards):
        fname = f"{prefix}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file({n: tensors[n] for n in names}, os.path.join(directory, fname), {"format": "pt"})
        weight_map.update(dict.fromkeys(names, fname))
        total += sum(tensors[n].numel() * tensors[n].element_size() for n in names)
        paths.append(os.path.join(directory, fname))
    with open(os.path.join(directory, prefix + INDEX_SUFFIX), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return paths
