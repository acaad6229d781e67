"""Checkpoint file I/O on the card's machine: the port's safetensors writer,
and its reader into the card against a memory-mapped read of the same file.

    python -m opensora_torch.tools.ckpt_io [--gb 4] [--dir DIR] [--rounds 1]

Writes ``--gb`` GB of seeded bf16 tensors (64 MiB each, drawn on the card)
with ``save_file`` into ``--dir`` (default: a temporary directory), then
reads them back into the card in turns (each route once in order, then
once in reverse, ``--rounds`` times): ``preadv`` is ``SafetensorsFile.get``
(one tensor in host memory of its own at a time, then a pageable copy),
``staged`` is the loader's ``Staging`` (64 MiB chunks read into two pinned
buffers in turn, each copied without waiting, so the next read overlaps
the copy), ``mmap`` a copy-on-write mapping of the file viewed by
``torch.frombuffer``, each tensor's pages dropped (``MADV_DONTNEED``) after
its copy. Each read samples the process's resident set every 10 ms. Prints
one JSON line per write and read, checks that every read equals the
written tensors, and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import mmap
import os
import tempfile
import threading
import time

import torch

from opensora_torch.tools.ab import card
from opensora_torch.utils.safetensors_io import SafetensorsFile, Staging, save_file


def rss_bytes() -> int:
    """The process's resident set now (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssSampler:
    """Samples the resident set every ``period`` s while open; ``peak_above_start``
    is the highest sample less the one taken on entry."""

    def __init__(self, period: float = 0.01):
        self.period, self.start, self.peak = period, 0, 0
        self._stop = threading.Event()

    def _run(self):
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self) -> "RssSampler":
        self.start = self.peak = rss_bytes()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())

    @property
    def peak_above_start(self) -> int:
        return self.peak - self.start


def read_preadv(path: str, device) -> dict:
    with SafetensorsFile(path) as f:
        return {k: f.get(k).to(device) for k in f.keys()}


def read_staged(path: str, device) -> dict:
    staging = Staging(device)
    with SafetensorsFile(path) as f:
        return {k: staging.load(f, k) for k in f.keys()}


def read_mmap(path: str, device) -> dict:
    with SafetensorsFile(path) as f:
        entries = {k: (*f.info(k), f.byte_range(k)[0]) for k in f.keys()}
    out = {}
    with open(path, "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
    for k, (dtype, shape, begin) in entries.items():
        if not math.prod(shape):
            out[k] = torch.empty(shape, dtype=dtype, device=device)
            continue
        out[k] = torch.frombuffer(mm, dtype=dtype, count=math.prod(shape), offset=begin).reshape(shape).to(device)
        nbytes = out[k].numel() * out[k].element_size()
        lo, hi = -(-begin // mmap.PAGESIZE) * mmap.PAGESIZE, (begin + nbytes) // mmap.PAGESIZE * mmap.PAGESIZE
        if hi > lo:
            mm.madvise(mmap.MADV_DONTNEED, lo, hi - lo)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=4.0)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    device = torch.device("cuda")
    n = max(1, int(args.gb * 1e9 // (64 << 20)))
    gen = torch.Generator(device=device).manual_seed(0)
    tensors = {f"w{i:04d}": torch.randn(4096, 8192, generator=gen, device=device).to(torch.bfloat16)
               for i in range(n)}
    results = []
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        path = os.path.join(tmp, "probe.safetensors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = save_file(tensors, path)
        seconds = time.perf_counter() - t0
        results.append(dict(op="write", gb=nbytes / 1e9, seconds=seconds, gb_per_s=nbytes / 1e9 / seconds))
        print(json.dumps(results[-1]), flush=True)
        reads = {"preadv": read_preadv, "staged": read_staged, "mmap": read_mmap}
        for order in (list(reads), list(reads)[::-1]) * args.rounds:
            for name in order:
                with RssSampler() as rss:
                    t0 = time.perf_counter()
                    got = reads[name](path, device)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                equal = got.keys() == tensors.keys() and all(torch.equal(got[k], tensors[k]) for k in tensors)
                del got
                results.append(dict(op=f"read_{name}", gb=nbytes / 1e9, seconds=seconds,
                                    gb_per_s=nbytes / 1e9 / seconds,
                                    peak_rss_above_start_gb=rss.peak_above_start / 1e9, equal=equal))
                print(json.dumps(results[-1]), flush=True)
                if not equal:
                    raise AssertionError(f"the {name} read differs from the written tensors")
    print(card(), flush=True)
    return results


if __name__ == "__main__":
    main()
