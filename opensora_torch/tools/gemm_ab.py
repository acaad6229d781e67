"""A/B of the W8A8 GEMM's schedule on the card.

    python -m opensora_torch.tools.gemm_ab

Builds ``csrc/int8_matmul_sm90.cu`` as it is and variants made from it by
text edits, each with ``nvcc`` into ``opensora_torch/_build/gemm_ab/``:

- ``shipped``: the source as it is (persistent CTAs, grid = SM count; the
  int8 instantiation keeps one product group in flight);
- ``one_tile_a_cta``: grid = the output tiles, each CTA one tile (the
  fused-quant kernel's earlier form; the epilogue no longer overlaps the next
  tile's loads);
- ``int8_wait_depth_0``: the int8 instantiation waits for each stage's
  products before it frees the stage (the fused-quant instantiation's
  wait);
- with ``--baseline DIR`` (the ``csrc`` directory of another checkout, such
  as the parent commit's from ``git archive``), ``baseline``: the entry
  points DIR's sources define -- ``w8a8_fq_matmul`` from
  ``DIR/int8_matmul_sm90.cu`` and ``w8a8_matmul`` from that file or from
  ``DIR/int8_matmul.cu`` -- each built against DIR's own headers.

It prints each build's ptxas registers, spills and C75xx diagnostics (wgmma
serialized), checks that every variant equals the plain versions in every
element at the path's ``linear1`` shape and at a tail shape, and times
``w8a8_matmul`` and the fused-quant kernel of every build at ``linear1``
(26484, 3072, 21504) in turns, one entry point at a time (in order, then
reversed, five times), the card's name and power limit beside. Needs one
NVIDIA GPU with the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import types

import torch

from opensora_torch.ops import _build
from opensora_torch.ops import int8_matmul as im

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "int8_matmul_sm90.cu")
BUILD = os.path.join(_build.BUILD_DIR, "gemm_ab")
LINEAR1 = (3 * 8828, 3072, 21504)
ROUNDS = 5  # each variant is timed 2 * ROUNDS times, in order and reversed

_GRID = "  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);\n"
_GRID_TILES = "  const unsigned grid = (unsigned)tiles;\n"
_WAIT_1 = """    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (kt > 0) mbar_arrive(&empty[(i - 1) % L::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&empty[(it + n_k - 1) % L::STAGES]);
"""
_WAIT_0 = """    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }
"""


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"the source no longer holds the text this A/B edits: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants(text: str) -> dict:
    """Name -> CUDA source."""
    return {
        "shipped": text,
        "one_tile_a_cta": _edit(text, [(_GRID, _GRID_TILES)]),
        "int8_wait_depth_0": _edit(text, [(_WAIT_1, _WAIT_0)]),
    }


def _compile(name: str, text: str, include: str):
    """(ctypes library, ptxas lines worth reading)."""
    os.makedirs(BUILD, exist_ok=True)
    src, lib = os.path.join(BUILD, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", include, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    report = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "C75" in line or "registers" in line or "spill" in line]
    return ctypes.CDLL(lib), report


def build(name: str, sources) -> tuple:
    """(the entry points as the wrapper calls them, ptxas lines): SOURCES are
    (name, text, include dir) compiled one library each; an entry point
    comes from the first library that defines it."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    entries, report = {}, []
    for part, text, include in sources:
        cdll, lines = _compile(part, text, include)
        report += lines
        for fn, n_ptr in (("w8a8_matmul", 5), ("w8a8_fq_matmul", 6)):
            if fn not in entries and hasattr(cdll, fn):
                f = getattr(cdll, fn)
                f.argtypes, f.restype = [vp] * n_ptr + [i] * 4 + [vp], ctypes.c_int
                entries[fn] = f
        for err in ("int8_matmul_sm90_error_string", "int8_matmul_error_string"):
            if "int8_matmul_sm90_error_string" not in entries and hasattr(cdll, err):
                f = getattr(cdll, err)
                f.argtypes, f.restype = [ctypes.c_int], ctypes.c_char_p
                entries["int8_matmul_sm90_error_string"] = f
    return types.SimpleNamespace(**entries), report


def time_ms(fn, iters: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="a csrc directory whose W8A8 entry points to time beside these")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    here = os.path.dirname(SOURCE)
    with open(SOURCE) as f:
        builds = {name: build(name, [(name, text, here)]) for name, text in variants(f.read()).items()}
    if args.baseline:
        parts = []
        for src in ("int8_matmul_sm90.cu", "int8_matmul.cu"):
            path = os.path.join(args.baseline, src)
            if os.path.exists(path):
                with open(path) as f:
                    parts.append((f"baseline_{src[:-3]}", f.read(), os.path.abspath(args.baseline)))
        builds["baseline"] = build("baseline", parts)
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(m, k, n):
        x = (torch.randn((m, k), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        sa = torch.rand((m, 1), generator=gen, device=dev) * 1e-2 + 1e-3
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        sw = torch.rand((n,), generator=gen, device=dev) * 1e-2 + 1e-3
        return (x, x8, sa, w, sw, *im.fq_inputs(x))

    def runs(x, x8, sa, w, sw, s_a, inv):
        return {"w8a8_matmul": (lambda dt=torch.bfloat16: im.w8a8_matmul(x8, w, sa, sw, dt),
                                lambda dt: im.w8a8_matmul_ref(x8, w, sa, sw, dt)),
                "w8a8_fq_matmul": (lambda dt=torch.bfloat16: im.fq_kernel(x, w, sw, s_a, inv, dt),
                                   lambda dt: im.w8a8_fusedquant_matmul_ref(x, w, sw, dt))}

    for name, (lib, report) in builds.items():
        print(f"[ab] {name}: " + " | ".join(report), flush=True)
        im._lib = lib
        for shape in (LINEAR1, (1000, 3072, 200)):
            ins = inputs(*shape)
            for kern, (run, plain) in runs(*ins).items():
                if not hasattr(lib, kern):
                    continue
                for dt in (torch.float32, torch.bfloat16):
                    n_diff = int((run(dt) != plain(dt)).sum())
                    print(f"[ab] {name} {kern} {shape} {dt}: elements differing from the plain version {n_diff}",
                          flush=True)
                    if n_diff:
                        raise AssertionError(f"{name} ({kern}) disagrees with the plain version")
            del ins
    fns = runs(*inputs(*LINEAR1))
    names = list(builds)
    turns = {(name, kern): [] for kern in fns for name in names if hasattr(builds[name][0], kern)}
    # one entry point at a time, so that every reading follows a kernel of
    # the same kind (the card's clock under its power limit depends on what
    # ran just before)
    for kern, (run, _) in fns.items():
        mine = [name for name in names if (name, kern) in turns]
        for order in (mine, mine[::-1]) * ROUNDS:
            for name in order:
                im._lib = builds[name][0]
                turns[(name, kern)].append(time_ms(run))
    im._lib = None
    for (name, kern), t in turns.items():
        print(f"[ab] {name} {kern}: linear1 {LINEAR1} ms mean {sum(t) / len(t):.3f} range "
              f"{min(t):.3f}-{max(t):.3f} ({len(t)} readings of 10 launches; in order: "
              f"{' '.join(f'{v:.3f}' for v in t)})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
