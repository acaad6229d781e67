"""A/B of the fused-quant W8A8 GEMM's main loop on the card.

    python -m opensora_torch.tools.gemm_fq_ab

Builds ``csrc/int8_matmul_sm90.cu`` as it is and variants made from it by
text edits, each with ``nvcc`` into ``opensora_torch/_build/gemm_fq_ab/``:

- ``shipped``: the source as it is (each K step waits for its products);
- ``pipelined``: wait depth 1 and two register sets of A fragments, the
  step's stage freed one step later, so that the quantize of a step could
  run beside the previous step's products;
- ``no_quantize``: the A fragments are the loaded bf16 bits XORed, no
  rounding (wrong values; the same loads and products);
- ``no_a_reads``: the A fragments are made from registers, no shared-memory
  read of A and no quantize (wrong values; the same products).

It prints each build's ptxas diagnostics (C75xx: wgmma serialized) and
registers, checks that ``shipped`` and ``pipelined`` equal the plain
version in every element at the path's ``linear1`` shape and at a tail
shape, and times every build at ``linear1`` (26484, 3072, 21504) in turns
(in order, then reversed, twice), the card's name and power limit beside.
Needs one NVIDIA GPU with the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from opensora_torch.ops import _build
from opensora_torch.ops import int8_matmul as im

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "int8_matmul_sm90.cu")
BUILD = os.path.join(_build.BUILD_DIR, "gemm_fq_ab")
LINEAR1 = (3 * 8828, 3072, 21504)

_STEP_SHIPPED = """__device__ __forceinline__ void k_step(int kt, int (&acc)[128], uint64_t* full, uint64_t* empty,
                                       const unsigned char* sA, uint32_t sB, int warp, int g, int q,
                                       const float (&inv)[2]) {
  const int st = kt % STAGES;
  mbar_wait(&full[st], (kt / STAGES) & 1);
  uint32_t a[8];
  a_frags(a, sA + st * A_STAGE, warp, g, q, inv);"""
_STEP_PIPELINED = """__device__ __forceinline__ void k_step(int kt, uint32_t (&a)[8], int (&acc)[128], uint64_t* full,
                                       uint64_t* empty, const unsigned char* sA, uint32_t sB, int warp, int g,
                                       int q, const float (&inv)[2]) {
  const int st = kt % STAGES;
  mbar_wait(&full[st], (kt / STAGES) & 1);
  a_frags(a, sA + st * A_STAGE, warp, g, q, inv);"""
_WAIT_SHIPPED = """  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(&empty[st]);
}"""
_WAIT_PIPELINED = """  wgmma_wait<1>();
  fence_regs(acc);
  if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
}"""
_LOOP_SHIPPED = "  for (int kt = 0; kt < n_k; ++kt) k_step(kt, acc, full, empty, sA, sB, warp, g, q, inv_r);\n"
_LOOP_PIPELINED = """  uint32_t a0[8], a1[8];
  for (int kt = 0; kt < n_k; kt += 2) {
    k_step(kt, a0, acc, full, empty, sA, sB, warp, g, q, inv_r);
    if (kt + 1 < n_k) k_step(kt + 1, a1, acc, full, empty, sA, sB, warp, g, q, inv_r);
  }
  wgmma_wait<0>();
  fence_regs(acc);
"""
_QUANT = "        w[s][2 * h + i] = quant4(v, inv[i]);"
_FROM_REGISTERS = "        w[s][2 * h + i] = __float_as_uint(inv[i]) + r * 7 + chunk;"
_LOAD = "        const uint2 v = *reinterpret_cast<const uint2*>(sA + r * A_ROW + ((chunk ^ g) << 4) + 8 * (q & 1));\n"


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"the source no longer holds the text this A/B edits: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants(text: str) -> dict:
    """Name -> (CUDA source, computes the function)."""
    return {
        "shipped": (text, True),
        "pipelined": (_edit(text, [(_STEP_SHIPPED, _STEP_PIPELINED), (_WAIT_SHIPPED, _WAIT_PIPELINED),
                                   (_LOOP_SHIPPED, _LOOP_PIPELINED)]), True),
        "no_quantize": (_edit(text, [(_QUANT, "        w[s][2 * h + i] = v.x ^ v.y;")]), False),
        "no_a_reads": (_edit(text, [(_LOAD + _QUANT, _FROM_REGISTERS)]), False),
    }


def build(name: str, text: str):
    """(ctypes library, ptxas lines worth reading)."""
    os.makedirs(BUILD, exist_ok=True)
    src, lib = os.path.join(BUILD, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(SOURCE), "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    report = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "C75" in line or "registers" in line or "spill" in line]
    cdll = ctypes.CDLL(lib)
    cdll.w8a8_fq_matmul.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    cdll.w8a8_fq_matmul.restype = ctypes.c_int
    cdll.int8_matmul_sm90_error_string.argtypes = [ctypes.c_int]
    cdll.int8_matmul_sm90_error_string.restype = ctypes.c_char_p
    return cdll, report


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


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_fq_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(SOURCE) as f:
        builds = {name: (*build(name, text), exact) for name, (text, exact) in variants(f.read()).items()}
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(m, k, n):
        x = (torch.randn((m, k), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        sw = torch.rand((n,), generator=gen, device=dev) * 1e-2 + 1e-3
        return (x, w, sw, *im.fq_inputs(x))

    for name, (lib, report, exact) in builds.items():
        print(f"[ab] {name}: " + " | ".join(report), flush=True)
        if not exact:
            continue
        im._libs[im.SOURCE_FQ] = lib
        for shape in (LINEAR1, (1000, 3072, 200)):
            x, w, sw, s_a, inv = inputs(*shape)
            for dt in (torch.float32, torch.bfloat16):
                got = im.fq_kernel(x, w, sw, s_a, inv, dt)
                n_diff = int((got != im.w8a8_fusedquant_matmul_ref(x, w, sw, dt)).sum())
                print(f"[ab] {name} {shape} {dt}: elements differing from the plain version {n_diff}", flush=True)
                if n_diff:
                    raise AssertionError(f"{name} disagrees with the plain version")
            del x, w, sw, s_a, inv
    x, w, sw, s_a, inv = inputs(*LINEAR1)
    names = list(builds)
    turns = {name: [] for name in names}
    for order in (names, names[::-1]) * 2:
        for name in order:
            im._libs[im.SOURCE_FQ] = builds[name][0]
            turns[name].append(time_ms(lambda: im.fq_kernel(x, w, sw, s_a, inv)))
    im._libs.pop(im.SOURCE_FQ, None)
    for name, t in turns.items():
        print(f"[ab] {name}: linear1 {LINEAR1} ms mean {sum(t) / len(t):.3f} range {min(t):.3f}-{max(t):.3f} "
              f"({len(t)} readings of 10 launches)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
