"""A/B of the D = 512 flash-attention forward and backward against another checkout's.

    python -m opensora_torch.tools.flash_ab --baseline ROOT

ROOT is the root of another checkout of the repository, such as the parent
commit's unpacked from ``git archive`` into the git-ignored ``outputs/``.
Its ``opensora_torch.ops.flash_attention`` is imported beside this one's
(``tools/ab.import_checkout``) and builds its kernels from its own ``csrc``.
At each D = 512 case of ``chip_smoke.py``'s phases 2 and 2d (the
HunyuanVAE mid-block) the tool calls both sides' wrappers on the same
inputs -- the forward ``_flash_forward`` and the backward
``partial_flash_backward``, as the attention Function calls them -- checks
that the two agree within twice the card check's limits (each side is held
to its limit of the plain version by its own ``chip_smoke.py``), and times
them in turns (this, baseline, baseline, this: ROUNDS times) twice: the
whole call (the wrapper's checks, allocations and launches from the host),
and its device time alone (the call captured once in a CUDA graph and
replayed: every kernel and fill of the call, no host work). Prints every
reading, the means and ranges, and the card's name and power limit. Needs
one NVIDIA GPU with the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from opensora_torch.ops import flash_attention as fa
from opensora_torch.tools import ab

ROUNDS = 3
# the card check's limits (chip_smoke.py): out of max|ref|, LSE absolute,
# each gradient of max|ref|; two sides each within one of the truth lie
# within twice it of each other
OUT_RTOL, LSE_TOL, BWD_RTOL = 8e-3, 1e-3, 1e-2
# (name, (B, H, Lq, D), causal_block, q scale, Lk or None)
FWD_CASES = [
    ("vae_mid_tile_24x32", (1, 1, 33 * 768, 512), 768, 1.0, None),  # the 256px decode's spatial tiles
    ("vae_mid_tile_24x18", (1, 1, 33 * 432, 512), 432, 1.0, None),
    ("vae_train_mid_33x256x256", (1, 1, 9216, 512), 1024, 1.0, None),  # HunyuanVAE training, latent 9x32x32
    ("vae_mid_tile_768px", (1, 1, 33 * 1024, 512), 1024, 1.0, None),  # the 768px decode's full tile
    ("tail_frame_causal", (1, 2, 1000, 512), 96, 1.0, None),
    ("bidirectional_anchored", (2, 2, 1000, 512), None, 0.5, None),  # A ~ 20
    ("bidirectional_running_max", (2, 2, 1000, 512), None, 4.0, None),  # A >= 40
    ("lq_ne_lk", (1, 2, 700, 512), None, 1.0, 1000),
]
# (name, (B, H, Lq, D), causal_block, Lk or None)
BWD_CASES = [
    ("vae_mid_33x256x256", (1, 1, 9216, 512), 1024, None),
    ("tail_frame_causal", (1, 2, 1000, 512), 96, None),
    ("bidirectional_lq_ne_lk", (2, 2, 700, 512), None, 1000),
]


def graphed(fn):
    """(the replay of a CUDA graph holding one call of FN, None), or (None,
    why) where the call cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return graph.replay, None


def compare(kind: str, name: str, fns: dict, iters: int) -> None:
    """Both sides' calls, then their device time, in turns."""
    for side, t in ab.in_turns(fns, fns.__getitem__, ROUNDS, iters).items():
        print(f"[ab] {kind} call {name} {side}: {ab.summary(t)}", flush=True)
    graphs = {side: graphed(fn) for side, fn in fns.items()}
    failed = {side: why for side, (_, why) in graphs.items() if why}
    if failed:
        print(f"[ab] {kind} device {name}: not measured, the call was not captured: {failed}", flush=True)
        return
    for side, t in ab.in_turns(graphs, lambda side: graphs[side][0], ROUNDS, iters).items():
        print(f"[ab] {kind} device {name} {side}: {ab.summary(t)}", flush=True)


def _rel(got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / max(want.float().abs().max().item(), 1e-30)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, help="the root of another checkout of the repository")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    base = ab.import_checkout(args.baseline, "opensora_torch.ops.flash_attention")
    sides = {"this": fa, "baseline": base}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    for name, (b, h, lq, d), cb, qscale, lk in FWD_CASES:
        sm = d ** -0.5
        lk = lk or lq
        q, k, v = randn((b, h, lq, d), qscale), randn((b, h, lk, d)), randn((b, h, lk, d))
        fns = {side: (lambda m=m: m._flash_forward(q, k, v, sm, cb)) for side, m in sides.items()}
        (out, lse), (out_b, lse_b) = fns["this"](), fns["baseline"]()
        rel, lse_err = _rel(out, out_b), (lse - lse_b).abs().max().item()
        print(f"[ab] forward {name} ({b}, {h}, {lq}, {d}) lk={lk} cb={cb} q scale {qscale}: this against the "
              f"baseline out {rel:.3e} of max|.| (limit {2 * OUT_RTOL}), lse {lse_err:.3e} (limit {2 * LSE_TOL})",
              flush=True)
        if not (rel <= 2 * OUT_RTOL and lse_err <= 2 * LSE_TOL):
            raise AssertionError(f"the two forwards disagree at {name}")
        del out, lse, out_b, lse_b
        compare("forward", name, fns, 5 if lq * lk * b * h > 1e8 else 20)
        del q, k, v, fns
        torch.cuda.empty_cache()
    for name, (b, h, lq, d), cb, lk in BWD_CASES:
        sm = d ** -0.5
        lk = lk or lq
        q, do, k, v = randn((b, h, lq, d)), randn((b, h, lq, d)), randn((b, h, lk, d)), randn((b, h, lk, d))
        out, lse = fa._flash_forward(q, k, v, sm, cb)
        delta = (do.float() * out.float()).sum(-1)
        del out
        fns = {side: (lambda m=m: m.partial_flash_backward(q, k, v, do, lse, delta, sm_scale=sm, causal_block=cb))
               for side, m in sides.items()}
        rel = max(_rel(g, g_b) for g, g_b in zip(fns["this"](), fns["baseline"]()))
        print(f"[ab] backward {name} ({b}, {h}, {lq}, {d}) lk={lk} cb={cb}: this against the baseline, worst of "
              f"dq, dk, dv {rel:.3e} of max|.| (limit {2 * BWD_RTOL})", flush=True)
        if not rel <= 2 * BWD_RTOL:
            raise AssertionError(f"the two backwards disagree at {name}")
        compare("backward", name, fns, 5 if lq * lk * b * h > 1e8 else 20)
        del q, k, v, do, lse, delta, fns
        torch.cuda.empty_cache()
    print(ab.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
