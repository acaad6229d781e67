"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. build every CUDA kernel from the sources in this checkout (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version at the shapes the
     main path gives it, and time kernel, plain version, the PyTorch library
     call that computes the same function, and the card's bound;
  3. check the main path's models at full width on a small input: the
     card's path against the plain path on the CPU;
  4. drive the main path -- 256px 129-frame text-to-video with
     configs/diffusion/inference/256px.py at full width and depth, random
     bf16 weights from a seed -- through prepare_models + api_fn, and check
     the output and the kernels' launch counts.
Then it prints the card's name and power limit, one JSON line with the
kernels' numbers, and last {"ok": true, "device": {...}}.

``--out-dir DIR`` writes the compiler's register/shared-memory report
(build_log.txt) there; ``--profile`` adds a profiled second main-path run
(kernel time by kind, device idle share; with ``--out-dir`` the full table
goes to DIR/profile_main.txt).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs its fp32 plain version on the same bf16 inputs. The output is
# held relative to its own scale: max|out - ref| <= OUT_RTOL * max|ref|.
# Rounding the output to bf16 costs at most 2^-8 of |out| (half an ulp);
# the bf16 P in the PV product adds errors of random sign that stay below
# that for attention spread over many keys. 8e-3 is twice 2^-8. The LSE is
# fp32 on both sides (values ~7-10): 1e-3 absolute. Every case also checks that the
# limits reject known-wrong outputs (see mutant_readings).
OUT_RTOL = 8e-3
LSE_TOL = 1e-3
# the card's bf16 path vs the CPU's fp32 plain path through one double and
# one single block (or the VAE decoder): bf16 rounding of weights and
# activations, ~4e-3 per op, compounded over a dozen chained products
SMALL_TOL = 5e-2

STEPS = 2  # num_steps of the main path, cut from 50 to fit the time limit
# api_fn does not clamp (saving clips). With random weights a little of the
# decoded video lies outside [-1, 1] (0.43 % in the runs that measured it);
# a path that blows up puts most of it there.
OUTSIDE_MAX = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------------
# phase 2: flash attention at the path's shapes
# ----------------------------------------------------------------------


def visible_pairs(lq: int, lk: int, causal_block) -> int:
    """(query, key) pairs the mask lets through, per (b, h)."""
    if causal_block is None:
        return lq * lk
    total = 0
    for f0 in range(0, lq, causal_block):
        rows = min(causal_block, lq - f0)
        total += rows * min(lk, f0 + causal_block)
    return total


def attention_bound(b, h, l, d, causal_block):
    """(least ms on the card, "operations" or "bytes"): the two products over
    the visible pairs at the bf16 peak, or q, k, v read and out, lse written
    once at the memory rate, whichever is longer."""
    flops_s = 4.0 * b * h * d * visible_pairs(l, l, causal_block) / PEAK_BF16_FLOPS
    bytes_s = (2.0 * b * h * d * 4 * l + 4.0 * b * h * l) / PEAK_BYTES
    return 1e3 * max(flops_s, bytes_s), ("operations" if flops_s >= bytes_s else "bytes")


def plain_chunked(fa, q, k, v, causal_block, heads_per_chunk):
    """The plain version over chunks of heads (the full fp32 score tensor of
    the MMDiT shape would be 72 * 8828^2 * 4 B = 22 GB)."""
    outs, lses = [], []
    for h0 in range(0, q.shape[1], heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        o, l = fa.flash_attention_ref(q[:, sl], k[:, sl], v[:, sl], None, causal_block)
        outs.append(o)
        lses.append(l)
    return torch.cat(outs, 1), torch.cat(lses, 1)


def mutant_readings(fa, q, k, v, causal_block, heads_per_chunk, ref_out, ref_lse) -> dict:
    """What the check reads for outputs a faulty kernel could give, as
    (out error / max|ref|, LSE error) against the plain version: V read one
    64-row tile off; the last KV tile (the tail) skipped; for D = 512, the
    output's 128-column slices of the D split swapped."""
    scale = ref_out.abs().max().item()

    def reading(out, lse):
        return ((out - ref_out).abs().max().item() / scale, (lse - ref_lse).abs().max().item())

    l = k.shape[2]
    keep = l - (l % 64 or 64)
    res = {
        "v_tile_shifted": reading(*plain_chunked(fa, q, k, v.roll(64, dims=2), causal_block, heads_per_chunk)),
        "tail_tile_skipped": reading(*plain_chunked(
            fa, q, k[:, :, :keep], v[:, :, :keep], causal_block, heads_per_chunk)),
    }
    if q.shape[-1] > 128:
        res["d_slice_swapped"] = reading(ref_out.roll(128, dims=-1), ref_lse)
    return res


ATTENTION_CASES = [
    # name, (B, H, L, D), causal_block, q scale
    ("mmdit_joint_anchored", (3, 24, 8828, 128), None, 1.0),
    ("mmdit_joint_running_max", (3, 24, 8828, 128), None, 3.0),
    ("vae_mid_tile_24x32", (1, 1, 33 * 768, 512), 768, 1.0),
    ("vae_mid_tile_24x18", (1, 1, 33 * 432, 512), 432, 1.0),
    ("tail_bidirectional", (2, 3, 1000, 128), None, 1.0),
    ("tail_frame_causal", (1, 2, 1000, 512), 96, 1.0),
]


def check_attention(device) -> dict:
    from opensora_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for name, (b, h, l, d), cb, qscale in ATTENTION_CASES:
        shape = (b, h, l, d)
        q = (torch.randn(shape, generator=gen, device=device) * qscale).to(torch.bfloat16)
        k = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        sm_scale = 1.0 / math.sqrt(d)
        anchor = None
        if cb is None:
            anchor = float(fa.anchor_log2(q, k, sm_scale).max())
        out, lse = fa.flash_attention_with_lse(q, k, v, causal_block=cb)
        torch.cuda.synchronize()
        heads_per_chunk = max(1, (1 << 30) // (l * l * 4 * b))
        ref_out, ref_lse = plain_chunked(fa, q, k, v, cb, heads_per_chunk)
        ref_scale = ref_out.abs().max().item()
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = math.isfinite(err_out) and err_out <= OUT_RTOL * ref_scale and err_lse <= LSE_TOL
        mutants = mutant_readings(fa, q, k, v, cb, heads_per_chunk, ref_out, ref_lse)
        caught = all(r_out > OUT_RTOL or r_lse > LSE_TOL for r_out, r_lse in mutants.values())
        del ref_out, ref_lse

        big = l * l * b * h > 1e8
        iters = 5 if big else 20
        ms = time_cuda(lambda: fa.flash_attention_with_lse(q, k, v, causal_block=cb), iters)
        plain_ms = time_cuda(
            lambda: plain_chunked(fa, q, k, v, cb, heads_per_chunk), 1 if big else 3, warmup=0
        )
        mask = None
        if cb is not None:
            idx = torch.arange(l, device=device) // cb
            mask = idx[None, :] <= idx[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_cuda(lambda: sdpa(q, k, v, attn_mask=mask), iters)
        del mask
        bound_ms, bound_by = attention_bound(b, h, l, d, cb)
        case = dict(
            name=name, shape=list(shape), causal_block=cb, anchor_max=anchor,
            branch=("running_max" if cb is not None or not anchor < 40 else "anchored"),
            max_abs_err=err_out, ref_max_abs=ref_scale, rel_err=err_out / ref_scale,
            lse_max_abs_err=err_lse, mutants=mutants, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        )
        cases.append(case)
        wrong = ", ".join(f"{n} ({ro:.2e}, {rl:.2e})" for n, (ro, rl) in mutants.items())
        log(
            f"[kernels] flash_attention_fwd {name} {shape} cb={cb} branch={case['branch']} "
            f"A_max={anchor} out_err={err_out:.3e} = {err_out / ref_scale:.3e} of max|ref| {ref_scale:.3e} "
            f"(tol {OUT_RTOL}) lse_err={err_lse:.3e} (tol {LSE_TOL}) "
            f"wrong outputs (out/max|ref|, lse): {wrong} "
            f"{'rejected' if caught else 'NOT REJECTED'} ms={ms:.3f} bound_ms={bound_ms:.3f} "
            f"plain_ms={plain_ms:.3f} sdpa_ms={library_ms:.3f} {'OK' if ok and caught else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version at {name}")
        if not caught:
            raise AssertionError(f"the limits at {name} do not reject a known-wrong output")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return {"cases": cases}


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------


def check_small_input(device) -> dict:
    """The main path's models at full width on a small input: the card's
    path (bf16 weights, the CUDA kernel at D=128 and at D=512 frame-causal)
    against the port's plain path on the CPU (fp32 copies of the same
    weights, plain attention)."""
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import build_img_ids

    cfg = parse_configs([os.path.join(REPO, "configs", "diffusion", "inference", "256px.py")])
    gen = torch.Generator().manual_seed(1)

    def twins(conf: dict):
        torch.manual_seed(0)
        card = build_module(dict(conf), MODELS, device=device).eval()
        cpu = build_module(dict(conf, dtype="fp32"), MODELS, device="meta").eval()
        cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()}, assign=True)
        return card, cpu  # CPU tensors take the plain attention

    def rel_err(card_out, cpu_out):
        return float((card_out.float().cpu() - cpu_out).abs().max() / cpu_out.abs().max().clamp(min=1.0))

    res = {}
    mcfg = dict(cfg.model, depth=1, depth_single_blocks=1)
    card, cpu = twins(mcfg)
    b, lt = 3, 32
    img_ids = build_img_ids(2, 8, 12, bs=b)  # 2 x 4 x 6 = 48 image tokens
    inputs = dict(
        img=torch.randn(b, 48, mcfg["in_channels"], generator=gen), img_ids=img_ids,
        txt=torch.randn(b, lt, mcfg["context_in_dim"], generator=gen), txt_ids=torch.zeros(b, lt, 3),
        timesteps=torch.rand(b, generator=gen), y_vec=torch.randn(b, mcfg["vec_in_dim"], generator=gen),
        cond=torch.zeros(b, 48, mcfg["in_channels"] + 4), guidance=torch.full((b,), 7.5),
    )
    with torch.inference_mode():
        ref = cpu(**inputs)
        out = card(**{k: v.to(device) for k, v in inputs.items()})
    res["mmdit_1+1_rel_err"] = rel_err(out, ref)
    del card, cpu

    card, cpu = twins(dict(cfg.ae))
    z = torch.randn(1, 16, 2, 4, 4, generator=gen)
    with torch.inference_mode():
        ref = cpu.decode(z)
        out = card.decode(z.to(device))
    res["vae_decode_rel_err"] = rel_err(out, ref)
    del card, cpu
    torch.cuda.empty_cache()
    ok = all(v <= SMALL_TOL for v in res.values())
    log(f"[small] full-width MMDiT depth 1+1 (B=3, 80 tokens) and VAE decode (latent 2x4x4), "
        f"card bf16 + kernel vs CPU fp32 plain: {res} (tol {SMALL_TOL} of the output's scale) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's path disagrees with the plain path on a small input")
    return res


def profile_main_path(api_fn, run_kwargs: dict, out_dir) -> dict:
    """Kernel time by kind over one more main-path run under torch.profiler;
    the full table goes to ``out_dir``/profile_main.txt if given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api_fn(**run_kwargs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = {"flash_attention_fwd": 0.0, "conv (cuDNN)": 0.0, "gemm (cuBLAS)": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = e.key.lower()
        if "flash_fwd_kernel" in name:
            groups["flash_attention_fwd"] += us
        elif any(w in name for w in ("conv", "fprop", "cudnn", "dgrad", "wgrad")):
            groups["conv (cuDNN)"] += us
        elif any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
            groups["gemm (cuBLAS)"] += us
        else:
            groups["other"] += us
    busy_s = sum(groups.values()) / 1e6
    out = {"wall_s": wall_s, "kernel_s": {k: v / 1e6 for k, v in groups.items()},
           "device_idle_share": max(0.0, 1.0 - busy_s / wall_s)}
    if out_dir:
        with open(os.path.join(out_dir, "profile_main.txt"), "w") as f:
            f.write(json.dumps(out) + "\n")
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    log("[profile] " + json.dumps(out))
    return out


def run_main_path(device, profile: bool = False, out_dir=None) -> dict:
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([
        os.path.join(REPO, "configs", "diffusion", "inference", "256px.py"),
        "--sampling_option.num_steps", str(STEPS),
    ])
    log(f"[main] 256px.py at full width and depth; num_steps cut 50 -> {STEPS}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model, ae, t5, clip = prepare_models(cfg, device=device, seed=cfg.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main] models built on {device} in {build_s:.1f} s; MMDiT {n_params / 1e9:.2f}B params")

    api_fn = prepare_api(model, ae, t5, clip)
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option))
    prompt = ["a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score."]

    run_kwargs = dict(opt=opt, cond_type=cfg.cond_type, seed=cfg.seed, text=prompt,
                      channel=cfg.model["in_channels"])
    _build.LAUNCHES.clear()
    timings: dict = {}
    t0 = time.perf_counter()
    x = api_fn(**run_kwargs, timings=timings)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    expect_shape = (1, 3, opt.num_frames, opt.height, opt.width)
    finite = bool(torch.isfinite(x).all())
    lo, hi = float(x.min()), float(x.max())
    outside = float((x.abs() > 1.0).float().mean())
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(
        f"[main] output {tuple(x.shape)} finite={finite} range=[{lo:.3f}, {hi:.3f}] "
        f"outside [-1, 1]: {outside:.4f} (limit {OUTSIDE_MAX}) "
        f"text_encode_s={timings['text_encode_s']:.3f} "
        f"step_s={[round(s, 3) for s in timings['step_s']]} decode_s={timings['decode_s']:.3f} "
        f"total_s={total_s:.3f} peak_mem_gb={peak_gb:.2f}"
    )
    if tuple(x.shape) != expect_shape:
        raise AssertionError(f"output shape {tuple(x.shape)} != {expect_shape}")
    if not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"output not finite, or {outside:.4f} of it outside [-1, 1]")
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    # the 33x24x42 latent decodes as two spatial tiles (24x32, 24x18), each
    # with one mid-block attention
    n_vae = 2
    expect = n_blocks * STEPS + n_vae
    got = launches.get("flash_attention_fwd", 0)
    log(f"[main] flash_attention_fwd launches={got} expected={n_blocks}x{STEPS} MMDiT + {n_vae} VAE")
    if got != expect:
        raise AssertionError(f"flash_attention_fwd launched {got} times, expected {expect}")
    res = dict(launches=launches, text_encode_s=timings["text_encode_s"], step_s=timings["step_s"],
               decode_s=timings["decode_s"], total_s=total_s, peak_mem_gb=peak_gb,
               outside_share=outside, models_build_s=build_s)
    if profile:
        res["profile"] = profile_main_path(api_fn, run_kwargs, out_dir)
    return res


def main(argv) -> int:
    out_dir = argv[argv.index("--out-dir") + 1] if "--out-dir" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from opensora_torch.ops import _build

    seconds, report = _build.build("flash_attention_fwd")
    log(f"[build] flash_attention_fwd: {seconds:.1f} s (0.0: the library of this source was built before)")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "build_log.txt"), "w") as f:
            f.write(report)

    attn = check_attention(device)
    small = check_small_input(device)
    main_res = run_main_path(device, "--profile" in argv, out_dir)
    main_res["small_input"] = small

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    head = attn["cases"][0]  # the MMDiT shape, the main path's hot call
    kernels = [dict(
        name="flash_attention_fwd",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_fwd.cu",
        replaces="opensora_tpu/ops/flash_attention.py:179",
        also_replaces="opensora_tpu/ops/flash_attention.py:247",
        launches=main_res["launches"].get("flash_attention_fwd", 0),
        max_abs_err=max(c["max_abs_err"] for c in attn["cases"]),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        cases=attn["cases"],
    )]
    log("[main] " + json.dumps(main_res))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
