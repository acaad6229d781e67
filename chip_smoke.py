"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. build every CUDA kernel source in this checkout (one nvcc per source,
     all started together; sm_90a);
  2. hold each kernel against its plain PyTorch version at the shapes the
     main paths give it -- the flash-attention forward (D = 128: the
     warp-specialised wgmma/TMA kernel flash_attention_fwd_sm90, both
     loops; D = 512: the wgmma/TMA kernel flash_attention_fwd_d512, both
     loops), and (phase 2b) the D = 128 backward: the fused wgmma/TMA
     kernel and its dQ epilogue kernel --
     show that the limits reject known-wrong outputs, and time kernel,
     plain version, the PyTorch library call that computes the same
     function, and the card's bound;
  3. check the main paths' models at full width on a small input: the
     card's bf16 path (kernels) against the plain fp32 path on the CPU, for
     inference and for a LoRA train step (loss and LoRA gradients);
  4. drive the inference path -- 256px 129-frame text-to-video with
     configs/diffusion/inference/256px.py at full width and depth, random
     bf16 weights from a seed -- through prepare_models + api_fn, and check
     the output and the kernels' launch counts;
  5. drive the training path -- configs/diffusion/train/lora.py at full
     width and depth (random bf16 base from seed 42, LoRA r=128,
     remat_policy=full) on seeded 129-frame 256px video batches of 3 --
     through the training CLI's own per-batch body (opensora_torch.train.
     Trainer.run_batch) for 3 steps, and check losses, gradient norms,
     that the LoRA factors move, the exact launch counts and peak memory;
  6. drive the int8 serving path -- configs/diffusion/inference/
     256px_int8attn.py (W8A8 products, int8_qk8 attention) at full width
     and depth, random bf16 weights from seed 42 quantized at build, for 2
     steps, then with --model.quantized w8a8_fq --model.attn_backend int8
     for 1 step -- and check the output and the exact launch counts.
  7. drive HunyuanVAE training -- configs/vae/train/video_dc_ae_disc.py with
     --model.type hunyuan_vae at full width (channels 128/256/512/512,
     latent 16, fp32 master weights under bf16 compute, random from seed
     42), the discriminator from step 0, LPIPS on through random-weight
     VGG16 / LPIPS files written to a temporary directory -- through the VAE
     training CLI's per-batch body (opensora_torch.train_vae.VAETrainer.
     run_batch) for 3 steps on seeded 33-frame 256x256 batches of 1, and
     check finite losses, that the AE and the discriminator move, the exact
     launch counts of the D = 512 flash forward, backward and dQ epilogue
     kernels, and peak memory;
  8. drive DC-AE training -- video_dc_ae_disc.py as it is (dc-ae-f32t4c128,
     full width) -- through the same body for 2 steps on 32-frame 256x256
     batches of 1: finite losses, moving parameters, no kernel launched.
Phase 2c holds the W8A8 GEMMs (the two instantiations of the persistent
int8 wgmma/TMA kernel: w8a8_matmul with an int8 A tile, w8a8_fq_matmul
quantizing bf16 A into the products' fragments; every element equal to the
plain version's at fp32 output, at the path's shapes and at a case whose
rows have abs-max 127 and hold half-integers, so that x * inv falls on
ties) and the int8 attention kernel (wgmma/TMA, both modes, both loops)
against their plain versions, with known-wrong outputs (both GEMMs: one
32-wide K slice dropped, one consumer's rows from the other's; w8a8_matmul:
the int8 A tile read unswizzled; the fused-quant kernel: ties rounded half
away from zero; int8 attention: sk of the neighbouring tile, the tail tile
skipped, and in the int8 mode V's mean not added, v8t not key-permuted and
p_scale from the neighbouring quantization tile) and timings in turns (the
two GEMMs, the fused-quant wrapper and torch._int_mm + rescale; each
attention mode's kernel, its wrapper and bf16 SDPA); phase 1 prints every
kernel's ptxas registers and spills, and fails if any kernel spills;
phase 3b checks the full-width int8 model on a small input against
the CPU's plain int8 path; phase 6 logs the w8a8_fq step time.
Phase 2b holds the fused D = 128 backward (flash_attention_bwd_fused +
flash_attention_bwd_dq_convert) against the plain backward at the MMDiT
shape (3, 24, 8828, 128) and two tails (L = 1000, bidirectional and
frames of 96), with known-wrong gradients (delta left out, sm_scale
missing from dK, the tail tile skipped, one 128-key block's dQ
contribution dropped or added twice, dK/dV from the neighbouring query
tile's dO) and times of the kernel, the epilogue and the whole
partial_flash_backward call.
Phase 2d holds the D = 512 backward (flash_attention_bwd_d512, its dV CTAs
and dK / dQ CTAs in one launch, + flash_attention_bwd_d512_dq_convert)
against the plain backward at the VAE mid-block's shape (1, 1, 9216, 512),
causal_block 1024, at a tail (L = 1000, causal_block 96) and bidirectional
with Lq != Lk, with known-wrong gradients (among them one consumer's
columns from the other's, dV from the previous query tile's P and one
64-key block's dQ adds dropped) and timings;
phase 3c checks one full-width VAE train step on a small clip, card
against the CPU's fp32 plain step.
Phase 2 holds the D = 128 forward to known-wrong outputs aimed at its
design too: one consumer's 64 rows taken from the other consumer's, the
last 128-key tile dropped, and (on a case whose bound A is far above 40)
a running-max head given the anchored loop; and the D = 512 forward to
its own: one consumer's 256 columns taken from the other's, P V with the
previous key tile's P, the row maxima or the row sums not exchanged
between the consumers. Every phase-2 case times the wrapper and SDPA in
turns and logs both ranges.
Phase 2e holds the ring kernels (ring_flash_fwd -- the D = 128 forward's
wgmma/TMA main loop from and to the rank's state -- and the backward hop
ring_flash_bwd_fused -- the fused D = 128 backward's main loop at the hop's
offsets -- with the dQ epilogue flash_attention_bwd_dq_convert once per
rank) against the plain ring at the slice's shape, global
(3, 24, 8828, 128) over 4 logical ranks on the card (2207 tokens a rank),
and at (1, 2, 4000, 128) frame-causal with frames of 96 that the shard
edges cut, with known-wrong rings (the last hop skipped, local offsets, a
middle hop started from the empty state, the loaded row sum given to every
lane of a quad, one consumer's rows from the other's, delta left out, dK/dV
read from the other slot, one (rank, hop)'s dK/dV add dropped) and timings
(the forward's 16 hop launches, the call and SDPA in turns); phase 3d runs the
full-width MMDiT with attn_backend="ring_rdma" over those 4 ranks on a
small input (forward, and a LoRA step's gradients) against the CPU's plain
dense path. Phase 9 (run right after phase 4, on its models) switches
every block to ring_rdma over a mesh of 4 logical ranks on the card and
drives 256px.py through prepare_api(mesh=...) for 2 steps: exact launches,
the video against phase 4's (a control with the last hop skipped must
exceed the limit), then 1 step of attn_backend="ring" (ops/sp.py) against
1 step of ring_rdma. Phase 10 (after phase 5, on its trainer) runs 2 LoRA
steps with ring_rdma over the same mesh: finite loss and gradient norm,
moving factors, exact launches of the ring kernels and the dQ epilogue.
Then it prints the card's name and power limit, one JSON line with the
kernels' numbers, and last {"ok": true, "device": {...}}.

``--out-dir DIR`` writes the compiler's register/shared-memory report
(build_log.txt) there; ``--profile`` adds a profiled second run of each
path (kernel time by kind, device idle share; with ``--out-dir`` the full
tables go to DIR/profile_{main,ring,train,ring_train,int8,vae,dcae}.txt).
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import unittest.mock

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# exp2 on the special-function units: 16 a clock per SM (times SMs and the
# card's maximum SM clock, read at run time)
MUFU_PER_CLOCK_PER_SM = 16

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

# Backward kernels vs the fp32 plain backward on the same bf16 q, k, v, dO
# and the same LSE and delta: each of dq, dk, dv within BWD_RTOL of its own
# scale. P (for dV) and dS (for dK, dQ) are rounded to bf16 before their
# products, as on the TPU, and the outputs once more; a CPU simulation of
# that rounding gives 3e-3 to 6e-3 of max|ref| at L = 2000. Every case also
# checks that the limit rejects known-wrong gradients (bwd_mutant_readings).
BWD_RTOL = 1e-2
# The card's bf16 LoRA train step (kernels) vs the CPU's fp32 plain step,
# full width, 1 + 1 blocks: the loss to SMALL_TOL like the forward; each
# LoRA gradient to TRAIN_GRAD_TOL of its own scale -- the backward runs the
# forward's bf16 chain twice more (the recompute and the transposed
# products), and the factors' gradients are products of the bf16 weight
# gradient.
TRAIN_GRAD_TOL = 1e-1

# W8A8 kernels vs their plain versions (exact integer sums in float64, the
# same fp32 epilogue order): equal in every element at fp32 output.
# Int8 attention vs its plain version on the same bf16 inputs: the same
# quantization; the kernel rounds the bf16 output (and in qk8 mode P to
# bf16) against its own anchors, sums in another order, and in the int8
# mode a P8 value within an ulp of k + 1/2 may round the other way (one int8
# step of one key in one row): held like the bf16 forward, OUT_RTOL of the
# output's scale.
INT8_ATTN_RTOL = OUT_RTOL

STEPS = 2  # num_steps of the inference path, cut from 50 to fit the time limit
INT8_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "256px_int8attn.py")
INT8_FQ_STEPS = 1  # steps of the w8a8_fq / int8 run
TRAIN_STEPS = 3  # LoRA steps of the training path
TRAIN_BATCH = 3  # the 129-frame 256px bucket's batch size (stage1.py)
TRAIN_FRAMES, TRAIN_RESOLUTION, TRAIN_RATIO = 129, "256px", "16:9"
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


def attention_bound(b, h, l, d, causal_block, lk=None):
    """(least ms on the card, "operations" or "bytes"): the two products over
    the visible pairs at the bf16 peak, or q, k, v read and out, lse written
    once at the memory rate, whichever is longer."""
    lk = l if lk is None else lk
    flops_s = 4.0 * b * h * d * visible_pairs(l, lk, causal_block) / PEAK_BF16_FLOPS
    bytes_s = (2.0 * b * h * d * (2 * l + 2 * lk) + 4.0 * b * h * l) / PEAK_BYTES
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


def anchored_loop_chunked(fa, q, k, v, heads_per_chunk):
    """What the anchored loop gives every (b, h), in fp32 with the kernel's
    flush of exp2 below 2^-126 to zero: p = exp2(s c - A), out = p V / l,
    lse = A ln 2 + ln l (l = 0 divides by 1)."""
    sm = 1.0 / math.sqrt(q.shape[-1])
    c = sm * fa.LOG2E
    outs, lses = [], []
    for h0 in range(0, q.shape[1], heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        a2 = fa.anchor_log2(q[:, sl], k[:, sl], sm)[..., None, None]
        x = torch.einsum("bhqd,bhkd->bhqk", q[:, sl].float(), k[:, sl].float()) * c - a2
        p = torch.where(x < -126, torch.zeros_like(x), torch.exp2(x))
        l = p.sum(-1)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v[:, sl].float()) / l_safe[..., None])
        lses.append(a2[..., 0] * math.log(2.0) + torch.log(l_safe))
    return torch.cat(outs, 1), torch.cat(lses, 1)


def mutant_readings(fa, q, k, v, causal_block, heads_per_chunk, ref_out, ref_lse, anchored_mutant=False) -> dict:
    """What the check reads for outputs a faulty kernel could give, as
    (out error / max|ref|, LSE error) against the plain version: V read one
    64-row tile off; the last 64 keys (the tail) skipped; for D = 512, the
    output's 128-column slices swapped (the fault of the split kernel it
    replaced) and the faults of its design (d512_fwd_mutants). For D = 128
    (the wgmma/TMA kernel): one consumer's 64 rows taken from the other's
    (each 128-row CTA's rows 64..127 a copy of rows 0..63), the last 128-key
    tile dropped and, with ``anchored_mutant`` (a case whose bound A lies far
    above 40), every head given the anchored loop: it differs from the
    running max only where exp2(s c - A) flushes to zero (s c - A < -126),
    which on these random inputs needs a bound far above 40, so that fault
    shows only on such a case."""
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
        res["consumer_columns_from_other_consumer"] = reading(
            torch.cat([ref_out[..., :256], ref_out[..., :256]], -1), ref_lse)
        running = causal_block is not None or bool((fa.anchor_log2(q, k, q.shape[-1] ** -0.5) >= 40).any())
        for fault in D512_FWD_FAULTS:
            if fault != "row_max_not_exchanged" or running:  # that fault needs a running-max (b, h)
                res[fault] = reading(*d512_fwd_mutant(fa, q, k, v, causal_block, fault))
    else:
        lq = q.shape[2]
        swap_out, swap_lse = ref_out.clone(), ref_lse.clone()
        for m0 in range(0, lq - 64, 128):
            n = min(64, lq - m0 - 64)
            swap_out[:, :, m0 + 64:m0 + 64 + n] = ref_out[:, :, m0:m0 + n]
            swap_lse[:, :, m0 + 64:m0 + 64 + n] = ref_lse[:, :, m0:m0 + n]
        res["consumer_rows_from_other_consumer"] = reading(swap_out, swap_lse)
        del swap_out, swap_lse
        keep = l - (l % 128 or 128)
        res["last_key_tile_dropped"] = reading(*plain_chunked(
            fa, q, k[:, :, :keep], v[:, :, :keep], causal_block, heads_per_chunk))
        if anchored_mutant:
            res["running_max_head_given_anchored_loop"] = reading(*anchored_loop_chunked(fa, q, k, v,
                                                                                         heads_per_chunk))
    return res


# The D = 512 forward's design faults that d512_fwd_mutant emulates: P V
# with the previous 64-key tile's P (the P buffers' order broken); each
# consumer's P and rescale from its own 32 keys' row maxima (the maxima not
# exchanged: a fault of the running-max loop only, read on the cases with a
# running-max (b, h)); each consumer dividing by its own keys' share of the
# row sum (the sums not exchanged).
D512_FWD_FAULTS = ("p_of_previous_key_tile", "row_max_not_exchanged", "row_sum_not_exchanged")


def d512_fwd_mutant(fa, q, k, v, causal_block, fault, block=64):
    """(out, lse) fp32 of the D = 512 forward's order of work with one of
    D512_FWD_FAULTS (None: no fault), on q's device: all rows of a (b, h)
    at once against 64-key tiles, consumer w computing S for keys 32 w ..
    32 w + 31 of a tile and holding O[:, 256 w ..], each (b, h) in the loop
    its bound A picks."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    sm = 1.0 / math.sqrt(d)
    c = sm * fa.LOG2E
    anchor = fa.anchor_log2(q, k, sm) if causal_block is None else None
    out = torch.empty(b, h, lq, d, device=q.device)
    lse = torch.empty(b, h, lq, device=q.device)
    rows = torch.arange(lq, device=q.device)
    for bi in range(b):
        for hi in range(h):
            anchored = anchor is not None and float(anchor[bi, hi]) < 40.0
            a2 = float(anchor[bi, hi]) if anchored else 0.0
            qf, kf, vf = q[bi, hi].float(), k[bi, hi].float(), v[bi, hi].float()
            m = [torch.full((lq,), fa.NEG_INF, device=q.device) for _ in range(2)]
            l = [torch.zeros(lq, device=q.device) for _ in range(2)]
            o = [torch.zeros(lq, d // 2, device=q.device) for _ in range(2)]
            p_prev = torch.zeros(lq, block, device=q.device)
            for n0 in range(0, lk, block):
                keys = torch.arange(n0, n0 + block, device=q.device)
                s = qf @ torch.nn.functional.pad(kf[n0:n0 + block], (0, 0, 0, n0 + block - min(lk, n0 + block))).T
                ok = (keys < lk)[None, :].expand(lq, -1)
                if causal_block is not None:
                    ok = ok & (keys[None, :] // causal_block <= rows[:, None] // causal_block)
                s = torch.where(ok, s, torch.full_like(s, -math.inf))
                halves = (s[:, :32], s[:, 32:])
                if anchored:
                    ps = [torch.exp2(x * c - a2) for x in halves]
                    corr = [None, None]
                else:
                    mx = [x.amax(-1) for x in halves]
                    if fault != "row_max_not_exchanged":
                        mx = [torch.maximum(mx[0], mx[1])] * 2
                    m_new = [torch.maximum(m[w], mx[w] * c) for w in range(2)]
                    m_safe = [torch.where(x <= fa.NEG_INF * 0.5, torch.zeros_like(x), x) for x in m_new]
                    corr = [torch.exp2(m[w] - m_safe[w]) for w in range(2)]
                    ps = [torch.exp2(halves[w] * c - m_safe[w][:, None]) for w in range(2)]
                    m = m_new
                p = torch.cat(ps, -1)
                p_used = p_prev if fault == "p_of_previous_key_tile" else p
                vt = torch.nn.functional.pad(vf[n0:n0 + block], (0, 0, 0, n0 + block - min(lk, n0 + block)))
                for w in range(2):
                    if corr[w] is not None:
                        l[w], o[w] = l[w] * corr[w], o[w] * corr[w][:, None]
                    l[w] = l[w] + ps[w].sum(-1)
                    o[w] = o[w] + p_used.to(torch.bfloat16).float() @ vt[:, 256 * w:256 * (w + 1)]
                p_prev = p
            total = l[0] + l[1]
            for w in range(2):
                lw = l[w] if fault == "row_sum_not_exchanged" else total
                out[bi, hi, :, 256 * w:256 * (w + 1)] = o[w] / torch.where(lw == 0, torch.ones_like(lw), lw)[:, None]
            l0 = l[0] if fault == "row_sum_not_exchanged" else total
            m0 = torch.full_like(m[0], a2) if anchored else m[0]
            lse[bi, hi] = m0 * math.log(2.0) + torch.log(torch.where(l0 == 0, torch.ones_like(l0), l0))
    return out, lse


ATTENTION_CASES = [
    # name, (B, H, L, D), causal_block, q scale[, Lk]
    ("mmdit_joint_anchored", (3, 24, 8828, 128), None, 1.0),
    ("mmdit_joint_running_max", (3, 24, 8828, 128), None, 3.0),
    ("vae_mid_tile_24x32", (1, 1, 33 * 768, 512), 768, 1.0),
    ("vae_mid_tile_24x18", (1, 1, 33 * 432, 512), 432, 1.0),
    ("vae_train_mid_33x256x256", (1, 1, 9216, 512), 1024, 1.0),  # phase 7's mid-blocks (latent 9 x 32 x 32)
    # the 768px decode's full spatial tile (latent 33 x 32 x 32 of 96 x 170, tile 32, stride 24)
    ("vae_mid_tile_768px", (1, 1, 33 * 1024, 512), 1024, 1.0),
    ("tail_bidirectional", (2, 3, 1000, 128), None, 1.0),
    ("tail_running_max_wide", (2, 3, 1000, 128), None, 8.0),  # A ~ 200: the anchored loop would underflow
    ("tail_frame_causal_d128", (1, 2, 1000, 128), 96, 1.0),
    ("tail_frame_causal", (1, 2, 1000, 512), 96, 1.0),
    ("bidirectional_d512_anchored", (2, 2, 1000, 512), None, 0.5),  # A ~ 20 (at q scale 1 A ~ 40)
    ("bidirectional_d512_running_max", (2, 2, 1000, 512), None, 4.0),  # A >= 40
    ("lq_ne_lk_d512", (1, 2, 700, 512), None, 1.0, 1000),
]
WIDE_ANCHOR = "tail_running_max_wide"


def check_attention(device, attention_cases=ATTENTION_CASES) -> dict:
    from opensora_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for name, (b, h, l, d), cb, qscale, *lk in attention_cases:
        shape, kshape = (b, h, l, d), (b, h, lk[0] if lk else l, d)
        q = (torch.randn(shape, generator=gen, device=device) * qscale).to(torch.bfloat16)
        k = torch.randn(kshape, generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn(kshape, generator=gen, device=device).to(torch.bfloat16)
        sm_scale = 1.0 / math.sqrt(d)
        anchor = None
        if cb is None:
            anchor = float(fa.anchor_log2(q, k, sm_scale).max())
        out, lse = fa.flash_attention_with_lse(q, k, v, causal_block=cb)
        torch.cuda.synchronize()
        heads_per_chunk = max(1, (1 << 30) // (l * kshape[2] * 4 * b))
        ref_out, ref_lse = plain_chunked(fa, q, k, v, cb, heads_per_chunk)
        ref_scale = ref_out.abs().max().item()
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = math.isfinite(err_out) and err_out <= OUT_RTOL * ref_scale and err_lse <= LSE_TOL
        mutants = mutant_readings(fa, q, k, v, cb, heads_per_chunk, ref_out, ref_lse,
                                  anchored_mutant=name == WIDE_ANCHOR)
        caught = all(r_out > OUT_RTOL or r_lse > LSE_TOL for r_out, r_lse in mutants.values())
        del ref_out, ref_lse

        big = l * kshape[2] * b * h > 1e8
        iters = 5 if big else 20
        mask = None
        if cb is not None:
            idx = torch.arange(l, device=device) // cb
            mask = idx[None, :] <= idx[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the wrapper and SDPA in turns (K S S K, twice): back-to-back
        # readings of one call spread by up to 10 %, so the two are compared
        # only by their ranges in these turns
        fns = dict(ms=lambda: fa.flash_attention_with_lse(q, k, v, causal_block=cb),
                   library_ms=lambda: sdpa(q, k, v, attn_mask=mask))
        turns = dict(ms=[], library_ms=[])
        for key in ("ms", "library_ms", "library_ms", "ms") * 2:
            turns[key].append(time_cuda(fns[key], iters))
        ms, library_ms = (sum(x) / len(x) for x in (turns["ms"], turns["library_ms"]))
        del fns, mask
        anchor_ms = time_cuda(lambda: fa.anchor_log2(q, k, sm_scale), iters) if cb is None else 0.0
        plain_ms = time_cuda(
            lambda: plain_chunked(fa, q, k, v, cb, heads_per_chunk), 1 if big else 3, warmup=0
        )
        bound_ms, bound_by = attention_bound(b, h, l, d, cb, kshape[2])
        case = dict(
            name=name, shape=list(shape), lk=kshape[2], causal_block=cb, anchor_max=anchor,
            branch=("running_max" if cb is not None or not anchor < 40 else "anchored"),
            max_abs_err=err_out, ref_max_abs=ref_scale, rel_err=err_out / ref_scale,
            lse_max_abs_err=err_lse, mutants=mutants, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, ms_turns=turns["ms"], library_ms_turns=turns["library_ms"],
            anchor_ms=anchor_ms, bound_ms=bound_ms, bound_by=bound_by,
            kernel=fa.KERNEL_FWD_SM90 if d == fa.FWD_SM90_HEAD_DIM else fa.KERNEL_FWD_D512,
        )
        cases.append(case)
        wrong = ", ".join(f"{n} ({ro:.2e}, {rl:.2e})" for n, (ro, rl) in mutants.items())
        log(
            f"[kernels] {case['kernel']} {name} {shape} lk={kshape[2]} cb={cb} branch={case['branch']} "
            f"A_max={anchor} out_err={err_out:.3e} = {err_out / ref_scale:.3e} of max|ref| {ref_scale:.3e} "
            f"(tol {OUT_RTOL}) lse_err={err_lse:.3e} (tol {LSE_TOL}) "
            f"wrong outputs (out/max|ref|, lse): {wrong} "
            f"{'rejected' if caught else 'NOT REJECTED'} ms={ms:.3f} ({min(turns['ms']):.3f}-"
            f"{max(turns['ms']):.3f}) sdpa_ms={library_ms:.3f} ({min(turns['library_ms']):.3f}-"
            f"{max(turns['library_ms']):.3f}) in turns anchor_log2_ms={anchor_ms:.3f} bound_ms={bound_ms:.3f} "
            f"plain_ms={plain_ms:.3f} {'OK' if ok and caught else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"{case['kernel']} disagrees with its plain version at {name}")
        if not caught:
            raise AssertionError(f"the limits at {name} do not reject a known-wrong output")
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return {"cases": cases}


# ----------------------------------------------------------------------
# phase 2b: flash-attention backward at the path's shapes
# ----------------------------------------------------------------------

# products of 2 * B * H * D * visible pairs flops each: the fused kernel (D
# = 128) computes the minimal backward's 5 (S, dV, dP, dK, dQ); the D = 512
# kernel 6 (its dV CTAs S and dV, its dK / dQ CTAs S, dP, dK and dQ). The
# report's bound_ms of either is the minimal backward's: the work the
# function needs, whatever the kernel's design adds
BWD_PRODUCTS = {"flash_attention_bwd_fused": 5, "flash_attention_bwd_d512": 6, "minimal": 5}


def bwd_bound(kernel, b, h, l, d, causal_block, lk=None):
    """(least ms on the card, "operations" or "bytes") for one backward
    kernel (or the minimal backward): its products at the bf16 peak, or its
    inputs read and outputs written once at the memory rate (q, k, v, dO,
    LSE and delta in; its gradients out, bf16, and for a kernel the fp32
    dq_accum in place of dq)."""
    from opensora_torch.ops.flash_attention import dq_accum_rows

    lk = l if lk is None else lk
    flops = BWD_PRODUCTS[kernel] * 2.0 * b * h * d * visible_pairs(l, lk, causal_block)
    out_bytes = 2 * (l + 2 * lk) if kernel == "minimal" else 2 * 2 * lk + 4 * dq_accum_rows(l, d)
    nbytes = b * h * d * (2.0 * (2 * l + 2 * lk) + out_bytes) + 2 * 4.0 * b * h * l
    flops_s, bytes_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(flops_s, bytes_s), ("operations" if flops_s >= bytes_s else "bytes")


def dq_convert_bound(b, h, l, d):
    """(least ms, "bytes") of a dQ epilogue: dq_accum (fp32) read and dq
    (bf16) written once at the memory rate; one multiply an element."""
    from opensora_torch.ops.flash_attention import dq_accum_rows

    return 1e3 * b * h * d * (4.0 * dq_accum_rows(l, d) + 2.0 * l) / PEAK_BYTES, "bytes"


def plain_bwd_chunked(fa, q, k, v, do, lse, delta, causal_block, heads_per_chunk):
    """The plain fp32 backward over chunks of heads."""
    parts = []
    for h0 in range(0, q.shape[1], heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        parts.append(fa.flash_attention_bwd_ref(q[:, sl], k[:, sl], v[:, sl], do[:, sl], lse[:, sl],
                                                delta[:, sl], None, causal_block))
    return tuple(torch.cat(xs, 1) for xs in zip(*parts))


def bwd_mutant_readings(fa, q, k, v, do, lse, delta, causal_block, heads_per_chunk, ref) -> dict:
    """What the check reads (worst of dq, dk, dv as max|err| / max|ref|)
    for gradients a faulty backward could give: delta left out of dS;
    sm_scale missing from dK; the last 64-row tile of queries and keys
    skipped (its rows of the gradients left at 0); one key block's dQ
    contribution dropped (128 keys for D = 128, 64 for D = 512); for D =
    128 (the fused kernel), that block's contribution added twice, and dK,
    dV computed with the neighbouring 64-row query tile's dO; for D = 512,
    the first two 128-column slices swapped and the last one skipped (the
    faults of the split kernels it replaced), one consumer's 256 columns of
    every gradient taken from the other's, and dV with the previous 64-row
    query tile's P (the dV CTAs' P buffers out of order)."""
    scales = [r.abs().max().item() for r in ref]

    def reading(grads):
        return max((g - r).abs().max().item() / sc for g, r, sc in zip(grads, ref, scales))

    lq, lk = q.shape[2], k.shape[2]
    keep_q, keep_k = lq - (lq % 64 or 64), lk - (lk % 64 or 64)
    cut = plain_bwd_chunked(fa, q[:, :, :keep_q], k[:, :, :keep_k], v[:, :, :keep_k], do[:, :, :keep_q],
                            lse[:, :, :keep_q].contiguous(), delta[:, :, :keep_q].contiguous(), causal_block,
                            heads_per_chunk)
    pad = [torch.nn.functional.pad(g, (0, 0, 0, n - g.shape[2])) for g, n in zip(cut, (lq, lk, lk))]
    res = {
        "delta_left_out": reading(plain_bwd_chunked(fa, q, k, v, do, lse, torch.zeros_like(delta), causal_block,
                                                    heads_per_chunk)),
        "dk_without_sm_scale": reading((ref[0], ref[1] * math.sqrt(q.shape[-1]), ref[2])),
        "tail_tile_skipped": reading(pad),
    }
    # Zeroing a key block's keys zeroes its terms dS K of dQ and leaves the
    # others (P comes from the external LSE).
    block = 128 if q.shape[-1] == 128 else 64
    n0 = block if lk > 2 * block else 0
    k_cut = k.clone()
    k_cut[:, :, n0:n0 + block] = 0
    dq_rest = plain_bwd_chunked(fa, q, k_cut, v, do, lse, delta, causal_block, heads_per_chunk)[0]
    del k_cut
    res["dq_key_block_dropped"] = reading((dq_rest, ref[1], ref[2]))
    if q.shape[-1] == 128:  # the fused kernel: a key block's dQ reduce-add doubled, a tile's dO misread
        res["dq_key_block_added_twice"] = reading((2 * ref[0] - dq_rest, ref[1], ref[2]))
        del dq_rest
        _, dk_n, dv_n = plain_bwd_chunked(fa, q, k, v, do.roll(64, dims=2), lse, delta, causal_block, heads_per_chunk)
        res["dkv_from_neighbour_do_tile"] = reading((ref[0], dk_n, dv_n))
    else:
        del dq_rest

        def swapped(g):
            return torch.cat([g[..., 128:256], g[..., :128], g[..., 256:]], dim=-1)

        res["d_slices_0_1_swapped"] = reading([swapped(g) for g in ref])
        res["d_slice_3_skipped"] = reading([torch.cat([g[..., :384], torch.zeros_like(g[..., 384:])], -1)
                                            for g in ref])
        res["consumer_columns_from_other_consumer"] = reading([torch.cat([g[..., :256], g[..., :256]], -1)
                                                               for g in ref])
        res["dv_from_previous_query_tile_p"] = reading(
            (ref[0], ref[1], dv_previous_tile_p(fa, q, k, do, lse, causal_block, heads_per_chunk)))
    return res


def dv_previous_tile_p(fa, q, k, do, lse, causal_block, heads_per_chunk, tile=64):
    """dV = sum over query tiles t of P_{t-1}^T dO_t (P rounded to bf16 as
    the kernel rounds it; the first tile takes P = 0), fp32: what the D = 512
    kernel's dV CTAs give with their P buffers out of order. Under the
    causal mask a key block's first query tile follows rows whose P is 0 for
    its keys, so shifting P by one tile over all rows is that fault."""
    sm = 1.0 / math.sqrt(q.shape[-1])
    parts = []
    for h0 in range(0, q.shape[1], heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, sl].float(), k[:, sl].float())
        lse_c = lse[:, sl].float()
        lse2 = torch.where(lse_c <= fa.NEG_INF * 0.5, torch.zeros_like(lse_c), lse_c) * fa.LOG2E
        p = torch.exp2(s * (sm * fa.LOG2E) - lse2[..., None])
        del s
        if causal_block is not None:
            qi = torch.arange(q.shape[2], device=q.device)[:, None] // causal_block
            ki = torch.arange(k.shape[2], device=q.device)[None, :] // causal_block
            p = p.masked_fill(ki > qi, 0.0)
        p = p.to(torch.bfloat16).float().roll(tile, dims=2)
        p[:, :, :tile] = 0
        parts.append(torch.einsum("bhqk,bhqd->bhkd", p, do[:, sl].float()))
        del p
    return torch.cat(parts, 1)


def sdpa_backward_ms(q, k, v, do, mask, iters: int) -> float:
    """The PyTorch library's attention backward: SDPA forward + backward
    minus SDPA forward."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    both = time_cuda(lambda: torch.autograd.grad(sdpa(qg, kg, vg, attn_mask=mask), (qg, kg, vg), do), iters)
    with torch.no_grad():
        fwd = time_cuda(lambda: sdpa(qg, kg, vg, attn_mask=mask), iters)
    return both - fwd


BWD_CASES = [
    # name, (B, H, L, D), causal_block[, Lk]
    ("mmdit_joint", (3, 24, 8828, 128), None),
    ("tail_bidirectional", (2, 3, 1000, 128), None),
    ("tail_frame_causal", (1, 2, 1000, 128), 96),
]
# phase 2d: the HunyuanVAE mid-block in VAE training (33 x 256 x 256 ->
# latent 9 x 32 x 32: 9216 tokens, frames of 1024), a tail, and a
# bidirectional call with Lq != Lk
BWD_D512_CASES = [
    ("vae_mid_33x256x256", (1, 1, 9216, 512), 1024),
    ("tail_frame_causal_d512", (1, 2, 1000, 512), 96),
    ("bidirectional_lq_ne_lk_d512", (2, 2, 700, 512), None, 1000),
]


def check_attention_bwd(device, cases_in=BWD_CASES, seed: int = 2) -> dict:
    """Phase 2b (D = 128: the fused kernel and its dQ epilogue) and 2d (D =
    512: its wgmma/TMA kernel and its dQ epilogue): the backward against the
    plain backward, the epilogue against its plain version, the run-to-run
    spread of dQ's atomic sum, known-wrong gradients, times beside the
    bounds, the plain backward and SDPA's backward."""
    from opensora_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    cases = []
    for name, (b, h, l, d), cb, *lk in cases_in:
        lk = lk[0] if lk else l
        kernels = tuple(fa._BWD_ENTRIES[d][1])  # the kernel, its dQ epilogue
        accum, convert, convert_ref = (fa.flash_attention_bwd_accum, fa.flash_attention_bwd_dq_convert,
                                       fa.flash_attention_bwd_dq_convert_ref)
        shape, kshape = (b, h, l, d), (b, h, lk, d)
        q, k, v, do = (torch.randn(x, generator=gen, device=device).to(torch.bfloat16)
                       for x in (shape, kshape, kshape, shape))
        heads_per_chunk = max(1, (1 << 30) // (l * lk * 4 * b))
        out, lse = plain_chunked(fa, q, k, v, cb, heads_per_chunk)
        delta = (do.float() * out).sum(-1)
        out = out.to(torch.bfloat16)  # the forward's output as FlashAttentionFunction saves it (call_ms)
        kw = dict(sm_scale=1.0 / math.sqrt(d), causal_block=cb)
        acc, dk, dv = accum(q, k, v, do, lse, delta, **kw)
        dq = convert(acc, l, sm_scale=kw["sm_scale"])
        torch.cuda.synchronize()
        # the epilogue against its plain version on the same dq_accum: the
        # same fp32 multiply and bf16 rounding, so equal
        extra = {"dq_convert_max_abs_err": (dq.float() - convert_ref(acc, l, kw["sm_scale"]).float()).abs().max().item()}
        # dQ's sum is added in an order that changes from run to run: the
        # spread of a second run, fp32 dq_accum and bf16 dq, of max|.|
        acc2 = accum(q, k, v, do, lse, delta, **kw)[0]
        dq2 = convert(acc2, l, sm_scale=kw["sm_scale"])
        extra["run_spread"] = {"dq_accum": ((acc2 - acc).abs().max() / acc.abs().max()).item(),
                               "dq": ((dq2.float() - dq.float()).abs().max() / dq.float().abs().max()).item()}
        del acc2, dq2
        ref = plain_bwd_chunked(fa, q, k, v, do, lse, delta, cb, heads_per_chunk)
        errs = {n: (g.float() - r).abs().max().item() for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        scales = {n: r.abs().max().item() for n, r in zip(("dq", "dk", "dv"), ref)}
        rel = {n: errs[n] / scales[n] for n in errs}
        ok = all(math.isfinite(e) and r <= BWD_RTOL for e, r in zip(errs.values(), rel.values()))
        ok = ok and extra["dq_convert_max_abs_err"] == 0.0
        mutants = bwd_mutant_readings(fa, q, k, v, do, lse, delta, cb, heads_per_chunk, ref)
        caught = all(r > BWD_RTOL for r in mutants.values())
        del ref, dq, dk, dv

        big = l * lk * b * h > 1e8
        iters = 5 if big else 20
        times = {
            kernels[0]: time_cuda(lambda: accum(q, k, v, do, lse, delta, **kw), iters),
            kernels[1]: time_cuda(lambda: convert(acc, l, sm_scale=kw["sm_scale"]), iters),
        }
        # what the kernel's wrapper time includes besides the kernel
        extra["dq_accum_zero_fill_ms"] = time_cuda(lambda: torch.zeros_like(acc), iters)
        extra["dq_convert_plain_ms"] = time_cuda(lambda: convert_ref(acc, l, kw["sm_scale"]), iters)
        del acc
        # the whole backward as FlashAttentionFunction runs it: delta, then the kernels
        call_ms = time_cuda(lambda: fa.partial_flash_backward(q, k, v, do, lse, (do.float() * out.float()).sum(-1),
                                                              **kw), iters)
        plain_ms = time_cuda(lambda: plain_bwd_chunked(fa, q, k, v, do, lse, delta, cb, heads_per_chunk),
                             1 if big else 3, warmup=0)
        mask = None
        if cb is not None:
            idx = torch.arange(l, device=device) // cb
            mask = idx[None, :] <= idx[:, None]
        library_ms = sdpa_backward_ms(q, k, v, do, mask, iters)
        bounds = {n: bwd_bound(n, b, h, l, d, cb, lk) for n in (kernels[0], "minimal")}
        bounds[kernels[1]] = dq_convert_bound(b, h, l, d)
        case = dict(name=name, shape=list(shape), lk=lk, causal_block=cb, max_abs_err=errs, ref_max_abs=scales,
                    rel_err=rel, mutants=mutants, ms=times, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms={n: bd[0] for n, bd in bounds.items()}, bound_by={n: bd[1] for n, bd in bounds.items()},
                    **extra)
        cases.append(case)
        log(
            f"[kernels] flash_attention_bwd {name} {shape} lk={lk} cb={cb} ({' + '.join(kernels)}) "
            f"dq/dk/dv max|err|/max|ref| = {rel['dq']:.3e}/{rel['dk']:.3e}/{rel['dv']:.3e} (tol {BWD_RTOL}) "
            f"dq epilogue vs its plain version max|err| {extra['dq_convert_max_abs_err']} (tol 0) run-to-run "
            f"spread of max|.|: dq_accum {extra['run_spread']['dq_accum']:.3e} dq {extra['run_spread']['dq']:.3e} "
            + "wrong gradients: " + ", ".join(f"{n} {r:.3e}" for n, r in mutants.items())
            + f" {'rejected' if caught else 'NOT REJECTED'} "
            + " ".join(f"{n}_ms={t:.3f}" for n, t in times.items())
            + f" call_ms={call_ms:.3f} bound_ms " + " ".join(f"{n}={bd[0]:.3f}" for n, bd in bounds.items())
            + f" plain_ms={plain_ms:.3f} sdpa_bwd_ms={library_ms:.3f} {'OK' if ok and caught else 'FAIL'}"
        )
        if not ok:
            raise AssertionError(f"the backward kernels disagree with their plain versions at {name}")
        if not caught:
            raise AssertionError(f"the limit at {name} does not reject a known-wrong backward")
        del q, k, v, do, lse, delta, out, mask
        torch.cuda.empty_cache()
    return {"cases": cases}


# ----------------------------------------------------------------------
# phase 2c: the int8 kernels at the int8 serving path's shapes
# ----------------------------------------------------------------------

# (name, M, K, N): the MMDiT's W8A8 products at 256px 129 frames with the
# 3-way CFG batch (8316 image + 512 text tokens, B = 3)
GEMM_CASES = [
    ("double_img_qkv", 3 * 8316, 3072, 9216),
    ("double_img_mlp2", 3 * 8316, 12288, 3072),
    ("single_linear1", 3 * 8828, 3072, 21504),
    ("single_linear2", 3 * 8828, 15360, 3072),
    ("modulation", 3, 3072, 18432),
    ("m_and_n_tails", 1000, 3072, 200),
]
GEMM_HEAD = "single_linear1"  # the largest, 38 per forward
# rows of abs-max exactly 127 (s_a = inv = 1) holding half-integers: x * inv
# falls on ties, which the fused-quant kernel must round half to even
GEMM_TIE_CASE = ("ties_abs_max_127", 1000, 3072, 512)


def gemm_bound(m, k, n, fq: bool):
    """(least ms, "operations" or "bytes"): 2MNK int8 ops at the int8 peak, or
    x (int8, or bf16 for fq), the weight, the scales read and the bf16
    output written once."""
    ops_s = 2.0 * m * n * k / PEAK_INT8_OPS
    bytes_s = ((2 if fq else 1) * m * k + n * k + 4.0 * (m + n) + 2.0 * m * n) / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def gemm_from_x8(x8, w, s_a, sw):
    """The plain product of the int8 values x8 (any float dtype): the exact
    integer sum, then float(acc) * s_a * s_w in fp32, in that order."""
    return (x8.double() @ w.double().T).float() * s_a.reshape(-1, 1) * sw


def consumer_rows_swapped(out):
    """Each 128-row tile's second 64 rows replaced by its first 64 (one
    consumer's rows taken from the other's)."""
    wrong = out.clone()
    for t0 in range(0, out.shape[0], 128):
        n = min(out.shape[0], t0 + 128) - (t0 + 64)
        if n > 0:
            wrong[t0 + 64:t0 + 64 + n] = out[t0:t0 + n]
    return wrong


def a_tile_unswizzled(x8):
    """x8 (M, K) as the products would read the int8 A tile if their
    descriptor ignored the TMA's 64-byte swizzle: in each 64-byte row r of a
    stage, 16-byte chunk c holds logical chunk c ^ ((r / 2) % 4)."""
    m, k = x8.shape
    rows = torch.arange(m, device=x8.device)[:, None]
    cols = torch.arange(k, device=x8.device)[None, :]
    src = (cols // 64) * 64 + (((cols % 64) // 16) ^ ((rows // 2) % 4)) * 16 + cols % 16
    return torch.gather(x8, 1, src.expand(m, k))


def gemm_mutants(fq: bool, x8_used, w, s_a, sw, ref, y=None) -> dict:
    """Known-wrong outputs, each as the count of elements that differ from
    the plain version's (the check is exact: any count above 0 is
    rejected): one 32-wide K slice (one k32 product) left out; where the
    tile has a second consumer, its rows taken from the first's. The int8
    instantiation: the A tile read unswizzled. Fused-quant: where ``y`` =
    x * inv holds ties that the two rules round apart (k + 1/2, k even),
    round half away from zero in place of half to even."""
    def differing(wrong):
        return int((wrong != ref).sum())

    out = {"k32_slice_dropped": differing(ref - gemm_from_x8(x8_used[:, 32:64], w[:, 32:64], s_a, sw))}
    if ref.shape[0] > 64:
        out["consumer_rows_swapped"] = differing(consumer_rows_swapped(ref))
    if not fq:
        out["a_tile_read_unswizzled"] = differing(gemm_from_x8(a_tile_unswizzled(x8_used), w, s_a, sw))
    if fq and y is not None:
        away = torch.clamp(torch.sign(y) * torch.floor(y.abs() + 0.5), -127, 127)
        if not torch.equal(away, x8_used):  # ties at k + 1/2 with k even
            out["round_half_away"] = differing(gemm_from_x8(away, w, s_a, sw))
    return out


def check_int8_gemm(device, cases=GEMM_CASES + [GEMM_TIE_CASE]) -> dict:
    from opensora_torch.ops import int8_matmul as im

    gen = torch.Generator(device=device).manual_seed(4)
    out_cases = []
    for name, m, k, n in cases:
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        sa = torch.rand((m, 1), generator=gen, device=device) * 1e-2 + 1e-3
        sw = torch.rand((n,), generator=gen, device=device) * 1e-2 + 1e-3
        if name == GEMM_TIE_CASE[0]:
            x = torch.randint(-127, 127, (m, k), generator=gen, device=device).float() + 0.5
            x[:, 0] = 127.0
            x = x.to(torch.bfloat16)
        else:
            x = (torch.randn((m, k), generator=gen, device=device) * 0.3).to(torch.bfloat16)
        s_a_fq, inv = im.fq_inputs(x)
        y = x.float() * inv
        rec = dict(name=name, shape_mkn=[m, k, n])
        bf16 = torch.bfloat16
        fns = {  # kernel (wrapper) and plain version, by output dtype
            "w8a8_matmul": (lambda dt=bf16: im.w8a8_matmul(x8, w, sa, sw, out_dtype=dt),
                            lambda dt=bf16: im.w8a8_matmul_ref(x8, w, sa, sw, dt)),
            "w8a8_fq_matmul": (lambda dt=bf16: im.w8a8_fusedquant_matmul(x, w, sw, out_dtype=dt),
                               lambda dt=bf16: im.w8a8_fusedquant_matmul_ref(x, w, sw, dt)),
        }
        for kern, (run, plain) in fns.items():
            fq = kern == "w8a8_fq_matmul"
            out = run(torch.float32)
            torch.cuda.synchronize()
            ref = plain(torch.float32)
            n_diff = int((out != ref).sum())
            ref_scale = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            if fq:
                mutants = gemm_mutants(True, torch.clamp(torch.round(y), -127, 127), w, s_a_fq, sw, ref, y)
            else:
                mutants = gemm_mutants(False, x8, w, sa, sw, ref)
            caught = all(c > 0 for c in mutants.values())
            if name == GEMM_TIE_CASE[0] and fq and "round_half_away" not in mutants:
                raise AssertionError("the tie case holds no tie")
            del out, ref
            rec[kern] = dict(elements_differing=n_diff, max_abs_err=err, ref_max_abs=ref_scale, mutants=mutants)
            ok = n_diff == 0 and caught
            log(f"[int8] {kern} {name} (M, K, N) = ({m}, {k}, {n}): elements differing from the plain "
                f"version at fp32 output {n_diff} (must be 0; max|err| {err:.3e}) wrong outputs (elements "
                f"differing): {mutants} {'rejected' if caught else 'NOT REJECTED'} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kern} disagrees with its plain version at {name}, or the check "
                                     "does not reject a known-wrong output")
        # the fused-quant kernel alone and row 5's kernel (both given their
        # scales), the fused-quant wrapper (with the row abs-max pass in
        # torch) and row 5's yardstick (torch._int_mm + the fp32 rescale) in
        # turns: back-to-back readings spread, so they are compared by their
        # ranges in these turns
        big = 2.0 * m * n * k > 1e11
        iters = 10 if big else 20
        timed = dict(fq=lambda: im.fq_kernel(x, w, sw, s_a_fq, inv), row5=fns["w8a8_matmul"][0],
                     fq_wrapper=fns["w8a8_fq_matmul"][0])
        if m > 16:  # torch._int_mm takes more than 16 rows
            library = lambda: (torch._int_mm(x8, w.t()).float() * sa * sw).to(torch.bfloat16)  # noqa: E731
            try:  # a yardstick only: a library that refuses the shape leaves it unmeasured
                library()
                timed["library"] = library
            except RuntimeError as e:
                log(f"[int8] torch._int_mm refused {name}: {str(e).splitlines()[0]}")
        turns = {key: [] for key in timed}
        for key in (tuple(timed) + tuple(timed)[::-1]) * 2:
            turns[key].append(time_cuda(timed[key], iters))
        mean = {key: sum(v) / len(v) for key, v in turns.items()}
        library_ms = mean.get("library")
        for kern, key, fq in (("w8a8_matmul", "row5", False), ("w8a8_fq_matmul", "fq", True)):
            bound_ms, bound_by = gemm_bound(m, k, n, fq)
            plain_ms = time_cuda(fns[kern][1], 1, warmup=0)
            rec[kern].update(ms=mean[key], ms_turns=turns[key], plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None if fq else library_ms,
                             library_ms_turns=None if fq else turns.get("library"))
            if fq:
                rec[kern].update(wrapper_ms=mean["fq_wrapper"], wrapper_ms_turns=turns["fq_wrapper"])
        rng = {key: f"{min(v):.3f}-{max(v):.3f}" for key, v in turns.items()}
        library_txt = "n/a" if library_ms is None else f"{library_ms:.3f} ({rng['library']})"
        log(f"[int8] {name} in turns (ms, mean and range): w8a8_fq_matmul {mean['fq']:.3f} ({rng['fq']}), "
            f"with the abs-max pass {mean['fq_wrapper']:.3f} ({rng['fq_wrapper']}); w8a8_matmul (row 5) "
            f"{mean['row5']:.3f} ({rng['row5']}); library (row 5) {library_txt}; "
            f"bound fq/row5 {rec['w8a8_fq_matmul']['bound_ms']:.3f}/{rec['w8a8_matmul']['bound_ms']:.3f}; "
            f"plain fq/row5 {rec['w8a8_fq_matmul']['plain_ms']:.3f}/{rec['w8a8_matmul']['plain_ms']:.3f}")
        out_cases.append(rec)
        del x8, w, sa, sw, x, y, s_a_fq, inv
        torch.cuda.empty_cache()
    return {"cases": out_cases}


INT8_ATTN_CASES = [
    # name, (B, H, L, D), q scale: the anchored loop, the running-max loop
    # (a2 >= 40), and L = 1000 (no whole 64-key tile) in both
    ("mmdit_joint_anchored", (3, 24, 8828, 128), 1.0),
    ("mmdit_joint_running_max", (3, 24, 8828, 128), 3.0),
    ("tail_anchored", (2, 3, 1000, 128), 1.0),
    ("tail_running_max", (2, 3, 1000, 128), 3.0),
]


def int8_attention_bound(b, h, l, d, pv_int8: bool, mufu_per_s: float):
    """(least ms, what bounds it, exp2 ms): Q K^T on int8 plus P V on int8
    (pv_int8) or bf16 (qk8), both on the tensor cores; the exp2 of every
    logit on the special-function units, in parallel; or the int8/bf16
    inputs read and the bf16 output written once."""
    prod = 2.0 * b * h * l * l * d
    ops_s = prod / PEAK_INT8_OPS + prod / (PEAK_INT8_OPS if pv_int8 else PEAK_BF16_FLOPS)
    exp_s = b * h * l * l / mufu_per_s
    bytes_s = (b * h * l * d * (1 + 1 + (1 if pv_int8 else 2) + 2) + 4.0 * b * h * l) / PEAK_BYTES
    worst = max(ops_s, exp_s, bytes_s)
    by = "operations" if worst in (ops_s, exp_s) else "bytes"
    return 1e3 * worst, by, 1e3 * exp_s


def int8_plain_chunked(ia, q, k, v, pv_int8, heads_per_chunk, mutate=None, plain=None):
    """The plain version over chunks of heads (everything in it is per
    (b, h)); ``mutate(pre)`` edits the preamble's output first, ``plain``
    stands in for ia.attention_from_quantized."""
    outs = []
    block_k = ia.default_block_k(k.shape[2])
    for h0 in range(0, q.shape[1], heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        pre = ia.quantize_inputs(q[:, sl], k[:, sl], v[:, sl], q.shape[-1] ** -0.5, block_k, pv_int8)
        if mutate is not None:
            mutate(pre)
        outs.append((plain or ia.attention_from_quantized)(pre, pv_int8))
    return torch.cat(outs, 1)


def v8t_unpermuted(pre):
    """What the pv_int8 kernel computes if v8t held V8 transposed but not
    key-permuted: its P8 fragments put logical key PERM_16[p] at physical
    position p of each 16-key group, so key PERM_16[p] meets V8 of key p."""
    from opensora_torch.ops.int8_flash import PERM_16

    v8 = pre["v8"]
    b, h, lk, d = v8.shape
    pad = -lk % 16
    groups = torch.nn.functional.pad(v8, (0, 0, 0, pad)).reshape(b, h, -1, 16, d)
    inverse = torch.empty(16, dtype=torch.long)
    inverse[torch.tensor(PERM_16)] = torch.arange(16)
    pre["v8"] = groups[:, :, :, inverse.to(v8.device)].reshape(b, h, lk + pad, d)[:, :, :lk]


def pv_int8_p_scale_of_next_tile(pre, pv_int8):
    """The pv_int8 plain version with each quantization tile's P quantized
    and dequantized by the next tile's p_scale (the last by the first's)."""
    import torch.nn.functional as F

    nk, block_k, lk = pre["nk"], pre["block_k"], pre["k8"].shape[2]
    s32 = pre["q8"].float() @ pre["k8"].float().transpose(-1, -2)
    sk_col = pre["sk"][..., 0].repeat_interleave(block_k, dim=-1)[..., :lk]
    s = s32 * (pre["sq"] * sk_col[..., None, :])
    b, h, lq, _ = s.shape
    sp = F.pad(s, (0, nk * block_k - lk), value=-1e30).reshape(b, h, lq, nk, block_k)
    m_run = torch.cummax(sp.amax(dim=-1), dim=-1).values
    m_safe = torch.where(m_run <= -5e29, torch.zeros_like(m_run), m_run)
    a2 = pre["a2"][..., None, None]
    anc = torch.where(a2 < 40.0, a2.expand_as(m_safe), m_safe)
    p = torch.exp2(sp - anc[..., None])
    p_scale = torch.clamp(p.amax(dim=-1), min=1e-8).roll(-1, dims=-1)
    p8 = torch.clamp(torch.round(p * (127.0 / p_scale)[..., None]), max=127)
    v8 = F.pad(pre["v8"].float(), (0, 0, 0, nk * block_k - lk)).reshape(b, h, nk, block_k, -1)
    pv = torch.einsum("bhqtk,bhtkd->bhqtd", p8, v8) * (p_scale * (1.0 / 127.0))[..., None] * pre["sv"][:, :, None]
    w = torch.exp2(anc - anc[..., -1:])
    den = (p.sum(dim=-1) * w).sum(dim=-1, keepdim=True)
    return (pv * w[..., None]).sum(dim=-2) / torch.where(den <= 0, torch.ones_like(den), den) + pre["v_mean"]


def check_int8_attention(device, mufu_per_s: float) -> dict:
    from opensora_torch.ops import int8_flash as ia

    gen = torch.Generator(device=device).manual_seed(5)
    cases = []
    for name, (b, h, l, d), qscale in INT8_ATTN_CASES:
        q = (torch.randn((b, h, l, d), generator=gen, device=device) * qscale).to(torch.bfloat16)
        k = torch.randn((b, h, l, d), generator=gen, device=device).to(torch.bfloat16)
        # V with a common mode, which the int8 mode's smoothing takes out and adds back
        v = (torch.randn((b, h, l, d), generator=gen, device=device) + 0.5).to(torch.bfloat16)
        block_k = ia.default_block_k(l)
        a2_max = float(ia.quantize_inputs(q, k, v, d ** -0.5, block_k, False)["a2"].max())
        heads_per_chunk = max(1, (1 << 30) // (l * l * 4 * b))
        for pv_int8 in (False, True):
            mode = "int8" if pv_int8 else "qk8"
            out = ia.int8_flash_attention(q, k, v, pv_int8=pv_int8)
            torch.cuda.synchronize()
            ref = int8_plain_chunked(ia, q, k, v, pv_int8, heads_per_chunk)
            scale = ref.abs().max().item()
            err = (out.float() - ref).abs().max().item()
            ok = math.isfinite(err) and err <= INT8_ATTN_RTOL * scale

            def reading(wrong):
                return (wrong - ref).abs().max().item() / scale

            def neighbour_sk(pre):
                pre["sk"] = pre["sk"].roll(-1, dims=2)

            keep = l - (l % 64 or 64)
            mutants = {
                "sk_of_neighbouring_tile": reading(int8_plain_chunked(ia, q, k, v, pv_int8, heads_per_chunk,
                                                                      neighbour_sk)),
                "tail_tile_skipped": reading(int8_plain_chunked(
                    ia, q, k[:, :, :keep].contiguous(), v[:, :, :keep].contiguous(), pv_int8, heads_per_chunk)),
            }
            if pv_int8:
                mutants["v_mean_not_added"] = reading(ref - v.float().mean(dim=2, keepdim=True))
                mutants["v8t_unpermuted"] = reading(int8_plain_chunked(ia, q, k, v, True, heads_per_chunk,
                                                                       v8t_unpermuted))
                if l > block_k:  # a neighbouring quantization tile exists
                    mutants["p_scale_of_neighbouring_tile"] = reading(int8_plain_chunked(
                        ia, q, k, v, True, heads_per_chunk, plain=pv_int8_p_scale_of_next_tile))
            caught = all(r > INT8_ATTN_RTOL for r in mutants.values())
            del ref, out
            big = l * l * b * h > 1e8
            iters = 5 if big else 20
            # the kernel alone (on the preamble's output), the wrapper (with the
            # torch preamble) and bf16 SDPA, the yardstick, in turns
            pre = ia.kernel_inputs(q, k, v, d ** -0.5, block_k, pv_int8)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            timed = dict(kernel=lambda: ia.launch(pre, pv_int8),
                         wrapper=lambda: ia.int8_flash_attention(q, k, v, pv_int8=pv_int8),
                         library=lambda: sdpa(q, k, v))
            turns = {key: [] for key in timed}
            for key in (tuple(timed) + tuple(timed)[::-1]) * 2:
                turns[key].append(time_cuda(timed[key], iters))
            del pre, timed
            mean = {key: sum(t) / len(t) for key, t in turns.items()}
            rng = {key: f"{min(t):.3f}-{max(t):.3f}" for key, t in turns.items()}
            plain_ms = time_cuda(lambda: int8_plain_chunked(ia, q, k, v, pv_int8, heads_per_chunk), 1, warmup=0)
            bound_ms, bound_by, exp2_ms = int8_attention_bound(b, h, l, d, pv_int8, mufu_per_s)
            case = dict(name=name, mode=mode, shape=[b, h, l, d], block_k=block_k, a2_max=a2_max,
                        branch="anchored" if a2_max < 40 else "running_max", max_abs_err=err,
                        ref_max_abs=scale, rel_err=err / scale, mutants=mutants, ms=mean["kernel"],
                        ms_turns=turns["kernel"], wrapper_ms=mean["wrapper"], wrapper_ms_turns=turns["wrapper"],
                        plain_ms=plain_ms, library_ms=mean["library"], library_ms_turns=turns["library"],
                        library="bf16 SDPA (the bf16 route's yardstick)",
                        bound_ms=bound_ms, bound_by=bound_by, exp2_ms=exp2_ms)
            cases.append(case)
            wrong = ", ".join(f"{n} {r:.2e}" for n, r in mutants.items())
            log(f"[int8] int8_flash_attention {mode} {name} {[b, h, l, d]} block_k={block_k} "
                f"branch={case['branch']} a2_max={a2_max:.2f} err={err:.3e} = {err / scale:.3e} of max|ref| "
                f"{scale:.3e} (tol {INT8_ATTN_RTOL}) wrong outputs (of max|ref|): {wrong} "
                f"{'rejected' if caught else 'NOT REJECTED'}; in turns (ms, mean and range): kernel "
                f"{mean['kernel']:.3f} ({rng['kernel']}), with the torch preamble {mean['wrapper']:.3f} "
                f"({rng['wrapper']}), bf16 SDPA {mean['library']:.3f} ({rng['library']}); bound_ms={bound_ms:.3f} "
                f"({bound_by}; exp2 alone {exp2_ms:.3f}) plain_ms={plain_ms:.3f} {'OK' if ok and caught else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8_flash_attention ({mode}) disagrees with its plain version at {name}")
            if not caught:
                raise AssertionError(f"the limit at {name} ({mode}) does not reject a known-wrong output")
        del q, k, v
        torch.cuda.empty_cache()
    return {"cases": cases}


# ----------------------------------------------------------------------
# phase 2e: the ring kernels over logical ranks on one card
# ----------------------------------------------------------------------

RING_SP = 4  # logical ranks of the 'sp' axis, all on the one card
RING_CASES = [
    # name, global (B, H, L, D), causal_block: the MMDiT's joint attention
    # over 4 ranks (2207 tokens a rank: a ragged last tile), and a
    # frame-causal case whose shard edges (1000, 2000, 3000) cut frames of 96
    ("mmdit_joint_sp4", (3, 24, 8828, 128), None),
    ("causal_off_frame_edges_sp4", (1, 2, 4000, 128), 96),
]
RING_KERNELS = ("ring_flash_fwd", "ring_flash_bwd_fused")


def ring_mesh(device):
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(dp_size=1, sp_size=RING_SP, tp_size=1), [device] * RING_SP)


def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(module.name)`` inside a with."""
    return unittest.mock.patch.object(module, name, wrap(getattr(module, name)))


def last_hop_skipped(hop):
    """A forward hop that, on the last hop, folds in no keys (it only
    writes out and LSE from the state of the first sp - 1 hops)."""
    def run(q, k, v, *a, **kw):
        if kw["last"]:
            k, v = k[:, :, :0], v[:, :, :0]
        return hop(q, k, v, *a, **kw)
    return run


def local_offsets(hop):
    """A hop that masks at local offsets (0, 0) in place of the global ones."""
    def run(*a, **kw):
        return hop(*a, **dict(kw, q_off=0, k_off=0))
    return run


def middle_hop_from_zero(q_off: int, k_off: int):
    """A forward hop that, at one middle (rank, hop) -- the one of these
    offsets -- starts from the empty state instead of the loaded one."""
    def wrap(hop):
        def run(*a, **kw):
            if (kw["q_off"], kw["k_off"]) == (q_off, k_off) and not kw["last"]:
                kw = dict(kw, first=True)
            return hop(*a, **kw)
        return run
    return wrap


def l_on_every_quad_lane(hop):
    """A forward hop that gives the loaded row sum to all four lanes of a
    quad: the loaded l counted four times."""
    def run(q, k, v, state, *a, **kw):
        if not kw["first"]:
            state[1].mul_(4.0)
        return hop(q, k, v, state, *a, **kw)
    return run


def consumer_rows_from_other(hop):
    """A forward hop whose last epilogue writes each 128-row CTA's second
    consumer's rows (out and LSE) from the first consumer's."""
    def run(q, k, v, state, out, lse, **kw):
        hop(q, k, v, state, out, lse, **kw)
        if kw["last"]:
            for t0 in range(0, out.shape[2], 128):
                n = min(out.shape[2], t0 + 128) - (t0 + 64)
                if n > 0:
                    out[:, :, t0 + 64:t0 + 64 + n] = out[:, :, t0:t0 + n].clone()
                    lse[:, :, t0 + 64:t0 + 64 + n] = lse[:, :, t0:t0 + n].clone()
    return run


def delta_left_out(hop):
    def run(q, k, v, do, lse, delta, *a, **kw):
        return hop(q, k, v, do, lse, torch.zeros_like(delta), *a, **kw)
    return run


def dkv_add_dropped(q_off: int, k_off: int):
    """A backward hop that, at one (rank, hop) -- the one of these offsets --
    adds nothing into the travelling dK/dV (dQ as it should)."""
    def wrap(hop):
        def run(q, k, v, do, lse, delta, dk, dv, dq, **kw):
            if (kw["q_off"], kw["k_off"]) == (q_off, k_off):
                dk, dv = torch.zeros_like(dk), torch.zeros_like(dv)
            return hop(q, k, v, do, lse, delta, dk, dv, dq, **kw)
        return run
    return wrap


def check_ring(device) -> dict:
    """The ring kernels on the card (the forward hop, the fused backward hop
    and, once per rank, the dQ epilogue), through ring_flash_attention over
    RING_SP logical ranks (hops on their own streams, KV and dK/dV copies
    between the ranks' slots), against the plain ring (the plain hops in
    sequence) on the same inputs; the limits must reject known-wrong
    rings; times of the call, of the 16 (rank, hop) launches of each kernel,
    of the plain ring, of SDPA at the global shape and the bound."""
    from opensora_torch.ops import flash_attention as fa
    from opensora_torch.ops import ring_flash as rf
    from opensora_torch.parallel.comm import gather, shard

    mesh = ring_mesh(device)
    devices = rf.ring_devices(mesh, "sp")
    sp = len(devices)
    gen = torch.Generator(device=device).manual_seed(9)
    cases = []
    for name, (b, h, l, d), cb in RING_CASES:
        q, k, v, do = (torch.randn((b, h, l, d), generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
        sm = 1.0 / math.sqrt(d)
        qs, ks, vs, dos = (shard(x, 2, devices) for x in (q, k, v, do))
        lloc = l // sp

        def plain_fwd():
            outs, lses = rf.ring_forward_shards(qs, ks, vs, sm_scale=sm, causal_block=cb, plain=True)
            return gather(outs, 2, device).float(), gather(lses, 2, device)

        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out, lse = rf.ring_flash_attention(qg, kg, vg, mesh, causal_block=cb)
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        torch.cuda.synchronize()
        ref_out, ref_lse = plain_fwd()
        scale = ref_out.abs().max().item()
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        outs_k, lses_k = shard(out.detach(), 2, devices), shard(lse, 2, devices)

        def plain_bwd():
            return [gather(g, 2, device).float()
                    for g in rf.ring_backward_shards(qs, ks, vs, outs_k, lses_k, dos, sm_scale=sm, causal_block=cb,
                                                     plain=True)]

        ref_g = plain_bwd()
        g_scale = {n: r.abs().max().item() for n, r in zip("qkv", ref_g)}
        g_rel = {n: (g.float() - r).abs().max().item() / g_scale[n] for n, g, r in zip("qkv", grads, ref_g)}
        ok = (math.isfinite(err_out) and err_out <= OUT_RTOL * scale and err_lse <= LSE_TOL
              and all(math.isfinite(x) and x <= BWD_RTOL for x in g_rel.values()))

        def fwd_reading():
            o, s = plain_fwd()
            return ((o - ref_out).abs().max().item() / scale, (s - ref_lse).abs().max().item())

        def bwd_reading():
            return max((g - r).abs().max().item() / g_scale[n] for n, g, r in zip("qkv", plain_bwd(), ref_g))

        mutants = {}
        with patched(rf, "ring_fwd_hop_ref", last_hop_skipped):
            mutants["last_hop_skipped"] = fwd_reading()
        if cb is not None:
            with patched(rf, "ring_fwd_hop_ref", local_offsets):
                mutants["local_offsets"] = fwd_reading()
        with patched(rf, "ring_fwd_hop_ref", middle_hop_from_zero(lloc, 0)):  # rank 1, hop 1
            mutants["middle_hop_from_zero"] = fwd_reading()
        with patched(rf, "ring_fwd_hop_ref", l_on_every_quad_lane):
            mutants["l_on_every_quad_lane"] = fwd_reading()
        with patched(rf, "ring_fwd_hop_ref", consumer_rows_from_other):
            mutants["consumer_rows_from_other"] = fwd_reading()
        with patched(rf, "ring_bwd_hop_ref", delta_left_out):
            mutants["delta_left_out"] = bwd_reading()
        with patched(rf, "home_slot", lambda f: lambda n: 1 - f(n)):
            mutants["dkdv_from_other_slot"] = bwd_reading()
        with patched(rf, "ring_bwd_hop_ref", dkv_add_dropped(lloc, 0)):  # rank 1, hop 1
            mutants["one_hop_dkdv_add_dropped"] = bwd_reading()
        caught = all((r[0] > OUT_RTOL or r[1] > LSE_TOL) if isinstance(r, tuple) else r > BWD_RTOL
                     for r in mutants.values())
        del ref_out, ref_lse, ref_g, grads

        # the 16 (rank, hop) launches of each kernel back to back on one
        # stream, on the shards each hop holds (no copies)
        state = [tuple(torch.empty(s, dtype=torch.float32, device=device) for s in ((b, h, lloc), (b, h, lloc),
                                                                                    (b, h, lloc, d)))
                 for _ in range(sp)]
        o_buf = [torch.empty_like(x) for x in qs]
        lse_buf = [torch.empty((b, h, lloc), dtype=torch.float32, device=device) for _ in range(sp)]
        deltas = [(x.float() * o.float()).sum(-1) for x, o in zip(dos, outs_k)]
        acc_kv = torch.zeros((2, b, h, lloc, d), dtype=torch.float32, device=device)
        acc_q = torch.zeros((b, h, fa.dq_accum_rows(lloc, d), d), dtype=torch.float32, device=device)

        def hops(kernel):
            for r in range(sp):
                for hop in range(sp):
                    src = (r - hop) % sp
                    kw = dict(sm_scale=sm, causal_block=cb, q_off=r * lloc, k_off=src * lloc)
                    if kernel == "ring_flash_fwd":
                        rf.ring_fwd_hop(qs[r], ks[src], vs[src], state[r], o_buf[r], lse_buf[r],
                                        first=hop == 0, last=hop == sp - 1, **kw)
                    else:
                        rf.ring_bwd_hop(qs[r], ks[src], vs[src], dos[r], lses_k[r], deltas[r], acc_kv[0],
                                        acc_kv[1], acc_q, **kw)

        big = b * h * l * l > 1e8
        iters = 5 if big else 20
        mask = None
        if cb is not None:
            idx = torch.arange(l, device=device) // cb
            mask = idx[None, :] <= idx[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the forward's 16 hop launches, the ring call and SDPA at the global
        # shape in turns (back-to-back readings spread: compare ranges)
        timed = dict(fwd_hops=lambda: hops("ring_flash_fwd"),
                     call=lambda: rf.ring_flash_attention(q, k, v, mesh, causal_block=cb),
                     sdpa=lambda: sdpa(q, k, v, attn_mask=mask))
        turns = {key: [] for key in timed}
        for key in ("fwd_hops", "call", "sdpa", "sdpa", "call", "fwd_hops") * 2:
            turns[key].append(time_cuda(timed[key], iters))
        mean = {key: sum(v) / len(v) for key, v in turns.items()}
        kernels_ms = {"ring_flash_fwd": mean["fwd_hops"],
                      "ring_flash_bwd_fused": time_cuda(lambda: hops("ring_flash_bwd_fused"), iters)}
        call_ms, library_ms = mean["call"], mean["sdpa"]
        bwd_call_ms = time_cuda(lambda: rf.ring_backward_shards(qs, ks, vs, outs_k, lses_k, dos, sm_scale=sm,
                                                                causal_block=cb), iters)
        plain_ms = time_cuda(plain_fwd, 1 if big else 3, warmup=0)
        plain_bwd_ms = time_cuda(plain_bwd, 1 if big else 3, warmup=0)
        library_bwd_ms = sdpa_backward_ms(q, k, v, do, mask, iters)
        bound_ms, bound_by = attention_bound(b, h, l, d, cb)
        bounds = {n: bwd_bound(n, b, h, l, d, cb) for n in ("flash_attention_bwd_fused", "minimal")}
        case = dict(name=name, shape=[b, h, l, d], sp=sp, local_length=lloc, causal_block=cb,
                    max_abs_err=err_out, ref_max_abs=scale, rel_err=err_out / scale, lse_max_abs_err=err_lse,
                    grad_rel_err=g_rel, grad_max_abs_err={n: g_rel[n] * g_scale[n] for n in g_rel},
                    mutants=mutants, kernels_ms=kernels_ms, call_ms=call_ms, bwd_call_ms=bwd_call_ms,
                    fwd_turns_ms=turns,
                    plain_ms=plain_ms, plain_bwd_ms=plain_bwd_ms, library_ms=library_ms,
                    library_bwd_ms=library_bwd_ms, bound_ms=bound_ms, bound_by=bound_by,
                    bwd_bound_ms={n: x[0] for n, x in bounds.items()},
                    bwd_bound_by={n: x[1] for n, x in bounds.items()})
        cases.append(case)
        log(f"[ring] {name} global {[b, h, l, d]} over {sp} logical ranks ({lloc} tokens a rank) cb={cb}: "
            f"out {err_out / scale:.3e} of max|ref| (tol {OUT_RTOL}) lse_err={err_lse:.3e} (tol {LSE_TOL}) "
            f"dq/dk/dv {g_rel['q']:.3e}/{g_rel['k']:.3e}/{g_rel['v']:.3e} (tol {BWD_RTOL}); wrong rings: "
            + ", ".join(f"{n} {r}" for n, r in mutants.items())
            + f" {'rejected' if caught else 'NOT REJECTED'}; in turns (ms, mean and range): 16 forward "
            + ", ".join(f"{label} {mean[n]:.3f} ({min(turns[n]):.3f}-{max(turns[n]):.3f})"
                        for label, n in (("launches", "fwd_hops"), ("the call", "call"), ("SDPA", "sdpa")))
            + f"; 16 backward launches {kernels_ms['ring_flash_bwd_fused']:.3f} ms"
            + f" bwd_call_ms={bwd_call_ms:.3f} bound_ms fwd/bwd="
            f"{bound_ms:.3f}/{bounds['flash_attention_bwd_fused'][0]:.3f} "
            f"plain_ms={plain_ms:.3f} plain_bwd_ms={plain_bwd_ms:.3f} "
            f"sdpa_bwd_ms={library_bwd_ms:.3f} {'OK' if ok and caught else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the ring kernels disagree with the plain ring at {name}")
        if not caught:
            raise AssertionError(f"the limits at {name} do not reject a known-wrong ring")
        del q, k, v, do, qs, ks, vs, dos, out, lse, state, o_buf, acc_kv, acc_q, mask
        torch.cuda.empty_cache()
    return {"cases": cases}


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------


def check_small_input(device, mesh=None) -> dict:
    """The main path's models at full width on a small input: the card's
    path (bf16 weights, the CUDA kernel at D=128 and at D=512 frame-causal)
    against the port's plain path on the CPU (fp32 copies of the same
    weights, plain attention). With ``mesh`` (phase 3d) the card's MMDiT
    runs ``attn_backend="ring_rdma"`` over the mesh's logical ranks (the
    ring kernels, 20 tokens a rank) and the VAE is left out."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import build_img_ids

    cfg = parse_configs([os.path.join(REPO, "configs", "diffusion", "inference", "256px.py")])
    gen = torch.Generator().manual_seed(1)

    def twins(conf: dict, card_conf=None):
        torch.manual_seed(0)
        card = build_module(dict(conf, **(card_conf or {})), MODELS, device=device).eval()
        cpu = build_module(dict(conf, dtype="fp32"), MODELS, device="meta").eval()
        cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()}, assign=True)
        return card, cpu  # CPU tensors take the plain attention

    def rel_err(card_out, cpu_out):
        return float((card_out.float().cpu() - cpu_out).abs().max() / cpu_out.abs().max().clamp(min=1.0))

    res = {}
    mcfg = dict(cfg.model, depth=1, depth_single_blocks=1)
    card, cpu = twins(mcfg, dict(attn_backend="ring_rdma") if mesh is not None else None)
    b, lt = 3, 32
    img_ids = build_img_ids(2, 8, 12, bs=b)  # 2 x 4 x 6 = 48 image tokens
    inputs = dict(
        img=torch.randn(b, 48, mcfg["in_channels"], generator=gen), img_ids=img_ids,
        txt=torch.randn(b, lt, mcfg["context_in_dim"], generator=gen), txt_ids=torch.zeros(b, lt, 3),
        timesteps=torch.rand(b, generator=gen), y_vec=torch.randn(b, mcfg["vec_in_dim"], generator=gen),
        cond=torch.zeros(b, 48, mcfg["in_channels"] + 4), guidance=torch.full((b,), 7.5),
    )
    _build.LAUNCHES.clear()
    set_mesh(mesh)
    try:
        with torch.inference_mode():
            ref = cpu(**inputs)
            out = card(**{k: v.to(device) for k, v in inputs.items()})
    finally:
        set_mesh(None)
    launches = dict(_build.LAUNCHES)
    res["mmdit_1+1_rel_err"] = rel_err(out, ref)
    del card, cpu
    if mesh is not None:
        torch.cuda.empty_cache()
        expect = {"ring_flash_fwd": 2 * RING_SP * RING_SP}
        ok = res["mmdit_1+1_rel_err"] <= SMALL_TOL and launches == expect
        log(f"[small] ring_rdma over {RING_SP} logical ranks: full-width MMDiT depth 1+1 (B=3, 80 tokens), card "
            f"bf16 + ring kernels vs CPU fp32 plain dense attention: {res} (tol {SMALL_TOL} of the output's "
            f"scale) launches {launches} (expected {expect}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's ring path disagrees with the plain path on a small input")
        return dict(res, launches=launches)

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


def check_int8_small_input(device) -> dict:
    """The int8 serving path's model at full width on a small input (1 + 1
    blocks, 160 tokens so that int8 attention engages): the card's W8A8 +
    int8_qk8 path (the kernels) against the port's plain int8 path on the
    CPU, fp32 around the same int8 weights; and, as a reading, the card's
    int8 path against its bf16 path on the same float weights."""
    from opensora_torch.ops.quant import quantize_model_
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import build_img_ids

    cfg = parse_configs([INT8_CFG])
    mode, backend = cfg.model["quantized"], cfg.model["attn_backend"]
    mcfg = dict(cfg.model, depth=1, depth_single_blocks=1, quantized=False)
    torch.manual_seed(0)
    card_bf16 = build_module(dict(mcfg, attn_backend=None), MODELS, device=device).eval()
    card = build_module(dict(mcfg), MODELS, device="meta").eval()
    card.load_state_dict(card_bf16.state_dict(), assign=True)
    card = card.to(device)
    quantize_model_(card, mode)
    cpu = build_module(dict(mcfg, quantized=mode, dtype="fp32"), MODELS, device="meta").eval()
    cpu.load_state_dict({k: (v.float() if v.is_floating_point() else v).cpu() for k, v in card.state_dict().items()},
                        assign=True)
    gen = torch.Generator().manual_seed(6)
    b, lt = 3, 32
    img_ids = build_img_ids(2, 16, 16, bs=b)  # 2 x 8 x 8 = 128 image tokens
    n_img = img_ids.shape[1]
    inputs = dict(
        img=torch.randn(b, n_img, mcfg["in_channels"], generator=gen), img_ids=img_ids,
        txt=torch.randn(b, lt, mcfg["context_in_dim"], generator=gen), txt_ids=torch.zeros(b, lt, 3),
        timesteps=torch.rand(b, generator=gen), y_vec=torch.randn(b, mcfg["vec_in_dim"], generator=gen),
        cond=torch.zeros(b, n_img, mcfg["in_channels"] + 4), guidance=torch.full((b,), 7.5),
    )
    from opensora_torch.ops import _build

    before = dict(_build.LAUNCHES)
    with torch.inference_mode():
        ref = cpu(**inputs)
        on_card = {k: v.to(device) for k, v in inputs.items()}
        out = card(**on_card).float().cpu()
        out_bf16 = card_bf16(**on_card).float().cpu()
    launched = {k: _build.LAUNCHES[k] - before.get(k, 0) for k in ("w8a8_matmul", "int8_flash_attention")}
    res = {
        "int8_card_vs_int8_cpu_rel_err": float((out - ref).abs().max() / ref.abs().max().clamp(min=1.0)),
        "int8_vs_bf16_on_card_rel_l2": float((out - out_bf16).norm() / out_bf16.norm()),
        "launches": launched,
    }
    del card, card_bf16, cpu
    torch.cuda.empty_cache()
    ok = res["int8_card_vs_int8_cpu_rel_err"] <= SMALL_TOL and launched == {"w8a8_matmul": 13,
                                                                             "int8_flash_attention": 2}
    log(f"[small] int8 path ({mode}, {backend}), full-width MMDiT depth 1+1 (B=3, {n_img + lt} tokens), card "
        f"kernels vs CPU plain int8 path on the same int8 weights: {json.dumps(res)} (tol {SMALL_TOL} of the "
        f"output's scale; launches 10 + 3 GEMMs, 2 attentions) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's int8 path disagrees with the plain int8 path on a small input")
    return res


KERNEL_KINDS = [  # first match wins: int8_flash_fwd_kernel before flash_fwd_kernel
    ("int8_flash_attention", ("int8_flash_fwd_kernel",)),
    ("ring_flash_fwd", ("ring_fwd_sm90_kernel",)),
    ("ring_flash_bwd_fused", ("ring_bwd_fused_kernel",)),
    ("w8a8_fq_matmul", ("w8a8_sm90_kernel<false",)),  # the template's A_INT8 = false
    ("w8a8_gemm", ("w8a8_sm90_kernel<true",)),
    ("flash_attention_fwd_sm90", ("flash_fwd_sm90_kernel",)),
    ("flash_attention_fwd_d512", ("flash_fwd_d512_kernel",)),
    ("flash_attention_bwd_fused", ("flash_bwd_fused_kernel",)),
    ("flash_attention_bwd_dq_convert", ("flash_bwd_dq_convert_kernel",)),
    ("flash_attention_bwd_d512", ("flash_bwd_d512_kernel",)),
    ("flash_attention_bwd_d512_dq_convert", ("flash_bwd_d512_dq_convert_kernel",)),
    ("conv (cuDNN)", ("conv", "fprop", "cudnn", "dgrad", "wgrad")),
    ("gemm (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
]


def profile_run(fn, tag: str, out_dir) -> dict:
    """Device time by kernel kind and the device's idle share over one more
    run of ``fn`` under torch.profiler; the full table goes to
    ``out_dir``/profile_``tag``.txt if given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = {name: 0.0 for name, _ in KERNEL_KINDS}
    groups["other"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = e.key.lower()
        kind = next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")
        groups[kind] += us
    busy_s = sum(groups.values()) / 1e6
    out = {"wall_s": wall_s, "kernel_s": {k: v / 1e6 for k, v in groups.items()},
           "device_idle_share": max(0.0, 1.0 - busy_s / wall_s)}
    if out_dir:
        with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
            f.write(json.dumps(out) + "\n")
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    log(f"[profile {tag}] " + json.dumps(out))
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
    # with one mid-block attention (D = 512)
    n_vae = 2
    expect = {"flash_attention_fwd_sm90": n_blocks * STEPS, "flash_attention_fwd_d512": n_vae}
    log(f"[main] launches={launches} expected={expect} ({n_blocks}x{STEPS} MMDiT at D = 128, {n_vae} VAE at "
        f"D = 512)")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    res = dict(launches=launches, text_encode_s=timings["text_encode_s"], step_s=timings["step_s"],
               decode_s=timings["decode_s"], total_s=total_s, peak_mem_gb=peak_gb,
               outside_share=outside, models_build_s=build_s)
    if profile:
        res["profile"] = profile_run(lambda: api_fn(**run_kwargs), "main", out_dir)
    return res, dict(cfg=cfg, models=(model, ae, t5, clip), video=x.cpu(), run_kwargs=run_kwargs)


# ----------------------------------------------------------------------
# phase 9: the main path with ring_rdma over logical ranks
# ----------------------------------------------------------------------

# The ring_rdma video vs the dense (phase 4) video from the same seed and
# prompt, and the "ring" (ops/sp.py) video vs the ring_rdma one, each in
# relative L2. Set from the card's readings: 0.0470 and 0.0414 (both paths
# bf16: the random-weight 57-block MMDiT carries the different rounding of
# the two attentions through 2 steps into a few percent of the video), and
# the control, the ring with its last hop skipped, 0.0767, which must exceed
# the limit. The kernels are deterministic (no atomics), so the readings
# repeat; the margin is 1.28x on either side.
RING_VIDEO_TOL = 0.06
RING_SP_STEPS = 1  # steps of the attn_backend="ring" run


def set_attn_backend(model, backend) -> None:
    for block in (*model.double_blocks, *model.single_blocks):
        block.attn_backend = backend


def run_ring_path(device, built, profile: bool = False, out_dir=None) -> dict:
    """256px.py at full width and depth with the MMDiT's attention over
    RING_SP logical ranks on the card (phase 4's models, their blocks
    switched to ``attn_backend="ring_rdma"``), through prepare_api(mesh=...)
    and api_fn: shape, finiteness, exact launches, and the video against
    phase 4's; then one step with ``attn_backend="ring"``."""
    from opensora_torch.ops import _build
    from opensora_torch.ops import ring_flash as rf
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg, (model, ae, t5, clip), dense = built["cfg"], built["models"], built["video"]
    mesh = ring_mesh(device)
    log(f"[ring] 256px.py at full width and depth, attn_backend=ring_rdma over {mesh}; num_steps cut 50 -> {STEPS}")
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    hops = RING_SP * RING_SP

    def run(backend, steps):
        set_attn_backend(model, backend)
        api_fn = prepare_api(model, ae, t5, clip, mesh=mesh)
        opt = sanitize_sampling_option(SamplingOption(**dict(cfg.sampling_option, num_steps=steps)))
        _build.LAUNCHES.clear()
        timings: dict = {}
        t0 = time.perf_counter()
        x = api_fn(**dict(built["run_kwargs"], opt=opt), timings=timings)
        torch.cuda.synchronize()
        return x, dict(_build.LAUNCHES), dict(timings, total_s=time.perf_counter() - t0)

    def rel_l2(a, b):
        return float((a.float().cpu() - b).norm() / b.norm())

    try:
        torch.cuda.reset_peak_memory_stats(device)
        x, launches, timings = run("ring_rdma", STEPS)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        finite = bool(torch.isfinite(x).all())
        outside = float((x.abs() > 1.0).float().mean())
        expect = {"ring_flash_fwd": n_blocks * STEPS * hops, "flash_attention_fwd_d512": 2}
        video_rel = rel_l2(x, dense)
        x_ring_rdma = x.cpu()
        del x
        with patched(rf, "ring_fwd_hop", last_hop_skipped):
            control_rel = rel_l2(run("ring_rdma", STEPS)[0], dense)
        x1, _, _ = run("ring_rdma", RING_SP_STEPS)
        xs, sp_launches, sp_timings = run("ring", RING_SP_STEPS)
        sp_rel = rel_l2(xs, x1.cpu())
        sp_expect = {"flash_attention_fwd_sm90": n_blocks * RING_SP_STEPS * hops, "flash_attention_fwd_d512": 2}
        del x1, xs
    finally:
        set_attn_backend(model, cfg.model.get("attn_backend"))
        set_mesh(None)
    res = dict(mesh=repr(mesh), launches=launches, expected=expect, text_encode_s=timings["text_encode_s"],
               step_s=timings["step_s"], decode_s=timings["decode_s"], total_s=timings["total_s"],
               peak_mem_gb=peak_gb, outside_share=outside, video_rel_l2_vs_dense=video_rel,
               control_last_hop_skipped_rel_l2=control_rel, tol=RING_VIDEO_TOL,
               sp_ring=dict(steps=RING_SP_STEPS, launches=sp_launches, expected=sp_expect,
                            step_s=sp_timings["step_s"], video_rel_l2_vs_ring_rdma=sp_rel))
    log("[ring] " + json.dumps(res))
    if tuple(x_ring_rdma.shape) != tuple(dense.shape):
        raise AssertionError(f"output shape {tuple(x_ring_rdma.shape)} != {tuple(dense.shape)}")
    if not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"ring output not finite, or {outside:.4f} of it outside [-1, 1]")
    if launches != expect or sp_launches != sp_expect:
        raise AssertionError(f"kernel launches {launches} / {sp_launches} != expected {expect} / {sp_expect}")
    if not (video_rel <= RING_VIDEO_TOL < control_rel and sp_rel <= RING_VIDEO_TOL):
        raise AssertionError(f"ring videos: vs dense {video_rel:.4e}, ring vs ring_rdma {sp_rel:.4e} (tol "
                             f"{RING_VIDEO_TOL}); the control {control_rel:.4e} must exceed the tolerance")
    if profile:
        set_attn_backend(model, "ring_rdma")
        api_fn = prepare_api(model, ae, t5, clip, mesh=mesh)
        try:
            res["profile"] = profile_run(lambda: api_fn(**built["run_kwargs"]), "ring", out_dir)
        finally:
            set_attn_backend(model, cfg.model.get("attn_backend"))
            set_mesh(None)
    return res


# ----------------------------------------------------------------------
# phase 5: the training path
# ----------------------------------------------------------------------

LORA_CFG = os.path.join(REPO, "configs", "diffusion", "train", "lora.py")
# the card cannot hold the "dots" checkpoints of stage1.py at this bucket
# beside the weights (about 77 GB); full recompute is a listed cut
TRAIN_OVERRIDES = ["--model.from_pretrained", "", "--ae.from_pretrained", "", "--model.remat_policy", "full"]


def check_train_small_input(device, mesh=None) -> dict:
    """One LoRA train step of the full-width MMDiT at depth 1 + 1 on a small
    batch: the card's bf16 path (flash forward and backward kernels) vs the
    CPU's fp32 plain path, same weights, factors, batch and draws. With
    ``mesh`` (phase 3d) the card's MMDiT runs ``attn_backend="ring_rdma"``
    over the mesh's logical ranks: the ring kernels and the dQ epilogue."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.training.diffusion import compute_loss, compute_shift_alpha
    from opensora_torch.training.lora import apply_lora, lora_parameters
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import build_img_ids

    cfg = parse_configs([LORA_CFG, *TRAIN_OVERRIDES])
    mcfg = dict(cfg.model, depth=1, depth_single_blocks=1)
    torch.manual_seed(0)
    card = build_module(dict(mcfg, attn_backend="ring_rdma" if mesh is not None else mcfg.get("attn_backend")),
                        MODELS, device=device)
    cpu = build_module(dict(mcfg, dtype="fp32"), MODELS, device="meta")
    cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()}, assign=True)
    rank = cfg.lora_config["r"]
    apply_lora(card, rank, 1.0)
    apply_lora(cpu, rank, 1.0)
    gen = torch.Generator().manual_seed(3)
    card_f, cpu_f = lora_parameters(card), lora_parameters(cpu)
    with torch.no_grad():  # nonzero B, so that both factors take gradients
        for n, p in cpu_f.items():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.02 if n.endswith("lora_B") else 1.0 / rank))
            card_f[n].copy_(p)

    b, t, h, w, lt = 3, 2, 8, 12, 32
    n_img = t * (h // 2) * (w // 2)
    bf = lambda *shape: torch.randn(shape, generator=gen).to(torch.bfloat16).float()  # noqa: E731
    batch = dict(
        x0=bf(b, n_img, mcfg["in_channels"]), img_ids=build_img_ids(t, h, w, bs=b), txt=bf(b, lt, mcfg["context_in_dim"]),
        txt_ids=torch.zeros(b, lt, 3), y_vec=bf(b, mcfg["vec_in_dim"]), cond=bf(b, n_img, mcfg["in_channels"] + 4),
        shift_alpha=torch.full((b,), compute_shift_alpha(h, w, t)),
    )
    draws = dict(t=torch.rand(b, generator=gen), x1=torch.randn(b, n_img, mcfg["in_channels"], generator=gen))

    def step(model, factors, dev, dtype):
        on = {k: v.to(dev, dtype if k in ("x0", "txt", "y_vec", "cond") else v.dtype) for k, v in batch.items()}
        loss = compute_loss(model, on, **{k: v.to(dev) for k, v in draws.items()})
        loss.backward()
        return loss.item(), {n: p.grad.float().cpu() for n, p in factors.items()}

    _build.LAUNCHES.clear()
    set_mesh(mesh)
    try:
        loss_card, g_card = step(card, card_f, device, torch.bfloat16)
    finally:
        set_mesh(None)
    launches = dict(_build.LAUNCHES)
    loss_cpu, g_cpu = step(cpu, cpu_f, "cpu", torch.float32)
    grad_rel = {n: float((g_card[n] - g).abs().max() / g.abs().max()) for n, g in g_cpu.items()}
    worst = max(grad_rel, key=grad_rel.get)
    res = {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst": worst,
           "grad_rel_err_median": sorted(grad_rel.values())[len(grad_rel) // 2], "launches": launches}
    del card, cpu
    torch.cuda.empty_cache()
    ok = res["loss_rel_err"] <= SMALL_TOL and res["grad_rel_err_max"] <= TRAIN_GRAD_TOL
    n_fwd = 4 if mcfg.get("remat") else 2  # 2 blocks: forward (and recompute with remat), backward
    if mesh is not None:  # 16 hop launches a call, one dQ epilogue per rank and backward call
        hops = RING_SP * RING_SP
        ok = ok and launches == {"ring_flash_fwd": n_fwd * hops, "ring_flash_bwd_fused": 2 * hops,
                                 "flash_attention_bwd_dq_convert": 2 * RING_SP}
    else:
        ok = ok and launches == {"flash_attention_fwd_sm90": n_fwd, "flash_attention_bwd_fused": 2,
                                 "flash_attention_bwd_dq_convert": 2}
    log(f"[small] LoRA train step{f' (ring_rdma over {RING_SP} logical ranks)' if mesh is not None else ''}, "
        f"full-width MMDiT depth 1+1 (B=3, {n_img + lt} tokens, r={rank}), card bf16 + "
        f"kernels vs CPU fp32 plain: {json.dumps(res)} (tol loss {SMALL_TOL}, each LoRA gradient "
        f"{TRAIN_GRAD_TOL} of its scale) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's train step disagrees with the plain step on a small input")
    return res


def run_train_path(device, profile: bool = False, out_dir=None) -> dict:
    from opensora_torch.datasets.aspect import get_resolution_with_aspect_ratio
    from opensora_torch.ops import _build
    from opensora_torch.train import Trainer
    from opensora_torch.training.lora import lora_parameters
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.optimizer import global_norm
    from opensora_torch.utils.train import single_frame_encodes

    cfg = parse_configs([LORA_CFG, *TRAIN_OVERRIDES])
    n_frames = TRAIN_FRAMES
    height, width = get_resolution_with_aspect_ratio(TRAIN_RESOLUTION)[1][TRAIN_RATIO]
    log(f"[train] lora.py at full width and depth, r={cfg.lora_config['r']}, remat_policy=full; "
        f"{TRAIN_STEPS} steps at the {n_frames}-frame {height}x{width} bucket, B={TRAIN_BATCH}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b_factors = [p for n, p in lora_parameters(trainer.model).items() if n.endswith("lora_B")]
    n_lora = sum(p.numel() for p in lora_parameters(trainer.model).values())
    log(f"[train] models built on {device} in {build_s:.1f} s; {n_lora / 1e9:.3f}B LoRA params; "
        f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated")

    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    video = torch.rand((TRAIN_BATCH, 3, n_frames, height, width), generator=gen, device=device) * 2 - 1
    batch = {"video": video, "text": [
        "a red panda eating bamboo in a misty forest",
        "waves breaking on a rocky shore at sunset",
        "a city street at night in the rain, neon signs",
    ]}
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    steps = []
    for i in range(TRAIN_STEPS):
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        metrics = trainer.run_batch(batch)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        times = trainer.timers.to_dict()
        n_vae = TRAIN_BATCH + single_frame_encodes(trainer.mask_conds)  # one mid-block attention per encode
        expect = {"flash_attention_fwd_sm90": 2 * n_blocks,  # forward and recompute
                  "flash_attention_fwd_d512": n_vae,  # the VAE encodes' mid-block (D = 512)
                  "flash_attention_bwd_fused": n_blocks, "flash_attention_bwd_dq_convert": n_blocks}
        rec = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                   lora_b_norm=float(global_norm(b_factors)), mask_conds=trainer.mask_conds,
                   lr=trainer.state.optimizer.adamw.param_groups[0]["lr"], launches=launches, expected=expect,
                   encode_video_s=times["time/encode_video"], encode_text_s=times["time/encode_text"],
                   step_s=times["time/step"], total_s=total_s)
        steps.append(rec)
        log(f"[train] step {i + 1}: " + json.dumps(rec))
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0):
            raise AssertionError(f"step {i + 1}: loss {rec['loss']} or grad norm {rec['grad_norm']} not finite and > 0")
        if launches != expect:
            raise AssertionError(f"step {i + 1}: kernel launches {launches} != expected {expect}")
    # lr = 0 on the first update (warmup from 0, as optax): B stays 0, then moves
    if not (steps[0]["lora_b_norm"] == 0.0 < steps[1]["lora_b_norm"]):
        raise AssertionError(f"LoRA B norms {[r['lora_b_norm'] for r in steps]}: not 0 after step 1 and > 0 after step 2")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    total = {k: sum(r["launches"].get(k, 0) for r in steps) for k in steps[0]["expected"]}
    log(f"[train] {TRAIN_STEPS} steps OK; launches {total}; peak_mem_gb={peak_gb:.2f} (limit 80)")
    if peak_gb >= 80:
        raise AssertionError(f"peak memory {peak_gb:.2f} GB")
    res = dict(steps=steps, launches=total, peak_mem_gb=peak_gb, models_build_s=build_s, lora_params=n_lora)
    if profile:
        res["profile"] = profile_run(lambda: trainer.run_batch(batch), "train", out_dir)
    return res, dict(trainer=trainer, batch=batch)


RING_TRAIN_STEPS = 2  # LoRA steps of the ring training path (phase 10)


def run_ring_train_path(device, built, profile: bool = False, out_dir=None) -> dict:
    """Phase 5's trainer (lora.py at full width and depth) with its MMDiT's
    attention switched to ``ring_rdma`` over RING_SP logical ranks on the
    card: RING_TRAIN_STEPS steps of Trainer.run_batch; finite loss and
    gradient norm, moving LoRA factors, the exact launches of the ring
    kernels, the dQ epilogue (once per rank and backward call) and the VAE
    encode's flash forward."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.training.lora import lora_parameters
    from opensora_torch.utils.train import single_frame_encodes

    trainer, batch = built["trainer"], built["batch"]
    cfg = trainer.cfg
    mesh = ring_mesh(device)
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    hops = RING_SP * RING_SP
    factors = list(lora_parameters(trainer.model).values())
    log(f"[ring_train] lora.py (phase 5's trainer), attn_backend=ring_rdma over {mesh}; {RING_TRAIN_STEPS} steps")
    set_attn_backend(trainer.model, "ring_rdma")
    set_mesh(mesh)
    steps = []
    try:
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(RING_TRAIN_STEPS):
            before = [p.detach().clone() for p in factors]
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            metrics = trainer.run_batch(batch)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            n_vae = TRAIN_BATCH + single_frame_encodes(trainer.mask_conds)
            expect = {"flash_attention_fwd_d512": n_vae, "ring_flash_fwd": 2 * n_blocks * hops,
                      "ring_flash_bwd_fused": n_blocks * hops, "flash_attention_bwd_dq_convert": n_blocks * RING_SP}
            moved = sum(float((p.detach() - b).abs().max()) > 0 for p, b in zip(factors, before))
            times = trainer.timers.to_dict()
            rec = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]), launches=launches,
                       expected=expect, factors_moved=moved, factors=len(factors),
                       step_s=times["time/step"], total_s=total_s)
            steps.append(rec)
            log(f"[ring_train] step {i + 1}: " + json.dumps(rec))
            if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0):
                raise AssertionError(f"ring step {i + 1}: loss {rec['loss']} or grad norm {rec['grad_norm']}")
            if launches != expect:
                raise AssertionError(f"ring step {i + 1}: kernel launches {launches} != expected {expect}")
            if moved == 0:
                raise AssertionError(f"ring step {i + 1}: no LoRA factor moved")
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        res = dict(mesh=repr(mesh), steps=steps, peak_mem_gb=peak_gb,
                   launches={k: sum(r["launches"].get(k, 0) for r in steps) for k in steps[0]["expected"]})
        if profile:
            res["profile"] = profile_run(lambda: trainer.run_batch(batch), "ring_train", out_dir)
    finally:
        set_attn_backend(trainer.model, cfg.model.get("attn_backend"))
        set_mesh(None)
    log(f"[ring_train] {RING_TRAIN_STEPS} steps OK; launches {res['launches']}; peak_mem_gb={peak_gb:.2f}")
    return res


# ----------------------------------------------------------------------
# phases 3c, 7 and 8: VAE training
# ----------------------------------------------------------------------

VAE_CFG = os.path.join(REPO, "configs", "vae", "train", "video_dc_ae_disc.py")
VAE_STEPS = 3  # HunyuanVAE steps of phase 7
DCAE_STEPS = 2  # DC-AE steps of phase 8
VAE_RES = 256  # the training configs' resolution (256px_ar1:1)
# The card's bf16 VAE train step (kernels) vs the CPU's fp32 plain step at
# full width on a small clip: the loss to SMALL_TOL; each gradient of the
# mid-block attention projections in relative L2 (|g - ref| / |ref|) to
# VAE_GRAD_TOL. The gradient passes back through the decoder's and then the
# encoder's bf16 convolutions (a dozen each) before it reaches the
# encoder's attention, and the query and key gradients go through the
# softmax's derivative: the card read 0.019 to 0.063. The check also shows
# that the limit rejects the gradients of two known-wrong backwards: delta
# left out of dS, and dK's last 128-column slice (one block of the D split
# of the kernel the D = 512 backward replaced) left at 0, which costs the
# key projection's gradient a quarter of its rows (about 0.5 in relative L2).
VAE_GRAD_TOL = 0.15


def vae_expected_launches(grad_checkpoint: bool) -> dict:
    """Kernel launches of one HunyuanVAE train step: the encoder's and the
    decoder's mid-block attention once each forward (twice with
    grad_checkpoint: the recompute), and each backward once; the
    discriminator, LPIPS and the adaptive weight's heads run no kernel."""
    return {"flash_attention_fwd_d512": 4 if grad_checkpoint else 2,
            "flash_attention_bwd_d512": 2, "flash_attention_bwd_d512_dq_convert": 2}


def check_vae_train_small_input(device) -> dict:
    """One full-width HunyuanVAE train step (the generator's loss: L1 under
    the log-variance and the KL, backward) on a 5 x 64 x 64 clip: the card
    (fp32 master weights, bf16 compute, the D = 512 flash forward, backward
    and dQ epilogue kernels at 128 tokens, frames of 64) against the CPU's fp32
    plain step with the same weights, video and posterior noise."""
    from opensora_torch.models.vae2d.losses import vae_loss
    from opensora_torch.ops import _build
    from opensora_torch.ops import flash_attention as fa
    from opensora_torch.utils.ckpt import init_ae
    from opensora_torch.utils.config import parse_configs

    cfg = parse_configs([VAE_CFG, "--model.type", "hunyuan_vae"])
    card = init_ae(dict(cfg.model), device, cfg.seed, param_dtype="fp32")
    cpu = init_ae(dict(cfg.model, dtype="fp32"), "meta", cfg.seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, assign=True)
    gen = torch.Generator().manual_seed(7)
    video = torch.rand((1, 3, 5, 64, 64), generator=gen) * 2 - 1
    noise = torch.randn((1, card.config.latent_channels, 2, 8, 8), generator=gen)
    names = [n for n, _ in card.named_parameters() if ".attentions." in n and n.endswith("weight")
             and "group_norm" not in n]

    def step(model, dev):
        model.zero_grad(set_to_none=True)
        logvar = torch.zeros((), device=dev)
        x_rec, posterior, _ = model(video.to(dev), noise=noise.to(dev))
        losses = vae_loss(video.to(dev), x_rec, posterior, logvar)
        loss = losses["nll_loss"] + losses["kl_loss"]
        loss.backward()
        params = dict(model.named_parameters())
        return loss.item(), {n: params[n].grad.float().cpu() for n in names}

    _build.LAUNCHES.clear()
    loss_card, g_card = step(card, device)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    loss_cpu, g_cpu = step(cpu, "cpu")
    plain_bwd = fa.flash_attention_bwd_ref

    def without_delta(q, k, v, do, lse, delta, *a):
        return plain_bwd(q, k, v, do, lse, 0 * delta, *a)

    def dk_slice_zeroed(*args):
        dq, dk, dv = plain_bwd(*args)
        return dq, torch.cat([dk[..., :-128], torch.zeros_like(dk[..., -128:])], -1), dv

    def rel_l2(grads):
        return {n: float((grads[n] - g).norm() / g.norm()) for n, g in g_cpu.items()}

    wrong = {}
    for name, bwd in (("delta_left_out", without_delta), ("dk_slice_3_zeroed", dk_slice_zeroed)):
        fa.flash_attention_bwd_ref = bwd
        try:  # the same CPU step through a known-wrong backward
            wrong[name] = max(rel_l2(step(cpu, "cpu")[1]).values())
        finally:
            fa.flash_attention_bwd_ref = plain_bwd

    grad_rel = rel_l2(g_card)
    res = {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": abs(loss_card - loss_cpu) / abs(loss_cpu),
           "grad_rel_l2": grad_rel, "grad_rel_max": {n: float((g_card[n] - g).abs().max() / g.abs().max())
                                                     for n, g in g_cpu.items()},
           "wrong_rel_l2": wrong, "launches": launches}
    del card, cpu
    torch.cuda.empty_cache()
    expect = vae_expected_launches(False)
    ok = (res["loss_rel_err"] <= SMALL_TOL and max(grad_rel.values()) <= VAE_GRAD_TOL < min(wrong.values())
          and launches == expect)
    log(f"[small] HunyuanVAE train step, full width, 5x64x64 clip (latent 2x8x8: 128 tokens, D=512, frames of 64), "
        f"card fp32 master / bf16 + kernels vs CPU fp32 plain: {json.dumps(res)} (tol loss {SMALL_TOL}, each "
        f"attention projection's gradient {VAE_GRAD_TOL} in relative L2, which each known-wrong backward must "
        f"exceed; launches {expect}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's VAE train step disagrees with the plain step on a small input")
    return res


def write_lpips_files(root: str) -> tuple:
    """Random-weight LPIPS files in the published layouts, from seed 0: a
    torchvision VGG16 state dict (``features.*``) and the LPIPS heads
    (``lin{i}.model.1.weight``)."""
    from opensora_torch.models.vae2d.lpips import LPIPS

    torch.manual_seed(0)
    sd = LPIPS().state_dict()
    vgg, heads = os.path.join(root, "vgg16.pth"), os.path.join(root, "lpips_heads.pth")
    torch.save({k[len("vgg."):]: v for k, v in sd.items() if k.startswith("vgg.")}, vgg)
    torch.save({k: v.abs() for k, v in sd.items() if k.startswith("lin")}, heads)
    return vgg, heads


def run_vae_train_path(device, model_type: str, steps: int, frames: int, lpips_files=None, tag="vae",
                       profile: bool = False, out_dir=None) -> dict:
    """``steps`` of VAETrainer.run_batch at full width on seeded frames x
    VAE_RES x VAE_RES batches of 1."""
    from opensora_torch.ops import _build
    from opensora_torch.train_vae import VAETrainer
    from opensora_torch.utils.config import parse_configs

    args = [VAE_CFG]
    if model_type != "dc_ae":
        args += ["--model.type", model_type]
    if lpips_files:
        args += ["--vgg_ckpt", lpips_files[0], "--lpips_ckpt", lpips_files[1]]
    cfg = parse_configs(args)
    log(f"[{tag}] video_dc_ae_disc.py{' --model.type ' + model_type if model_type != 'dc_ae' else ''} at full width, "
        f"LPIPS {'on (random-weight files)' if lpips_files else 'off (no vgg_ckpt)'}; {steps} steps on "
        f"{frames}x{VAE_RES}x{VAE_RES}, B=1")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer = VAETrainer(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_ae = sum(p.numel() for p in trainer.ae.parameters())
    n_disc = sum(p.numel() for p in trainer.disc.parameters())
    log(f"[{tag}] built on {device} in {build_s:.1f} s: AE {n_ae / 1e6:.1f} M params "
        f"({next(trainer.ae.parameters()).dtype}, compute {trainer.ae.dtype}), discriminator {n_disc / 1e6:.1f} M; "
        f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated")
    watch = {"ae": list(trainer.state.params.values()), "disc": list(trainer.state.disc_params.values())}
    before = {k: [p.detach().clone() for p in ps] for k, ps in watch.items()}
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    expect = vae_expected_launches(cfg.get("grad_checkpoint", False)) if model_type == "hunyuan_vae" else {}
    steps_out = []
    for i in range(steps):
        video = torch.rand((1, 3, frames, VAE_RES, VAE_RES), generator=gen, device=device) * 2 - 1
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        metrics = trainer.run_batch({"video": video})
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(launches=launches, expected=expect, step_s=total_s)
        steps_out.append(rec)
        log(f"[{tag}] step {i + 1}: " + json.dumps(rec))
        if not all(math.isfinite(v) for k, v in rec.items() if isinstance(v, float)):
            raise AssertionError(f"{tag} step {i + 1}: a loss is not finite: {rec}")
        if launches != expect:
            raise AssertionError(f"{tag} step {i + 1}: kernel launches {launches} != expected {expect}")
    moved = {k: sum(float((p.detach() - b).abs().max()) > 0 for p, b in zip(watch[k], before[k])) for k in watch}
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"[{tag}] {steps} steps OK; tensors moved: AE {moved['ae']}/{len(watch['ae'])}, discriminator "
        f"{moved['disc']}/{len(watch['disc'])}; peak_mem_gb={peak_gb:.2f} (limit 80)")
    if not (moved["ae"] and moved["disc"]):
        raise AssertionError(f"{tag}: parameters did not move: {moved}")
    if peak_gb >= 80:
        raise AssertionError(f"{tag}: peak memory {peak_gb:.2f} GB")
    total = {k: sum(r["launches"].get(k, 0) for r in steps_out) for k in expect}
    res = dict(model=model_type, steps=steps_out, launches=total, peak_mem_gb=peak_gb, build_s=build_s,
               ae_params=n_ae, disc_params=n_disc, moved=moved, lpips=bool(lpips_files))
    if profile:
        batch = {"video": torch.rand((1, 3, frames, VAE_RES, VAE_RES), generator=gen, device=device) * 2 - 1}
        res["profile"] = profile_run(lambda: trainer.run_batch(batch), tag, out_dir)
    del trainer, watch, before
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------
# phase 6: the int8 serving path
# ----------------------------------------------------------------------


def int8_expected_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` denoise steps (one batched-CFG forward
    each) and the VAE decode. Every block linear is a W8A8 product: 10 per
    double block (2 modulations, 2 qkv, 2 proj, 4 MLP), 3 per single block
    (modulation, linear1, linear2). In w8a8_fq mode the products with at
    least 1024 rows take the fused kernel; the modulations (3 rows) take the
    quantize-outside rule and w8a8_matmul. Every block runs one attention."""
    depth, single = cfg.model["depth"], cfg.model["depth_single_blocks"]
    per_forward = {"w8a8_matmul": 10 * depth + 3 * single}
    if cfg.model["quantized"] == "w8a8_fq":
        per_forward = {"w8a8_fq_matmul": 8 * depth + 2 * single, "w8a8_matmul": 2 * depth + single}
    attn = "int8_flash_attention_pv8" if cfg.model["attn_backend"] == "int8" else "int8_flash_attention"
    per_forward[attn] = depth + single
    out = {k: v * steps for k, v in per_forward.items()}
    out["flash_attention_fwd_d512"] = 2  # the VAE decode's two spatial tiles, one mid-block attention each
    return out


def run_int8_path(device, overrides, steps: int, profile: bool = False, out_dir=None, tag="int8") -> dict:
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([INT8_CFG, "--sampling_option.num_steps", str(steps), *overrides])
    log(f"[{tag}] 256px_int8attn.py{''.join(' ' + o for o in overrides)} at full width and depth (quantized="
        f"{cfg.model['quantized']}, attn_backend={cfg.model['attn_backend']}); num_steps cut 50 -> {steps}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model, ae, t5, clip = prepare_models(cfg, device=device, seed=cfg.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated(device) / 1e9
    build_peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"[{tag}] models built and the MMDiT quantized block by block on {device} in {build_s:.1f} s; "
        f"{resident_gb:.2f} GB resident, {build_peak_gb:.2f} GB peak during the build")
    torch.cuda.reset_peak_memory_stats(device)
    api_fn = prepare_api(model, ae, t5, clip)
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option))
    prompt = ["a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score."]
    run_kwargs = dict(opt=opt, cond_type=cfg.cond_type, seed=cfg.seed, text=prompt, channel=cfg.model["in_channels"])
    _build.LAUNCHES.clear()
    timings: dict = {}
    t0 = time.perf_counter()
    x = api_fn(**run_kwargs, timings=timings)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    expect_shape = (1, 3, opt.num_frames, opt.height, opt.width)
    finite = bool(torch.isfinite(x).all())
    outside = float((x.abs() > 1.0).float().mean())
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    expect = int8_expected_launches(cfg, steps)
    log(f"[{tag}] output {tuple(x.shape)} finite={finite} range=[{float(x.min()):.3f}, {float(x.max()):.3f}] "
        f"outside [-1, 1]: {outside:.4f} (limit {OUTSIDE_MAX}) text_encode_s={timings['text_encode_s']:.3f} "
        f"step_s={[round(s, 3) for s in timings['step_s']]} decode_s={timings['decode_s']:.3f} "
        f"total_s={total_s:.3f} peak_mem_gb={peak_gb:.2f} launches={launches} expected={expect}")
    if tuple(x.shape) != expect_shape:
        raise AssertionError(f"output shape {tuple(x.shape)} != {expect_shape}")
    if not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"output not finite, or {outside:.4f} of it outside [-1, 1]")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    res = dict(config=dict(quantized=cfg.model["quantized"], attn_backend=cfg.model["attn_backend"]),
               launches=launches, text_encode_s=timings["text_encode_s"], step_s=timings["step_s"],
               decode_s=timings["decode_s"], total_s=total_s, peak_mem_gb=peak_gb, resident_gb=resident_gb,
               build_peak_gb=build_peak_gb,
               outside_share=outside, models_build_s=build_s)
    if profile:
        res["profile"] = profile_run(lambda: api_fn(**run_kwargs), tag, out_dir)
    del model, ae, t5, clip, api_fn, x
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _kernel_name(mangled: str) -> str:
    """The kernel's name and template arguments from its mangled name (the
    length-prefixed identifier ending in "kernel", then Lb0/Lb1/Li<n>)."""
    import re

    for run in re.finditer(r"\d+", mangled):
        for j in range(len(run.group())):
            n = int(run.group()[j:])
            name = mangled[run.end():run.end() + n]
            if n and name.endswith("kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                rest = mangled[run.end() + n:]
                args = re.match(r"I((?:L[bi]\d+E)+)E", rest)
                if not args:
                    return name
                vals = [("true" if v == "1" else "false") if t == "b" else v
                        for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
                return f"{name}<{', '.join(vals)}>"
    return mangled


def ptxas_report(report: str) -> list:
    """Per kernel of one nvcc run: registers, spilled bytes and the wgmma
    serialization diagnostics (C75xx) ptxas printed for it."""
    import re

    out, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(kernel=_kernel_name(m.group(1)), registers=None, spill_stores=0, spill_loads=0,
                       wgmma_serialized=[])
            out.append(cur)
            continue
        if cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
        m = re.search(r"\b(C75\d\d)\b", line)
        if m:  # the diagnostic names its function where ptxas gives one
            named = re.search(r"'(_Z\w+)'", line)
            owner = next((r for r in out if named and r["kernel"] == _kernel_name(named.group(1))), cur)
            if owner is None:
                owner = dict(kernel="(unnamed)", registers=None, spill_stores=0, spill_loads=0, wgmma_serialized=[])
                out.append(owner)
            owner["wgmma_serialized"].append(m.group(1))
    return out


def main(argv) -> int:
    out_dir = argv[argv.index("--out-dir") + 1] if "--out-dir" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from opensora_torch.ops import _build

    sources = ("flash_attention_fwd_sm90", "flash_attention_fwd_d512_sm90", "flash_attention_bwd_sm90",
               "flash_attention_bwd_d512_sm90", "int8_matmul_sm90", "int8_flash_attention", "ring_flash_attention")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build.build, sources)))
    ptxas = {}
    for name, (seconds, report) in built.items():
        ptxas[name] = ptxas_report(report)
        regs = "; ".join(f"{r['kernel']}: {r['registers']} registers, {r['spill_stores']}/{r['spill_loads']} bytes "
                         f"spilled (stores/loads){', ' + ' '.join(r['wgmma_serialized']) if r['wgmma_serialized'] else ''}"
                         for r in ptxas[name])
        log(f"[build] {name}: {seconds:.1f} s (0.0: the library of this source was built before); ptxas: "
            f"{regs or 'no report (reused library)'}")
    spilled = [f"{name}: {r['kernel']}" for name in sources for r in ptxas[name] if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "build_log.txt"), "w") as f:
            f.write("".join(f"== {name}\n{report}" for name, (_, report) in built.items()))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    max_sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    mufu_per_s = MUFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * float(
        max_sm_mhz) * 1e6

    attn = check_attention(device)
    attn_bwd = check_attention_bwd(device)
    attn_bwd_d512 = check_attention_bwd(device, BWD_D512_CASES, seed=8)
    gemm = check_int8_gemm(device)
    int8_attn = check_int8_attention(device, mufu_per_s)
    ring = check_ring(device)
    small = check_small_input(device)
    small_train = check_train_small_input(device)
    small_int8 = check_int8_small_input(device)
    small_vae = check_vae_train_small_input(device)
    small_ring = check_small_input(device, ring_mesh(device))
    small_ring_train = check_train_small_input(device, ring_mesh(device))
    main_res, built = run_main_path(device, "--profile" in argv, out_dir)
    main_res["small_input"] = small
    ring_res = run_ring_path(device, built, "--profile" in argv, out_dir)
    ring_res["small_input"] = small_ring
    del built
    gc.collect()
    torch.cuda.empty_cache()
    train_res, built = run_train_path(device, "--profile" in argv, out_dir)
    train_res["small_input"] = small_train
    ring_train_res = run_ring_train_path(device, built, "--profile" in argv, out_dir)
    ring_train_res["small_input"] = small_ring_train
    del built
    gc.collect()
    torch.cuda.empty_cache()
    int8_res = run_int8_path(device, [], STEPS, "--profile" in argv, out_dir, "int8")
    int8_res["small_input"] = small_int8
    fq_res = run_int8_path(device, ["--model.quantized", "w8a8_fq", "--model.attn_backend", "int8"], INT8_FQ_STEPS,
                           tag="int8_fq")
    log(f"[int8_fq] w8a8_fq / int8 denoise step: {[round(s, 3) for s in fq_res['step_s']]} s "
        f"({fq_res['launches'].get('w8a8_fq_matmul', 0)} launches of w8a8_fq_matmul; the w8a8 / int8_qk8 "
        f"steps {[round(s, 3) for s in int8_res['step_s']]} s)")
    with tempfile.TemporaryDirectory() as tmp:
        vae_res = run_vae_train_path(device, "hunyuan_vae", VAE_STEPS, 33, write_lpips_files(tmp), "vae",
                                     "--profile" in argv, out_dir)
    vae_res["small_input"] = small_vae
    dcae_res = run_vae_train_path(device, "dc_ae", DCAE_STEPS, 32, tag="dcae", profile="--profile" in argv,
                                  out_dir=out_dir)
    sm90_cases = [c for c in attn["cases"] if c["kernel"] == "flash_attention_fwd_sm90"]
    d512_cases = [c for c in attn["cases"] if c["kernel"] == "flash_attention_fwd_d512"]
    head = sm90_cases[0]  # the MMDiT shape, anchored: the main path's hot call
    kernels = [dict(
        name="flash_attention_fwd_sm90",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_fwd_sm90.cu",
        replaces="opensora_tpu/ops/flash_attention.py:247",
        also_replaces="opensora_tpu/ops/flash_attention.py:179 (the running-max loop) and :320-422 (the dispatch)",
        head_dim=128,
        launches=main_res["launches"].get("flash_attention_fwd_sm90", 0),
        launches_train=train_res["launches"]["flash_attention_fwd_sm90"],
        max_abs_err=max(c["max_abs_err"] for c in sm90_cases),
        ms=head["ms"], ms_is="flash_attention_with_lse (the bound A on the device, then the kernel), the mean of "
        "4 readings in turns with SDPA's 4 (library_ms)", anchor_ms=head["anchor_ms"],
        running_max_ms=sm90_cases[1]["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        cases=sm90_cases,
    )]
    head = d512_cases[0]  # the main path's VAE decode tile
    kernels.append(dict(
        name="flash_attention_fwd_d512",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_fwd_d512_sm90.cu",
        replaces="opensora_tpu/ops/flash_attention.py:179",
        also_replaces="opensora_tpu/ops/flash_attention.py:247 (the anchored loop) and :320-422 (the dispatch)",
        head_dim=512,
        launches=main_res["launches"].get("flash_attention_fwd_d512", 0),
        launches_train=train_res["launches"]["flash_attention_fwd_d512"],
        launches_vae_train=vae_res["launches"]["flash_attention_fwd_d512"],
        max_abs_err=max(c["max_abs_err"] for c in d512_cases),
        ms=head["ms"], ms_is="flash_attention_with_lse, the mean of 4 readings in turns with SDPA's 4 (library_ms)",
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"], library="SDPA with the frame-causal block mask",
        cases=d512_cases,
    ))
    bwd_head = attn_bwd["cases"][0]  # the MMDiT shape
    kernels.append(dict(
        name="flash_attention_bwd_fused",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_bwd_sm90.cu",
        replaces="opensora_tpu/ops/flash_attention.py:425",
        also_replaces="opensora_tpu/ops/flash_attention.py:497 (dQ's sum; the epilogue kernel finishes it)",
        head_dim=128,
        launches=train_res["launches"]["flash_attention_bwd_fused"],
        max_abs_err=max(c["max_abs_err"][g] for c in attn_bwd["cases"] for g in ("dq", "dk", "dv")),
        max_abs_err_is="dq (after the epilogue), dk and dv against the plain backward",
        ms=bwd_head["ms"]["flash_attention_bwd_fused"],
        ms_includes=f"zeroing dq_accum ({bwd_head['dq_accum_zero_fill_ms']:.3f} ms alone)",
        call_ms=bwd_head["call_ms"], call_is="partial_flash_backward with delta: both kernels and the wrappers",
        plain_ms=bwd_head["plain_ms"], bound_ms=bwd_head["bound_ms"]["minimal"],
        bound_by=bwd_head["bound_by"]["minimal"],
        bound_is="the minimal backward: 5 products, bf16 dq, dk and dv written once",
        library_ms=bwd_head["library_ms"],
        plain_and_library_compute="dq, dk and dv (the whole backward)",
        cases=attn_bwd["cases"],
    ))
    kernels.append(dict(
        name="flash_attention_bwd_dq_convert",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_bwd_sm90.cu",
        replaces="opensora_tpu/ops/flash_attention.py:497 (the finalize of _dq_kernel: dq_scr * sm_scale to bf16)",
        head_dim=128,
        launches=train_res["launches"]["flash_attention_bwd_dq_convert"],
        launches_ring_train=ring_train_res["launches"]["flash_attention_bwd_dq_convert"],
        max_abs_err=max(c["dq_convert_max_abs_err"] for c in attn_bwd["cases"]),
        max_abs_err_is="against its plain version on the same dq_accum",
        ms=bwd_head["ms"]["flash_attention_bwd_dq_convert"], plain_ms=bwd_head["dq_convert_plain_ms"],
        bound_ms=bwd_head["bound_ms"]["flash_attention_bwd_dq_convert"],
        bound_by=bwd_head["bound_by"]["flash_attention_bwd_dq_convert"],
        library_ms=None, library="none: no one PyTorch call reorders, scales and rounds",
    ))
    d512_head = attn_bwd_d512["cases"][0]  # the HunyuanVAE mid-block in VAE training
    kernels.append(dict(
        name="flash_attention_bwd_d512",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_bwd_d512_sm90.cu",
        replaces="opensora_tpu/ops/flash_attention.py:425",
        also_replaces="opensora_tpu/ops/flash_attention.py:497 (dQ's sum; the epilogue kernel finishes it)",
        head_dim=512,
        products=BWD_PRODUCTS["flash_attention_bwd_d512"],
        launches=vae_res["launches"]["flash_attention_bwd_d512"],
        max_abs_err=max(c["max_abs_err"][g] for c in attn_bwd_d512["cases"] for g in ("dq", "dk", "dv")),
        max_abs_err_is="dq (after the epilogue), dk and dv against the plain backward",
        ms=d512_head["ms"]["flash_attention_bwd_d512"],
        ms_includes=f"zeroing dq_accum ({d512_head['dq_accum_zero_fill_ms']:.3f} ms alone)",
        call_ms=d512_head["call_ms"], call_is="partial_flash_backward with delta: both kernels and the wrappers",
        plain_ms=d512_head["plain_ms"], bound_ms=d512_head["bound_ms"]["minimal"],
        bound_by=d512_head["bound_by"]["minimal"],
        bound_is="the minimal backward: 5 products, bf16 dq, dk and dv written once",
        design_products_bound_ms=d512_head["bound_ms"]["flash_attention_bwd_d512"],
        library_ms=d512_head["library_ms"],
        library="SDPA backward with the frame-causal block mask (forward + backward minus forward)",
        plain_and_library_compute="dq, dk and dv (the whole backward)",
        cases=attn_bwd_d512["cases"],
    ))
    kernels.append(dict(
        name="flash_attention_bwd_d512_dq_convert",
        route="cuda",
        source="opensora_torch/csrc/flash_attention_bwd_d512_sm90.cu",
        replaces="opensora_tpu/ops/flash_attention.py:497 (the finalize of _dq_kernel: dq_scr * sm_scale to bf16)",
        head_dim=512,
        launches=vae_res["launches"]["flash_attention_bwd_d512_dq_convert"],
        max_abs_err=max(c["dq_convert_max_abs_err"] for c in attn_bwd_d512["cases"]),
        max_abs_err_is="against its plain version on the same dq_accum",
        ms=d512_head["ms"]["flash_attention_bwd_d512_dq_convert"], plain_ms=d512_head["dq_convert_plain_ms"],
        bound_ms=d512_head["bound_ms"]["flash_attention_bwd_d512_dq_convert"],
        bound_by=d512_head["bound_by"]["flash_attention_bwd_d512_dq_convert"],
        library_ms=None, library="none: no one PyTorch call reorders, scales and rounds",
    ))
    gemm_head = next(c for c in gemm["cases"] if c["name"] == GEMM_HEAD)
    for name, line, also, runs, a_int8 in (
            ("w8a8_matmul", 31, "opensora_tpu/ops/quant.py:71-80 (the XLA int8 dot_general of w8a8)",
             {"int8": int8_res, "int8_fq": fq_res}, "true"),
            ("w8a8_fq_matmul", 51, None, {"int8_fq": fq_res}, "false")):
        head = gemm_head[name]
        extra = dict(ms_is="the kernel alone, the mean of 4 readings in turns with the other instantiation's, the "
                     "fused-quant wrapper's and the library call's", ms_turns=head["ms_turns"],
                     path_step_s=(fq_res if name == "w8a8_fq_matmul" else int8_res)["step_s"],
                     path_step_is=f"the {'w8a8_fq / int8' if name == 'w8a8_fq_matmul' else 'w8a8 / int8_qk8'} "
                     "denoise steps of phase 6",
                     ptxas=[r for r in ptxas["int8_matmul_sm90"] if r["kernel"].startswith(f"w8a8_sm90_kernel<{a_int8}")])
        if name == "w8a8_fq_matmul":
            extra["wrapper_ms"] = head["wrapper_ms"]
        else:
            extra["library_ms_turns"] = head["library_ms_turns"]
        kernels.append(dict(
            name=name, route="cuda", source="opensora_torch/csrc/int8_matmul_sm90.cu", **extra,
            replaces=f"opensora_tpu/ops/int8_matmul.py:{line}", also_replaces=also,
            launches=sum(r["launches"].get(name, 0) for r in runs.values()),
            launches_by_run={tag: r["launches"].get(name, 0) for tag, r in runs.items()},
            max_abs_err=max(c[name]["max_abs_err"] for c in gemm["cases"]),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape_mkn=gemm_head["shape_mkn"],
            library="torch._int_mm + the fp32 rescale epilogue" if head["library_ms"] is not None else None,
            cases=[dict(name=c["name"], shape_mkn=c["shape_mkn"], **c[name]) for c in gemm["cases"]],
        ))
    for name, mode, res in (("int8_flash_attention", "qk8", int8_res), ("int8_flash_attention_pv8", "int8", fq_res)):
        mine = [c for c in int8_attn["cases"] if c["mode"] == mode]
        head = mine[0]  # the MMDiT shape, anchored: the path's case
        pv = "true" if mode == "int8" else "false"
        kernels.append(dict(
            name=name, route="cuda", source="opensora_torch/csrc/int8_flash_attention.cu",
            replaces="opensora_tpu/ops/int8_flash.py:144",
            also_replaces="opensora_tpu/ops/int8_flash.py:62 (the running-max loop) and :230 (the dispatch)",
            mode=mode, launches=res["launches"].get(name, 0),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=head["ms"], ms_is="the kernel alone on the preamble's output, the mean of 4 readings in turns with "
            "the wrapper's and bf16 SDPA's", ms_turns=head["ms_turns"], wrapper_ms=head["wrapper_ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], library=head["library"],
            ptxas=[r for r in ptxas["int8_flash_attention"] if r["kernel"].startswith(f"int8_flash_fwd_kernel<{pv}")],
            cases=mine,
        ))
    for name, line in zip(RING_KERNELS, (70, 185)):
        mine = ring["cases"]
        head = mine[0]  # the slice's shape: the MMDiT's joint attention over 4 ranks
        fwd = name == "ring_flash_fwd"
        kernels.append(dict(
            name=name, route="cuda", source="opensora_torch/csrc/ring_flash_attention.cu",
            replaces=f"opensora_tpu/ops/ring_flash.py:{line}",
            launches=(ring_res if fwd else ring_train_res)["launches"][name],
            launches_train=ring_train_res["launches"][name],
            max_abs_err=max(c["max_abs_err"] if fwd else max(c["grad_max_abs_err"].values()) for c in mine),
            ms=head["kernels_ms"][name], ms_is="the 16 (rank, hop) launches of one call, back to back",
            call_ms=head["call_ms"] if fwd else head["bwd_call_ms"],
            plain_ms=head["plain_ms"] if fwd else head["plain_bwd_ms"],
            bound_ms=head["bound_ms"] if fwd else head["bwd_bound_ms"]["flash_attention_bwd_fused"],
            bound_by=head["bound_by"] if fwd else head["bwd_bound_by"]["flash_attention_bwd_fused"],
            library_ms=head["library_ms"] if fwd else head["library_bwd_ms"],
            library="SDPA at the global shape" + ("" if fwd else ", backward"),
            **({} if fwd else {"plain_and_library_compute": "dq, dk and dv (the whole backward)",
                               "max_abs_err_is": "dq (after the dQ epilogue), dk and dv of the ring call"}),
            cases=mine,
        ))
    for entry in kernels:  # every kernel with the ptxas lines of its source, where not narrowed above
        entry.setdefault("ptxas", ptxas[os.path.basename(entry["source"])[:-len(".cu")]])
    log("[main] " + json.dumps(main_res))
    log("[ring] " + json.dumps(ring_res))
    log("[ring_train] " + json.dumps(ring_train_res))
    log("[train] " + json.dumps(train_res))
    log("[int8] " + json.dumps(int8_res))
    log("[int8_fq] " + json.dumps(fq_res))
    log("[vae] " + json.dumps(vae_res))
    log("[dcae] " + json.dumps(dcae_res))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
