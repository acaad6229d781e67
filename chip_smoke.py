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
The conditioned paths: phase 2 holds the D = 128 forward at the t2i2v
image stage's shape (1, 24, 2816, 128) too; phase 3e checks the image
stage's full-width Flux MMDiT (1 + 1 blocks, guidance vector on) through
one DistilledDenoiser step and the Flux AE decoder on a small latent, card
against CPU; phase 11 (after phase 9, on phase 4's models) builds the image
stage of configs/diffusion/inference/t2i2v_256px.py (the 12B-class
distilled Flux MMDiT and the 2D Flux AE, random from the config's seed)
and runs the CLI's t2i2v flow, STEPS steps in each stage: the 768 x 768
image, saved and read back, encoded by the HunyuanVAE as the i2v_head
reference of the 129-frame 192 x 336 video, decoded: shapes, finite
outputs, the latent's first frame equal to the encoded reference, exact
launches; phase 12 runs v2v_head_easy for 1 step with phase 4's video,
saved and read back, as its reference (65 frames encoded, 17 latent frames
conditioned, checked to be that encode's).
Checkpoints, last: phases 4, 6 and 11 record their models' first calls;
phase 13 draws those models again from their seeds (the first calls
replayed bitwise), writes them with the port's safetensors writer in
published layouts -- the 11B MMDiT as one file in the unfused
(q_proj/k_proj/v_proj/v_mlp) layout, the HunyuanVAE, T5-XXL as a sharded
HF directory with its index, CLIP-L as a CLIPModel file with vision keys,
the Flux image model in flux1-dev's layout (fused, q/k rows in the
interleaved pairing) and the 2D Flux AE -- frees them and loads each back
through prepare_models / prepare_optional_models / the text embedder
(256px.py's fused model from the unfused file, 256px_int8attn.py quantized
at load, the image model with ckpt_rope_convention="interleaved"): every
loaded tensor equal to its checksum (the quantized one to quantize_model_
of the float weights), each phase's first call replayed bitwise on the
loaded model with exact launches (57, 304 + 57, 57), every load's seconds,
GB/s and host RSS printed; one file on disk at a time. Phase 14 runs
python -m opensora_torch.vae_inference and vae_stats on
configs/vae/inference/hunyuan_vae.py (phase 13's VAE file) and
video_dc_ae.py (phase 8's DC-AE drawn again and written) over 4 seeded
33 x 256 x 256 mp4 clips: the latent statistics equal a direct encode's
with the same generator, PSNR finite, D = 512 launches exactly the
tiles' mid-blocks (none for the DC-AE), seconds per clip printed.
The high-compression paths (Video DC-AE latents, patch 1), last: phase 2
holds the D = 128 forward at their shapes, (3, 24, 2624, 128) for t2v at
192 x 336 and (3, 24, 2560, 128) at 256 x 256, and phase 2b the backward at
the training clip's (3, 24, 2560, 128); phase 3f checks one full-finetune
step (fp32 masters, bf16 compute) of the training config's full-width MMDiT
at depth 1 + 1 against the CPU's fp32 step, and, on phase 15's models, the
full-width, full-depth MMDiT on a small latent (the CPU's plain path
streamed block by block; a control with one block skipped must fail) and
the DC-AE decoder; phase 15 runs configs/diffusion/inference/
high_compression.py at full width and depth, t2v for 2 steps at 192 x 336,
129 frames (decoded 128 x 192 x 352, as the JAX package decodes 11 latent
columns), then i2v_head for 1 step from a seeded 256 x 256 image: shapes,
finite videos, the first latent frame equal to the encoded reference, 57
launches a step; phase 16 runs configs/diffusion/train/high_compression.py
as a full finetune at full width and 2 + 4 blocks for 3 steps on a seeded
128 x 256 x 256 clip, B = 3 (losses, moving parameters, exact launches,
peak memory), one step from one saved state with remat_policy "full" and
one with "offload" (equal losses, gradients within the backward's limit,
the device memory held through the forward, offload's below full's, and
the backward's peaks side by side), and rf_eval_loss over the trained
model.
Tokenizers and the evaluation, last: phase 13 keeps its T5-XXL and CLIP-L
directories; phase 3g holds the evaluation's CLIP ViT-L/14 vision tower
and the CLIP-L text tower at full size (random from a seed, fp32, TF32
off as the scorer sets it under PyTorch's defaults) against the CPU on 2
frames and a prompt (a vision layer skipped on the CPU must fail the
limit); phase 17a writes spiece.model (32000 pieces,
a non-empty charsmap) and vocab.json / merges.txt (49408 entries), both
generated from text in the repository, beside those weights and runs
256px.py through the inference CLI at full width and depth for 2 steps
with --motion-score 4 and t5 / clip naming the directories: the encoders'
ids are the tokenizers' (equal to ids computed on the CPU and stored
here, not the byte fallback's), 57 D = 128 launches a step and 2 D = 512
in the decode, the sample saved as .npy; phase 17b writes a random
ViT-L/14 CLIPModel (HF layout, with the tokenizer files) and a random
LAION aesthetic head and runs python -m opensora_torch.evaluate on the
card over that sample and seeded clips whose sidecars name each detection
dimension, pooled and with --suite vbench, under PyTorch's TF32 defaults
as a user's process runs it: every named dimension scored and finite, the
others None, the motion-score sample matched to its suite (R3), no kernel
launched; pooled again over every sample twice, the same report and the
same peak memory (the samples stay on the host); it times the scorer's
loading apart from the scoring, the tower on 8 frames and the evaluation
of the 129-frame video.
Then it prints the card's name and power limit, one JSON line with the
kernels' numbers, and last {"ok": true, "device": {...}}.

``--out-dir DIR`` writes the compiler's register/shared-memory report
(build_log.txt) there; ``--profile`` adds a profiled second run of each
path (kernel time by kind, device idle share; with ``--out-dir`` the full
tables go to DIR/profile_{main,ring,t2i2v,train,ring_train,int8,vae,dcae,hc,hc_train}.txt).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import math
import os
import shutil
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
    ("flux_image_768px", (1, 24, 2816, 128), None, 1.0),  # the t2i2v image stage: 2304 image + 512 text tokens
    # the high-compression paths (patch 1 over DC-AE latents, 512 text tokens):
    # t2v at 192 x 336 (32 x 6 x 11 latent tokens) and, at the 256px bucket's
    # 1:1 size, i2v_head and the training clip (32 x 8 x 8)
    ("hc_t2v_192x336", (3, 24, 2624, 128), None, 1.0),
    ("hc_256x256", (3, 24, 2560, 128), None, 1.0),
    ("vae_mid_tile_24x32", (1, 1, 33 * 768, 512), 768, 1.0),
    ("vae_mid_tile_24x18", (1, 1, 33 * 432, 512), 432, 1.0),
    # the reference encodes: one frame (i2v, t2i2v; causal_block = L) and
    # v2v's 65 frames (17 latent frames), in the encoder's two tile widths
    ("vae_mid_encode_1frame_24x32", (1, 1, 768, 512), 768, 1.0),
    ("vae_mid_encode_1frame_24x18", (1, 1, 432, 512), 432, 1.0),
    ("vae_mid_v2v_17f_24x32", (1, 1, 17 * 768, 512), 768, 1.0),
    ("vae_mid_v2v_17f_24x18", (1, 1, 17 * 432, 512), 432, 1.0),
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
    ("hc_train_128x256x256", (3, 24, 2560, 128), None),  # phase 16: 32 x 8 x 8 latent + 512 text tokens
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


def run_main_path(device, profile: bool = False, out_dir=None, records=None) -> dict:
    """256px.py at full width and depth through prepare_models and api_fn;
    ``records`` (a dict) receives the first call of the MMDiT, T5 and CLIP
    (phase 13 replays them)."""
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
    model, ae, t5, clip, _ = prepare_models(cfg, device=device, seed=cfg.seed)
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
    with FirstCall(model) as rec_model, FirstCall(t5) as rec_t5, FirstCall(clip) as rec_clip:
        t0 = time.perf_counter()
        x = api_fn(**run_kwargs, timings=timings)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if records is not None:
        records.update(main=rec_model, t5=rec_t5, clip=rec_clip)

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
# phases 3e, 11 and 12: the conditioned paths (t2i2v, i2v, v2v)
# ----------------------------------------------------------------------

T2I2V_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "t2i2v_256px.py")
V2V_STEPS = 1  # steps of the v2v run
T2I2V_PROMPT = ["a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score."]


def check_t2i_small_input(device) -> dict:
    """The t2i2v image stage's models at full width on a small input, the
    card's bf16 path against the port's plain fp32 path on the CPU (same
    weights): the distilled Flux MMDiT at depth 1 + 1 (guidance vector on,
    64 image + 32 text tokens, the D = 128 kernel on the card) through one
    DistilledDenoiser step -- its update x_1 - x_0 held to SMALL_TOL of its
    own scale --, and the Flux AE decoder (fp32 master weights, bf16
    compute on the card; plain fp32 attention on both) on a 16 x 8 x 8
    latent."""
    from opensora_torch.ops import _build
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import DistilledDenoiser, build_img_ids, get_schedule

    cfg = parse_configs([T2I2V_CFG])
    gen = torch.Generator().manual_seed(3)

    def twins(conf: dict):
        torch.manual_seed(0)
        card = build_module(dict(conf), MODELS, device=device).eval()
        cpu = build_module(dict(conf, dtype="fp32"), MODELS, device="meta").eval()
        cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()}, assign=True)
        return card, cpu

    def rel_err(card_out, cpu_out):
        return float((card_out.float().cpu() - cpu_out).abs().max() / cpu_out.abs().max().clamp(min=1.0))

    mcfg = dict(cfg.img_flux, depth=1, depth_single_blocks=1)
    card, cpu = twins(mcfg)
    b, lt = 1, 32
    img_ids = build_img_ids(1, 16, 16, bs=b)  # 8 x 8 = 64 image tokens
    img = torch.randn(b, 64, mcfg["in_channels"], generator=gen)
    cond = dict(img_ids=img_ids, txt=torch.randn(b, lt, mcfg["context_in_dim"], generator=gen),
                txt_ids=torch.zeros(b, lt, 3), y_vec=torch.randn(b, mcfg["vec_in_dim"], generator=gen))
    ts = get_schedule(1, 64, 1)
    guidance = cfg.sampling_option_t2i["guidance"]
    _build.LAUNCHES.clear()
    with torch.inference_mode():
        ref = DistilledDenoiser().denoise(cpu, img=img, timesteps=ts, guidance=guidance, **cond)
        out = DistilledDenoiser().denoise(card, img=img.to(device), timesteps=ts, guidance=guidance,
                                          **{k: v.to(device) for k, v in cond.items()})
    launches = dict(_build.LAUNCHES)
    res = {"flux_1+1_distilled_step_rel_err": rel_err(out, ref),
           "flux_1+1_distilled_update_rel_err": float(((out.float().cpu() - img) - (ref - img)).abs().max()
                                                      / (ref - img).abs().max())}
    del card, cpu
    card, cpu = twins(dict(cfg.img_flux_ae))
    z = torch.randn(1, 16, 8, 8, generator=gen)
    with torch.inference_mode():
        ref = cpu.decode(z)
        out = card.decode(z.to(device))
    res["flux_ae_decode_rel_err"] = rel_err(out, ref)
    del card, cpu
    torch.cuda.empty_cache()
    expect = {"flash_attention_fwd_sm90": 2}
    ok = (res["flux_1+1_distilled_update_rel_err"] <= SMALL_TOL and res["flux_ae_decode_rel_err"] <= SMALL_TOL
          and launches == expect)
    log(f"[small] t2i2v image stage: full-width Flux MMDiT depth 1+1 (B=1, 96 tokens, guidance {guidance}) "
        f"through one DistilledDenoiser step and the Flux AE decode (latent 16x8x8), card bf16 + kernel vs CPU fp32 "
        f"plain: {res} (tol {SMALL_TOL} of the update's / output's scale) launches {launches} (expected {expect}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's image stage disagrees with the plain path on a small input")
    return dict(res, launches=launches)


def hunyuan_mid_launches(ae, shape, decode: bool) -> int:
    """D = 512 launches of one HunyuanVAE encode of a (B, 3, T, H, W) clip,
    or decode of a latent of that shape: one mid-block attention per sample
    (the encoder) or per batch (the decoder) and spatial tile, the tiles
    laid out as the AE's spatial tiling lays them (no temporal tiling in
    these configs)."""
    cfg = ae.config
    b, _, t, h, w = shape
    tile = ae.tile_latent_min_size if decode else ae.tile_sample_min_size
    if cfg.use_temporal_tiling and t > (ae.tile_latent_min_tsize if decode else ae.tile_sample_min_tsize):
        raise ValueError("temporal tiling is not counted")
    per_tile = 1 if decode else b
    if cfg.use_spatial_tiling and (h > tile or w > tile):
        step = int(tile * (1 - cfg.tile_overlap_factor))
        return per_tile * len(range(0, h, step)) * len(range(0, w, step))
    return per_tile


class AERecorder:
    """Records what the video AE encodes (its input and output) and what it
    decodes, while active, by wrapping the instance's methods."""

    def __init__(self, ae):
        self.ae, self.encoded, self.decoded = ae, [], []

    def __enter__(self):
        encode, decode = self.ae.encode, self.ae.decode

        def rec_encode(x, *a, **kw):
            z = encode(x, *a, **kw)
            self.encoded.append((x.detach().float().cpu(), z.detach().cpu()))
            return z

        def rec_decode(z, *a, **kw):
            self.decoded.append(z.detach().cpu())
            return decode(z, *a, **kw)

        self.ae.encode, self.ae.decode = rec_encode, rec_decode
        return self

    def __exit__(self, *exc):
        del self.ae.encode, self.ae.decode
        return False


def run_t2i2v_path(device, built, out_root, profile: bool = False, out_dir=None, records=None) -> dict:
    """configs/diffusion/inference/t2i2v_256px.py at full width and depth on
    phase 4's video models (the config's are 256px.py's, the same seed) plus
    its image stage drawn from the config's seed: the CLI's t2i2v flow
    (opensora_torch.inference.prepare_image_stage and make_reference_images,
    then api_fn with cond_type i2v_head and the saved image as the
    reference), STEPS steps in each stage. Checks shapes, finite outputs,
    that the latent's first frame before decoding equals the encoded
    reference and the exact launches. ``records`` (a dict) receives the
    image model's first call and the Flux AE's decode (phase 13)."""
    from opensora_torch.inference import make_reference_images, prepare_image_stage
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_optional_models
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([T2I2V_CFG, "--sampling_option.num_steps", str(STEPS),
                         "--sampling_option_t2i.num_steps", str(STEPS)])
    cfg.sampling_option_t2i["seed"] = cfg.seed  # the image from the config's seed, so that the run repeats
    model, ae, t5, clip = built["models"]
    for key in ("model", "ae", "t5", "clip", "sampling_option"):
        if cfg[key] != built["cfg"][key]:
            raise AssertionError(f"t2i2v_256px.py's {key} is not phase 4's")
    log(f"[t2i2v] t2i2v_256px.py at full width and depth on phase 4's models; num_steps cut 50 -> {STEPS} in "
        f"each stage")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    torch.manual_seed(cfg.seed)
    optional = prepare_optional_models(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    img_flux, img_ae = optional["img_flux"], optional["img_flux_ae"]
    n_img = sum(p.numel() for p in img_flux.parameters())
    resident_gb = torch.cuda.memory_allocated(device) / 1e9
    log(f"[t2i2v] image stage built in {build_s:.1f} s: Flux MMDiT {n_img / 1e9:.2f}B params, Flux AE "
        f"{sum(p.numel() for p in img_ae.parameters()) / 1e6:.1f}M; resident {resident_gb:.2f} GB")
    patch = cfg.get("patch_size", 2)
    api_img, opt_img = prepare_image_stage(cfg, optional, t5, clip, patch)
    api_fn = prepare_api(model, ae, t5, clip)
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option))
    n_img_blocks = cfg.img_flux["depth"] + cfg.img_flux["depth_single_blocks"]
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]

    _build.LAUNCHES.clear()
    img_timings: dict = {}
    with FirstCall(img_flux) as rec_flux, FirstCall(img_ae, "decode") as rec_decode:
        t0 = time.perf_counter()
        refs = make_reference_images(api_img, opt_img, T2I2V_PROMPT, out_root, 0, cfg.img_flux["in_channels"],
                                     patch, timings=img_timings)
        torch.cuda.synchronize()
        image_s = time.perf_counter() - t0
    img_launches = dict(_build.LAUNCHES)
    if records is not None:
        records.update(img_flux=rec_flux, img_decode=rec_decode)
    from opensora_torch.datasets.utils import read_from_path

    image = read_from_path(refs[0], (opt_img.height, opt_img.width))
    timings: dict = {}
    with AERecorder(ae) as rec:
        t0 = time.perf_counter()
        x = api_fn(opt, cond_type=cfg.cond_type, seed=cfg.seed, text=T2I2V_PROMPT,
                   channel=cfg.model["in_channels"], timings=timings, ref=refs)
        torch.cuda.synchronize()
        video_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    (enc_in, enc_out), = rec.encoded
    latent, = rec.decoded
    first_equal = bool(torch.equal(latent[0, :, :1], enc_out[0][:, :1].to(latent.dtype)))
    ref_frame = torch.from_numpy(read_from_path(refs[0], (opt.height, opt.width))[:, :1])
    enc_in_err = float((enc_in[0] - ref_frame).abs().max())
    n_enc = hunyuan_mid_launches(ae, tuple(enc_in.shape), decode=False)
    n_dec = hunyuan_mid_launches(ae, tuple(latent.shape), decode=True)
    expect_img = {"flash_attention_fwd_sm90": n_img_blocks * STEPS}
    expect = {"flash_attention_fwd_sm90": (n_img_blocks + n_blocks) * STEPS, "flash_attention_fwd_d512": n_enc + n_dec}
    finite = bool(torch.isfinite(x).all()) and bool(torch.isfinite(torch.from_numpy(image)).all())
    outside = float((x.abs() > 1.0).float().mean())
    res = dict(reference=os.path.basename(refs[0]), image_shape=list(image.shape), video_shape=list(x.shape),
               image_s=image_s, image_step_s=img_timings["step_s"], image_decode_s=img_timings["decode_s"],
               encode_ref_s=timings["encode_ref_s"], step_s=timings["step_s"], decode_s=timings["decode_s"],
               video_s=video_s, peak_mem_gb=peak_gb, resident_gb=resident_gb,
               card_total_gb=torch.cuda.get_device_properties(device).total_memory / 1e9, models_build_s=build_s,
               outside_share=outside, first_latent_frame_equals_encoded_reference=first_equal,
               encode_input_vs_saved_image_max_abs=enc_in_err, launches=launches, expected=expect,
               image_launches=img_launches, image_expected=expect_img, encode_launches=n_enc, decode_launches=n_dec)
    log("[t2i2v] " + json.dumps(res))
    expect_video = (1, 3, opt.num_frames, opt.height, opt.width)
    if tuple(image.shape) != (3, 1, opt_img.height, opt_img.width) or tuple(x.shape) != expect_video:
        raise AssertionError(f"image {tuple(image.shape)} / video {tuple(x.shape)} shapes")
    if not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"t2i2v output not finite, or {outside:.4f} of the video outside [-1, 1]")
    if not first_equal or enc_in_err > 1e-6:
        raise AssertionError("the video's first latent frame is not the encoded reference image")
    if img_launches != expect_img or launches != expect:
        raise AssertionError(f"kernel launches {img_launches} / {launches} != expected {expect_img} / {expect}")
    if profile:
        def run():
            r = make_reference_images(api_img, opt_img, T2I2V_PROMPT, out_root, 0, cfg.img_flux["in_channels"],
                                      patch)
            api_fn(opt, cond_type=cfg.cond_type, seed=cfg.seed, text=T2I2V_PROMPT,
                   channel=cfg.model["in_channels"], ref=r)
        res["profile"] = profile_run(run, "t2i2v", out_dir)
    del optional, img_flux, img_ae, api_img, x
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_v2v_path(device, built, out_root) -> dict:
    """v2v_head_easy on phase 4's models for V2V_STEPS step(s), its reference
    phase 4's 129-frame video saved by save_sample as the port's lossless
    .npy sample (the route where OpenCV is absent, taken here whether or not
    it is) and read back: the first 65 frames encoded, the first 17 latent
    frames conditioned. Checks that the encoder got the saved frames (those
    read back, and phase 4's video to uint8 precision), that the conditioned
    latent frames are that encode's, shape, finiteness and launches."""
    import opensora_torch.utils.api as api_mod
    from opensora_torch.datasets.utils import read_from_path
    from opensora_torch.ops import _build
    from opensora_torch.utils.inference import save_sample
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg, (model, ae, t5, clip) = built["cfg"], built["models"]
    video = built["video"]
    with unittest.mock.patch.dict(sys.modules, {"cv2": None}):
        ref_path = save_sample(video[0].numpy(), os.path.join(out_root, "v2v_reference"))
    opt = sanitize_sampling_option(SamplingOption(**dict(cfg.sampling_option, num_steps=V2V_STEPS)))
    api_fn = api_mod.prepare_api(model, ae, t5, clip)
    conditions = []

    def record_condition(fn):
        def run(*a, **kw):
            masks, masked = fn(*a, **kw)
            conditions.append((masks.cpu(), masked.cpu()))
            return masks, masked
        return run

    log(f"[v2v] v2v_head_easy on phase 4's models, reference {os.path.basename(ref_path)} (phase 4's video); "
        f"num_steps {V2V_STEPS}")
    _build.LAUNCHES.clear()
    timings: dict = {}
    with AERecorder(ae) as rec, patched(api_mod, "prepare_inference_condition", record_condition):
        t0 = time.perf_counter()
        x = api_fn(opt, cond_type="v2v_head_easy", seed=cfg.seed, text=T2I2V_PROMPT,
                   channel=cfg.model["in_channels"], timings=timings, ref=[ref_path])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    (enc_in, enc_out), = rec.encoded
    (masks, masked), = conditions
    k = 16 + int(opt.is_causal_vae)
    read_back = torch.from_numpy(read_from_path(ref_path, (opt.height, opt.width))[:, :enc_in.shape[2]])
    read_back_equal = bool(torch.equal(enc_in[0], read_back))
    # the .npy sample holds phase 4's video clipped to [-1, 1] and floored to uint8 (at most 2/255 below)
    enc_in_err = float((read_back - video[0, :, :enc_in.shape[2]].clamp(-1, 1)).abs().max())
    saved_ok = ref_path.endswith(".npy") and enc_in_err <= 2 / 255 + 1e-6
    cond_equal = bool(torch.equal(masked[0, :, :k], enc_out[0][:, :k].to(masked.dtype)))
    mask_ok = bool(masks[0, :, :k].eq(1).all()) and bool(masks[0, :, k:].eq(0).all())
    latent, = rec.decoded
    n_enc = hunyuan_mid_launches(ae, tuple(enc_in.shape), decode=False)
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    expect = {"flash_attention_fwd_sm90": n_blocks * V2V_STEPS,
              "flash_attention_fwd_d512": n_enc + hunyuan_mid_launches(ae, tuple(latent.shape), decode=True)}
    finite = bool(torch.isfinite(x).all())
    outside = float((x.abs() > 1.0).float().mean())
    res = dict(reference=os.path.basename(ref_path), encoded_frames=int(enc_in.shape[2]),
               encoded_latent_frames=int(enc_out.shape[2]), conditioned_latent_frames=k,
               encode_input_equals_read_back=read_back_equal, saved_vs_phase4_video_max_abs=enc_in_err,
               conditioned_frames_equal_encoded=cond_equal,
               masks_ok=mask_ok, video_shape=list(x.shape), encode_ref_s=timings["encode_ref_s"],
               step_s=timings["step_s"], decode_s=timings["decode_s"], total_s=total_s, outside_share=outside,
               launches=launches, expected=expect)
    log("[v2v] " + json.dumps(res))
    if tuple(enc_in.shape[2:]) != (65, opt.height, opt.width) or enc_out.shape[2] != k:
        raise AssertionError(f"v2v encoded {tuple(enc_in.shape)} -> {tuple(enc_out.shape)}, expected 65 frames, {k} "
                             "latent frames")
    if not (read_back_equal and saved_ok and cond_equal and mask_ok):
        raise AssertionError("the conditioned latent frames did not come from phase 4's video")
    if tuple(x.shape) != tuple(video.shape) or not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"v2v video {tuple(x.shape)} finite={finite} outside={outside:.4f}")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    return res


# ----------------------------------------------------------------------
# phase 5: the training path
# ----------------------------------------------------------------------

LORA_CFG = os.path.join(REPO, "configs", "diffusion", "train", "lora.py")
# the card cannot hold the "dots" checkpoints of stage1.py at this bucket
# beside the weights (about 77 GB); full recompute is a listed cut. lora.py
# names the published ./ckpts/Open_Sora_v2.safetensors and
# hunyuan_vae.safetensors, which are not in the repository: the trainer
# starts from the seed's weights (phase 13 loads checkpoints written here)
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


def run_int8_path(device, overrides, steps: int, profile: bool = False, out_dir=None, tag="int8",
                  records=None) -> dict:
    """256px_int8attn.py (with ``overrides``) for ``steps`` steps; ``records``
    (a dict) receives the MMDiT's first call under ``tag``."""
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([INT8_CFG, "--sampling_option.num_steps", str(steps), *overrides])
    log(f"[{tag}] 256px_int8attn.py{''.join(' ' + o for o in overrides)} at full width and depth (quantized="
        f"{cfg.model['quantized']}, attn_backend={cfg.model['attn_backend']}); num_steps cut 50 -> {steps}")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model, ae, t5, clip, _ = prepare_models(cfg, device=device, seed=cfg.seed)
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
    with FirstCall(model) as rec_model:
        t0 = time.perf_counter()
        x = api_fn(**run_kwargs, timings=timings)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if records is not None:
        records[tag] = rec_model
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


# ----------------------------------------------------------------------
# phases 13 and 14: checkpoints, and the VAE CLIs
# ----------------------------------------------------------------------

T5_SHARD_BYTES = 4 * 10**9  # T5-XXL's 9.5 GB in 3 shards, as a sharded HF directory holds it
CLIP_EXTRAS = {  # a CLIPModel file's keys beyond its text tower (CLIP-L's shapes)
    "vision_model.embeddings.class_embedding": (1024,), "vision_model.post_layernorm.weight": (1024,),
    "visual_projection.weight": (768, 1024), "text_projection.weight": (768, 768), "logit_scale": (),
}
MAIN_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "256px.py")  # phase 4's config
CLI_CLIPS, CLI_FRAMES, CLI_SIZE = 4, 33, 256  # phase 14's seeded clips
VAE_CLI_CFGS = {"hunyuan_vae": os.path.join(REPO, "configs", "vae", "inference", "hunyuan_vae.py"),
                "dc_ae": os.path.join(REPO, "configs", "vae", "inference", "video_dc_ae.py")}


def _tree_to(x, device):
    """Tensors in nested tuples / lists / dicts copied to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _tree_to(v, device) for k, v in x.items()}
    return x


class FirstCall:
    """Records the first call of ``obj.<method>`` while active: its
    arguments and its output, on the CPU. ``replay(fn, device)`` calls
    ``fn`` with the same arguments on ``device``."""

    def __init__(self, obj, method: str = "forward"):
        self.obj, self.method = obj, method
        self.args = self.kwargs = self.out = None

    def __enter__(self):
        fn = getattr(self.obj, self.method)

        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.out is None:
                self.args, self.kwargs, self.out = _tree_to(args, "cpu"), _tree_to(kwargs, "cpu"), _tree_to(out, "cpu")
            return out

        setattr(self.obj, self.method, rec)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.method)
        self.obj = None  # the record must not keep the model alive
        return False

    def replay(self, fn, device):
        with torch.inference_mode():
            return _tree_to(fn(*_tree_to(self.args, device), **_tree_to(self.kwargs, device)), "cpu")


def tensor_checksum(t: torch.Tensor) -> tuple:
    """(sum of the bytes, sum of the bytes weighted by a hash of their
    position) of a tensor, on its device: equal tensors have equal sums, and
    a changed, moved or swapped byte changes the second."""
    b = t.detach().reshape(-1).contiguous().view(torch.uint8) if t.numel() else torch.zeros(0, dtype=torch.uint8)
    total = weighted = 0
    for lo in range(0, b.numel(), 1 << 26):
        v = b[lo:lo + (1 << 26)].to(torch.int64)
        pos = torch.arange(lo, lo + v.numel(), device=v.device, dtype=torch.int64)
        total += int(v.sum())
        weighted += int((v * ((pos * 2654435761) % 2147483647 + 1)).sum())
    return str(t.dtype), tuple(t.shape), total, weighted


def checksums(tensors) -> dict:
    return {k: tensor_checksum(v) for k, v in tensors.items()}


def compare_checksums(tag: str, got: dict, want: dict) -> None:
    bad = sorted(set(got) ^ set(want)) + [k for k in want if k in got and got[k] != want[k]]
    log(f"[ckpt] {tag}: {len(got)} tensors loaded, {len(bad)} differ from the in-memory ones")
    if bad:
        raise AssertionError(f"{tag}: loaded tensors differ from the written ones: {bad[:8]}")


def file_bytes(path: str) -> int:
    from opensora_torch.utils.ckpt import checkpoint_files

    return sum(os.path.getsize(f) for f in checkpoint_files(path))


class LoadRecorder:
    """Times every ``utils.ckpt.load_checkpoint`` call while active (device
    synchronized around it) and samples the process's resident set every
    10 ms during it: seconds, GB/s of the checkpoint's files, the peak RSS
    above the call's start, ``getrusage``'s peak after it and the peak
    device memory during it."""

    def __init__(self):
        self.loads = []

    def __enter__(self):
        import resource

        import opensora_torch.utils.ckpt as ckpt
        from opensora_torch.tools.ckpt_io import RssSampler

        def wrap(fn):
            def timed(module, path, kind="mmdit", device=None):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with RssSampler() as rss:
                    t0 = time.perf_counter()
                    out = fn(module, path, kind, device)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                nbytes = file_bytes(path)
                self.loads.append(dict(kind=kind, file=os.path.basename(path.rstrip("/")), gb=nbytes / 1e9,
                                       seconds=seconds, gb_per_s=nbytes / 1e9 / seconds,
                                       peak_rss_above_start_gb=rss.peak_above_start / 1e9,
                                       rss_at_start_gb=rss.start / 1e9,
                                       peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                                       ru_maxrss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9))
                log(f"[ckpt] loaded {json.dumps(self.loads[-1])}")
                return out
            return timed

        self._patch = patched(ckpt, "load_checkpoint", wrap)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        return self._patch.__exit__(*exc)


def write_checkpoint(tensors, path: str) -> dict:
    from opensora_torch.utils.safetensors_io import save_file

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = save_file(tensors, path)
    seconds = time.perf_counter() - t0
    res = dict(file=os.path.basename(path), gb=nbytes / 1e9, write_s=seconds, write_gb_per_s=nbytes / 1e9 / seconds)
    log(f"[ckpt] wrote {json.dumps(res)}")
    return res


def free():
    gc.collect()
    torch.cuda.empty_cache()


def check_replay(tag: str, rec: FirstCall, fn, device, expect_launches: dict) -> dict:
    """``fn`` on the recorded call's inputs against its recorded output:
    bitwise equal (the same weights through the same deterministic kernels
    and cuBLAS calls; every replay measured on an H100 was bitwise) and
    exactly ``expect_launches``."""
    from opensora_torch.ops import _build

    _build.LAUNCHES.clear()
    out = rec.replay(fn, device)
    launches = dict(_build.LAUNCHES)
    ref = rec.out
    err = float((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1e-30))
    res = dict(bitwise_equal=bool(torch.equal(out, ref)), rel_err=err, launches=launches, expected=expect_launches)
    log(f"[ckpt] {tag}: {json.dumps(res)}")
    if not res["bitwise_equal"] or launches != expect_launches:
        raise AssertionError(f"{tag}: {res}")
    return res


def run_ckpt_path(device, records: dict, root: str, text_root: str) -> dict:
    """Phase 13: the weights of phases 4, 6 and 11, each drawn again from
    its seed (the rebuild's first step checked bitwise against the phase's),
    written with the port's writer in a published layout, freed, and loaded
    back through the entry points: the 11B MMDiT as one .safetensors in the
    published unfused layout into 256px.py's fused model (and quantized at
    load for 256px_int8attn.py), the HunyuanVAE, T5-XXL as a sharded
    HF directory, CLIP-L as a CLIPModel file (its vision keys skipped), the
    Flux image model in flux1-dev's layout (fused, q/k rows in the
    interleaved pairing) and the 2D Flux AE. Every loaded tensor equals its
    checksum; each loaded step equals its phase's first step. Files are
    deleted after their check (the VAE's is kept for phase 14, T5-XXL's
    and CLIP-L's directories under ``text_root`` for phase 17a)."""
    from opensora_torch.ops.quant import quantize_model_
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.utils.api import prepare_models, prepare_optional_models
    from opensora_torch.utils.ckpt import export_mmdit_state_dict
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.misc import torch_dtype
    from opensora_torch.utils.safetensors_io import save_sharded

    res = {"writes": [], "steps": {}}
    base_cfg = MAIN_CFG
    cfg = parse_configs([base_cfg])
    log("[ckpt] phase 4's models drawn again from the seed, written, freed and loaded back")
    free()
    model, ae, t5, clip, _ = prepare_models(cfg, device=device, seed=cfg.seed)
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    res["steps"]["rebuild_256px"] = check_replay("256px step of the model drawn again vs phase 4's",
                                                records["main"], model, device,
                                                {"flash_attention_fwd_sm90": n_blocks})
    text_dtype = torch_dtype(cfg.get("dtype", "bf16"))
    with LoadRecorder() as rec:
        # T5-XXL as a sharded HF directory, CLIP-L as a CLIPModel file
        t5_dir = os.path.join(text_root, "t5_v1_1_xxl")
        t0 = time.perf_counter()
        shards = save_sharded(t5.module.state_dict(), t5_dir, T5_SHARD_BYTES)
        res["writes"].append(dict(file="t5_v1_1_xxl/ (%d shards + index)" % len(shards), gb=file_bytes(t5_dir) / 1e9,
                                  write_s=time.perf_counter() - t0))
        want = checksums(t5.module.state_dict())
        t5_loaded = build_module(dict(cfg.t5, from_pretrained=t5_dir), MODELS, device=device, dtype=text_dtype)
        compare_checksums("T5-XXL (sharded directory)", checksums(t5_loaded.module.state_dict()), want)
        res["steps"]["t5"] = check_replay("T5-XXL loaded: embeddings of phase 4's prompts", records["t5"],
                                          t5_loaded, device, {})
        del t5_loaded, t5
        free()
        clip_dir = os.path.join(text_root, "clip_vit_large")
        os.makedirs(clip_dir)
        gen = torch.Generator(device=device).manual_seed(0)
        extras = {k: torch.randn(s, generator=gen, device=device).to(text_dtype) for k, s in CLIP_EXTRAS.items()}
        extras["text_model.embeddings.position_ids"] = torch.arange(77, device=device)[None]
        res["writes"].append(write_checkpoint({**clip.module.state_dict(), **extras},
                                              os.path.join(clip_dir, "model.safetensors")))
        want = checksums(clip.module.state_dict())
        clip_loaded = build_module(dict(cfg.clip, from_pretrained=clip_dir), MODELS, device=device, dtype=text_dtype)
        compare_checksums("CLIP-L (CLIPModel file)", checksums(clip_loaded.module.state_dict()), want)
        res["steps"]["clip"] = check_replay("CLIP-L loaded: pooled embeddings of phase 4's prompts", records["clip"],
                                            clip_loaded, device, {})
        del clip_loaded, clip, extras
        free()
        res["text_dirs"] = dict(t5=t5_dir, clip=clip_dir)  # kept for phase 17a

        # the 11B MMDiT in the published unfused layout, the HunyuanVAE
        mmdit_path = os.path.join(root, "Open_Sora_v2.safetensors")
        vae_path = os.path.join(root, "hunyuan_vae.safetensors")
        res["writes"].append(write_checkpoint(export_mmdit_state_dict(model, fused=False), mmdit_path))
        res["writes"].append(write_checkpoint(ae.state_dict(), vae_path))
        want_model, want_ae = checksums(model.state_dict()), checksums(ae.state_dict())
        quantize_model_(model, parse_configs([INT8_CFG]).model["quantized"])
        want_int8 = checksums(model.state_dict())
        del model, ae
        free()
        torch.cuda.reset_peak_memory_stats(device)
        model, ae, t5, clip, _ = prepare_models(
            parse_configs([base_cfg, "--model.from_pretrained", mmdit_path, "--ae.from_pretrained", vae_path]),
            device=device, seed=cfg.seed)
        res["peak_mem_gb_256px_load"] = torch.cuda.max_memory_allocated(device) / 1e9
        del t5, clip
        compare_checksums("MMDiT (unfused file into the fused model)", checksums(model.state_dict()), want_model)
        compare_checksums("HunyuanVAE", checksums(ae.state_dict()), want_ae)
        res["steps"]["256px"] = check_replay("256px step of the loaded MMDiT vs phase 4's first step",
                                             records["main"], model, device, {"flash_attention_fwd_sm90": n_blocks})
        del model, ae
        free()
        cfg_q = parse_configs([INT8_CFG, "--model.from_pretrained", mmdit_path, "--ae.from_pretrained", vae_path])
        model, ae, t5, clip, _ = prepare_models(cfg_q, device=device, seed=cfg.seed)
        del ae, t5, clip
        compare_checksums("MMDiT quantized at load vs quantize_model_ of the float weights",
                          checksums(model.state_dict()), want_int8)
        depth, single = cfg_q.model["depth"], cfg_q.model["depth_single_blocks"]
        res["steps"]["256px_int8attn"] = check_replay(
            "256px_int8attn step of the loaded, quantized MMDiT vs phase 6's first step", records["int8"], model,
            device, {"w8a8_matmul": 10 * depth + 3 * single, "int8_flash_attention": depth + single})
        del model
        free()
        os.remove(mmdit_path)

        # the Flux image model in flux1-dev's layout, the 2D Flux AE
        cfg_i = parse_configs([T2I2V_CFG])
        torch.manual_seed(cfg_i.seed)
        optional = prepare_optional_models(cfg_i, device)
        img_flux, img_ae = optional["img_flux"], optional["img_flux_ae"]
        n_img = cfg_i.img_flux["depth"] + cfg_i.img_flux["depth_single_blocks"]
        res["steps"]["rebuild_image"] = check_replay("image step of the model drawn again vs phase 11's",
                                                     records["img_flux"], img_flux, device,
                                                     {"flash_attention_fwd_sm90": n_img})
        flux_path, ae2d_path = os.path.join(root, "flux1-dev.safetensors"), os.path.join(root, "ae.safetensors")
        flux1_dev_layout = export_mmdit_state_dict(img_flux, fused=True, rope_convention="interleaved")
        res["writes"].append(write_checkpoint(flux1_dev_layout, flux_path))
        del flux1_dev_layout
        res["writes"].append(write_checkpoint(img_ae.state_dict(), ae2d_path))
        want_flux, want_ae2d = checksums(img_flux.state_dict()), checksums(img_ae.state_dict())
        del optional, img_flux, img_ae
        free()
        cfg_il = parse_configs([T2I2V_CFG, "--img_flux.from_pretrained", flux_path,
                                "--img_flux_ae.from_pretrained", ae2d_path])
        optional = prepare_optional_models(cfg_il, device)
        compare_checksums(f"Flux image model (flux1-dev layout, ckpt_rope_convention="
                          f"{cfg_il.img_flux['ckpt_rope_convention']})", checksums(optional["img_flux"].state_dict()),
                          want_flux)
        compare_checksums("2D Flux AE", checksums(optional["img_flux_ae"].state_dict()), want_ae2d)
        res["steps"]["image"] = check_replay("image step of the loaded Flux model vs phase 11's first step",
                                             records["img_flux"], optional["img_flux"], device,
                                             {"flash_attention_fwd_sm90": n_img})
        res["steps"]["image_decode"] = check_replay("2D Flux AE decode of the loaded AE vs phase 11's",
                                                    records["img_decode"], optional["img_flux_ae"].decode, device, {})
        del optional
        free()
        os.remove(flux_path)
        os.remove(ae2d_path)
    res["loads"] = rec.loads
    res["vae_file"] = vae_path
    return res


def write_clip_csv(root: str, n: int = CLI_CLIPS, frames: int = CLI_FRAMES, size: int = CLI_SIZE, seed: int = 0):
    """``n`` seeded clips (moving noise, mp4 through OpenCV) and their CSV."""
    import cv2
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"clip{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 16.0, (size, size))
        base = rng.integers(0, 255, (size, size, 3), np.uint8)
        for k in range(frames):
            writer.write(np.roll(base, 4 * k, axis=1))
        writer.release()
        rows.append(f"{path},clip {i},{size},{size},{frames},16.0")
    csv = os.path.join(root, "meta.csv")
    with open(csv, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return csv


def run_vae_cli_path(device, vae_file: str, root: str) -> dict:
    """Phase 14: ``vae_inference`` and ``vae_stats`` on
    configs/vae/inference/hunyuan_vae.py with phase 13's HunyuanVAE file and
    on video_dc_ae.py with phase 8's DC-AE (drawn from its seed, written in
    upstream names), over 4 seeded 33 x 256 x 256 clips: the CLIs' latent
    mean and std equal a direct encode's of the same batches with the same
    generator, PSNR is finite, and the D = 512 launches are exactly the
    mid-blocks of the encode (and decode) tiles (none for the DC-AE)."""
    from opensora_torch import vae_inference, vae_stats
    from opensora_torch.ops import _build
    from opensora_torch.utils.ckpt import init_ae
    from opensora_torch.utils.config import parse_configs

    csv = write_clip_csv(os.path.join(root, "clips"))
    dcae_path = os.path.join(root, "dc_ae.safetensors")
    vae_cfg = parse_configs([VAE_CFG])
    dcae = init_ae(dict(vae_cfg.model), device, vae_cfg.get("seed", 42), param_dtype="fp32")  # phase 8's, as built
    write_checkpoint(dcae.state_dict(), dcae_path)
    del dcae
    free()
    res = {}
    for kind, ckpt in (("hunyuan_vae", vae_file), ("dc_ae", dcae_path)):
        argv = [VAE_CLI_CFGS[kind], "--model.from_pretrained", ckpt, "--dataset.data_path", csv,
                "--save_dir", os.path.join(root, f"recon_{kind}"), "--device", str(device)]
        _build.LAUNCHES.clear()
        inf = vae_inference.main(list(argv))
        inf_launches = dict(_build.LAUNCHES)
        _build.LAUNCHES.clear()
        st = vae_stats.main(list(argv))
        st_launches = dict(_build.LAUNCHES)
        # the direct encode of the same batches with the same generator
        cfg, dataloader, ae, _, gen, _ = vae_inference.prepare_vae_eval(list(argv), lambda c: True)
        stats, enc_mid, dec_mid, n = vae_inference.LatentStats(), 0, 0, 0
        with torch.inference_mode():
            for batch in dataloader:
                x = torch.as_tensor(batch["video"]).to(device, torch.float32)
                z = ae.encode(x, generator=gen)
                stats.add(z)
                n += x.shape[0]
                if kind == "hunyuan_vae":
                    enc_mid += hunyuan_mid_launches(ae, tuple(x.shape), decode=False)
                    dec_mid += hunyuan_mid_launches(ae, tuple(z.shape), decode=True)
        direct = stats.result()
        del ae
        free()
        expect_inf = {"flash_attention_fwd_d512": enc_mid + dec_mid} if enc_mid + dec_mid else {}
        expect_st = {"flash_attention_fwd_d512": enc_mid} if enc_mid else {}
        keys = ("latent_mean", "latent_std", "latent_count")
        r = dict(clips=n, inference={k: inf[k] for k in ("psnr", "psnr_mean", "seconds_per_clip") + keys},
                 stats={k: st[k] for k in ("seconds_per_clip",) + keys}, direct={k: direct[k] for k in keys},
                 scale_factor=inf["scale_factor"], shift_factor=inf["shift_factor"],
                 launches_inference=inf_launches, expected_inference=expect_inf,
                 launches_stats=st_launches, expected_stats=expect_st)
        log(f"[vae_cli] {kind}: {json.dumps(r)}")
        if n != CLI_CLIPS or any(inf[k] != direct[k] or st[k] != direct[k] for k in keys):
            raise AssertionError(f"{kind}: the CLIs' latent statistics are not the direct encode's")
        if not all(math.isfinite(p) for p in inf["psnr"]):
            raise AssertionError(f"{kind}: PSNR not finite: {inf['psnr']}")
        if inf_launches != expect_inf or st_launches != expect_st:
            raise AssertionError(f"{kind}: D = 512 launches {inf_launches} / {st_launches} != {expect_inf} / "
                                 f"{expect_st}")
        res[kind] = r
    os.remove(dcae_path)
    return res


# ----------------------------------------------------------------------
# phases 3f, 15 and 16: the high-compression paths (Video DC-AE latents)
# ----------------------------------------------------------------------

HC_INF_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "high_compression.py")
HC_TRAIN_CFG = os.path.join(REPO, "configs", "diffusion", "train", "high_compression.py")
HC_STEPS = 2  # t2v steps of phase 15, cut from 50
HC_I2V_STEPS = 1  # i2v_head steps of phase 15
# The DC-AE halves each tile five times in space and twice in time, so a
# 256px 16:9 frame (192 x 336: tiles of 256 and 144 px) and a clip of 4k + 1
# frames (a last temporal tile of 9) cannot be encoded, in the JAX package as
# here (ROADMAP Queue 3 R11). The i2v reference and the training clip take
# the 256px bucket's 1:1 size; the clip, the 129-frame bucket's batch less
# one frame.
HC_I2V_RATIO = "1:1"
HC_TRAIN_FRAMES, HC_TRAIN_SIZE, HC_TRAIN_BATCH = 128, (256, 256), 3
# fp32 masters, their gradients, Adam's two moments and the fp32 EMA take 20
# bytes a parameter: 236 GB at full depth. 2 double + 4 single blocks are
# 1.25 B parameters (25 GB of state); the full width is kept
HC_TRAIN_DEPTH = (2, 4)
HC_TRAIN_STEPS = 3
# Phase 3f's full-depth forward, card bf16 vs the CPU's fp32 plain path, in
# relative L2 of the output. The random-weight blocks each move the residual
# stream by little: leaving out one block moves the output by 0.026 (the
# last single block) of its norm, while the bf16 path sits 0.0142 from the
# plain one (on an H100; both paths are deterministic, so the readings
# repeat). The limit lies between, and each control must exceed it
HC_DEEP_TOL = 0.02
# the DC-AE decoder, card bf16 vs CPU fp32, max|err| of the output's scale:
# it chains ~40 bf16 convolutions, norms and LiteMLA products, three times
# the dozen that SMALL_TOL was set for (read: 0.043)
HC_DCAE_TOL = 0.1
# phase 16's "full" and "offload" steps from one state, each weight
# gradient's max|difference| of its own scale: dQ's atomic sum rounds to bf16
# differently from run to run (an element by one bf16 step, 2^-8 of itself),
# and the bf16 backward carries that into the weight gradients (read: 6.6e-3
# at worst, median 2.2e-3); twice the backward kernels' own limit
HC_REMAT_GRAD_TOL = 2 * BWD_RTOL
# phase 3f's train step: Adam's eps raised from the config's 1e-8 so that the
# first update is near linear in the clipped gradient (at 1e-8 it is
# lr * sign(g), and elements whose gradient rounds near zero in bf16 flip),
# and lr from its 3e-5 so that the update stands far above the fp32 spacing
# of the parameters it is added to
HC_SMALL_ADAM = dict(lr=1e-2, eps=1e-2)
HC_PROMPT = ["a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score."]


def cpu_copy(module, **attrs):
    """An fp32 copy of ``module`` on the CPU (its compute dtype unset, so it
    computes in fp32 with the plain attention)."""
    import copy

    out = copy.deepcopy(module).to("cpu", torch.float32)
    for k, v in attrs.items():
        setattr(out, k, v)
    return out


def mmdit_forward_streamed(model, inputs: dict) -> torch.Tensor:
    """``model``'s forward in fp32 on the CPU, one block copied there at a
    time (host memory holds one block, not the 47.6 GB of fp32 weights)."""
    import torch.nn as nn

    blocks = model.double_blocks, model.single_blocks
    model.double_blocks, model.single_blocks = nn.ModuleList(), nn.ModuleList()
    try:
        shell = cpu_copy(model, compute_dtype=None)
    finally:
        model.double_blocks, model.single_blocks = blocks
    with torch.no_grad():
        img, txt, vec, pe = shell.prepare_block_inputs(**inputs)
        for block in model.double_blocks:
            img, txt = cpu_copy(block)(img, txt, vec, pe)
        x = torch.cat([txt, img], dim=1)
        for block in model.single_blocks:
            x = cpu_copy(block)(x, vec, pe)
        return shell.final_layer(x[:, txt.shape[1]:], vec)


def check_hc_small_input(device, model, ae) -> dict:
    """Phase 3f, inference: phase 15's full-width, full-depth MMDiT (19 + 38
    blocks, 128 latent channels, patch 1) on a small latent (2 x 2 x 3
    tokens, 16 of text), the card's bf16 path (57 launches of the D = 128
    forward) against the port's fp32 plain path on the CPU, streamed block
    by block; controls with the first double block or the last single
    block skipped on the card must exceed the limit. And phase 15's DC-AE
    decoder on a 2 x 2 x 2 latent, card bf16 against CPU fp32."""
    from opensora_torch.ops import _build
    from opensora_torch.utils.sampling import build_img_ids

    mc = model.config
    gen = torch.Generator().manual_seed(5)
    b, t, h, w, lt = 1, 2, 2, 3, 16
    n_img = t * h * w
    inputs = dict(img=torch.randn(b, n_img, mc.in_channels, generator=gen),
                  img_ids=build_img_ids(t, h, w, patch_size=1, bs=b).contiguous(),
                  txt=torch.randn(b, lt, mc.context_in_dim, generator=gen), txt_ids=torch.zeros(b, lt, 3),
                  timesteps=torch.rand(b, generator=gen), y_vec=torch.randn(b, mc.vec_in_dim, generator=gen),
                  cond=torch.randn(b, n_img, mc.in_channels + mc.patch_size**2, generator=gen))
    on_card = {k: v.to(device) for k, v in inputs.items()}
    n_blocks = mc.depth + mc.depth_single_blocks
    _build.LAUNCHES.clear()
    with torch.inference_mode():
        out = model(**on_card).float().cpu()
    launches = dict(_build.LAUNCHES)
    controls = {}
    for name, block in (("first_double_block_skipped", model.double_blocks[0]),
                        ("last_single_block_skipped", model.single_blocks[-1])):
        handle = block.register_forward_hook(lambda mod, args, res: args[:2] if len(args) == 4 else args[0])
        try:
            with torch.inference_mode():
                controls[name] = model(**on_card).float().cpu()
        finally:
            handle.remove()
    t0 = time.perf_counter()
    ref = mmdit_forward_streamed(model, inputs)
    cpu_s = time.perf_counter() - t0

    def rel_l2(a, r):
        return float((a - r).norm() / r.norm())

    res = dict(mmdit_rel_l2=rel_l2(out, ref), mmdit_max_abs_rel=float((out - ref).abs().max() / ref.abs().max()),
               controls_rel_l2={k: rel_l2(v, ref) for k, v in controls.items()}, tol=HC_DEEP_TOL, launches=launches,
               expected={"flash_attention_fwd_sm90": n_blocks}, cpu_streamed_s=cpu_s, ref_max_abs=float(ref.abs().max()))
    z = torch.randn(1, ae.config.latent_channels, 2, 2, 2, generator=gen)
    with torch.inference_mode():
        card_x = ae.decode(z.to(device)).float().cpu()
        cpu_x = cpu_copy(ae, compute_dtype=None).decode(z)
    res["dc_ae_decode_rel_err"] = float((card_x - cpu_x).abs().max() / cpu_x.abs().max().clamp(min=1.0))
    res["dc_ae_decode_shape"] = list(card_x.shape)
    ok = (res["mmdit_rel_l2"] <= HC_DEEP_TOL < min(res["controls_rel_l2"].values())
          and launches == res["expected"] and res["dc_ae_decode_rel_err"] <= HC_DCAE_TOL)
    log(f"[small] high compression: full-width, full-depth MMDiT ({n_blocks} blocks, {n_img} + {lt} tokens), card "
        f"bf16 + kernel vs CPU fp32 plain (streamed): {json.dumps(res)} (tol {HC_DEEP_TOL} in relative L2, the "
        f"controls above it; the DC-AE decode {HC_DCAE_TOL} of the output's scale) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's high-compression path disagrees with the plain path on a small input")
    return res


def check_hc_train_small_input(device) -> dict:
    """Phase 3f, training: one full-finetune step of the training config's
    MMDiT at full width, depth 1 + 1, on a small batch (3 x 12 latent
    tokens, 32 of text, i2v_head masks on the first sample): the card's fp32
    masters computing in bf16 (the kernels; "dots" recompute) against the
    CPU's fp32 plain step from the same weights, batch and draws. The loss
    to SMALL_TOL; each parameter's gradient and its update by clip + AdamW
    to TRAIN_GRAD_TOL of its own scale."""
    from opensora_torch.ops import _build
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.training.diffusion import TrainState, compute_shift_alpha, make_train_step
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.optimizer import create_optimizer
    from opensora_torch.utils.sampling import build_img_ids, pack

    cfg = parse_configs([HC_TRAIN_CFG])
    mcfg = dict(cfg.model, depth=1, depth_single_blocks=1, param_dtype="fp32")
    torch.manual_seed(0)
    card = build_module(mcfg, MODELS, device=device).requires_grad_(True)
    cpu = build_module(dict(mcfg, dtype="fp32"), MODELS, device="meta")
    cpu.load_state_dict({k: v.detach().cpu().clone() for k, v in card.state_dict().items()}, assign=True)
    cpu.requires_grad_(True)
    gen = torch.Generator().manual_seed(4)
    b, t, h, w, lt, c = 3, 2, 2, 3, 32, mcfg["in_channels"]
    n_img = t * h * w
    bf = lambda *shape: torch.randn(shape, generator=gen).to(torch.bfloat16).float()  # noqa: E731
    masks = torch.zeros(b, 1, t, h, w)
    masks[0, :, 0] = 1
    batch = dict(x0=bf(b, n_img, c), img_ids=build_img_ids(t, h, w, patch_size=1, bs=b).contiguous(),
                 txt=bf(b, lt, mcfg["context_in_dim"]), txt_ids=torch.zeros(b, lt, 3), y_vec=bf(b, mcfg["vec_in_dim"]),
                 cond=pack(torch.cat([masks, masks * bf(b, c, t, h, w)], 1), 1), masks=masks,
                 shift_alpha=torch.full((b,), compute_shift_alpha(h, w, t)),
                 null_txt=bf(b, lt, mcfg["context_in_dim"]), null_vec=bf(b, mcfg["vec_in_dim"]))
    draws = dict(t=torch.rand(b, generator=gen), x1=torch.randn(b, n_img, c, generator=gen),
                 drop_txt=torch.tensor([False, True, False]), drop_vec=torch.tensor([False, False, True]))

    def step(model, dev, dtype):
        opt = create_optimizer(list(model.parameters()), weight_decay=cfg.weight_decay, warmup_steps=0,
                               grad_clip=cfg.grad_clip, **HC_SMALL_ADAM)
        state = TrainState.create(model, opt)
        grads = {}
        for n, p in state.params.items():
            p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().float().cpu()))
        before = {n: p.detach().cpu().clone() for n, p in state.params.items()}
        on = {k: v.to(dev, dtype if k in ("x0", "txt", "y_vec", "cond", "null_txt", "null_vec") else v.dtype)
              for k, v in batch.items()}
        metrics = make_train_step(model, ema_decay=cfg.ema_decay, text_dropout_prob=0.5, use_masked_loss=True,
                                  patch_size=1)(state, on, draws={k: v.to(dev) for k, v in draws.items()})
        upd = {n: p.detach().cpu() - before[n] for n, p in state.params.items()}
        return float(metrics["loss"]), grads, upd

    _build.LAUNCHES.clear()
    loss_card, g_card, u_card = step(card, device, torch.bfloat16)
    launches = dict(_build.LAUNCHES)
    loss_cpu, g_cpu, u_cpu = step(cpu, "cpu", torch.float32)

    def worst(a, r):
        rel = {n: float((a[n] - x).abs().max() / x.abs().max()) for n, x in r.items() if x.abs().max() > 0}
        n = max(rel, key=rel.get)
        return rel[n], n, sorted(rel.values())[len(rel) // 2]

    g_rel, g_name, g_med = worst(g_card, g_cpu)
    u_rel, u_name, u_med = worst(u_card, u_cpu)
    expect = {"flash_attention_fwd_sm90": 4, "flash_attention_bwd_fused": 2, "flash_attention_bwd_dq_convert": 2}
    res = dict(loss_card=loss_card, loss_cpu=loss_cpu, loss_rel_err=abs(loss_card - loss_cpu) / abs(loss_cpu),
               grad_rel_err_max=g_rel, grad_rel_err_worst=g_name, grad_rel_err_median=g_med,
               update_rel_err_max=u_rel, update_rel_err_worst=u_name, update_rel_err_median=u_med,
               moved=sum(bool(u.abs().max() > 0) for u in u_card.values()), params=len(u_card),
               launches=launches, expected=expect)
    del card, cpu
    torch.cuda.empty_cache()
    ok = (res["loss_rel_err"] <= SMALL_TOL and g_rel <= TRAIN_GRAD_TOL and u_rel <= TRAIN_GRAD_TOL
          and res["moved"] == res["params"] and launches == expect)
    log(f"[small] high compression: full-finetune step (fp32 masters, bf16 compute, remat "
        f"{mcfg.get('remat_policy')}), full-width MMDiT depth 1+1 (B={b}, {n_img + lt} tokens), card vs CPU fp32 "
        f"plain: {json.dumps(res)} (tol loss {SMALL_TOL}, each gradient and update {TRAIN_GRAD_TOL} of its scale) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's full-finetune step disagrees with the plain step on a small input")
    return res


def run_hc_inference_path(device, root: str, profile: bool = False, out_dir=None) -> dict:
    """Phase 15: configs/diffusion/inference/high_compression.py at full
    width and depth (random weights from the config's seed) through
    prepare_models and api_fn: t2v at the config's 192 x 336, 129 frames
    (32 x 6 x 11 latent tokens; decoded 128 x 192 x 352, as the JAX package
    decodes it), HC_STEPS steps, then i2v_head for HC_I2V_STEPS from a
    seeded 256 x 256 image (HC_I2V_RATIO: the DC-AE cannot encode the 16:9
    frame), its 3 padding frames trimmed. Checks shapes, finite videos, the
    first latent frame equal to the encoded reference and the exact
    launches (57 a step at D = 128, none at D = 512); phase 3f runs on the
    built models first."""
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.inference import save_sample
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([HC_INF_CFG, "--sampling_option.num_steps", str(HC_STEPS)])
    log(f"[hc] high_compression.py at full width and depth; num_steps cut 50 -> {HC_STEPS} (t2v), "
        f"{HC_I2V_STEPS} (i2v_head at {HC_I2V_RATIO})")
    free()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model, ae, t5, clip, _ = prepare_models(cfg, device=device, seed=cfg.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated(device) / 1e9
    log(f"[hc] models built on {device} in {build_s:.1f} s: MMDiT {sum(p.numel() for p in model.parameters()) / 1e9:.2f}B, "
        f"DC-AE {sum(p.numel() for p in ae.parameters()) / 1e6:.1f}M params; resident {resident_gb:.2f} GB")
    small = check_hc_small_input(device, model, ae)
    compression = ae_spatial_compression(cfg)
    api_fn = prepare_api(model, ae, t5, clip, spatial_compression=compression)
    patch, channel = cfg.patch_size, cfg.model["in_channels"]
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    runs = {}
    ref_path = None
    for cond_type, opt_over in (("t2v", {}), ("i2v_head", dict(aspect_ratio=HC_I2V_RATIO, num_steps=HC_I2V_STEPS))):
        opt = sanitize_sampling_option(SamplingOption(**dict(cfg.sampling_option, **opt_over)))
        kw = {}
        if cond_type != "t2v":
            img = torch.rand((3, 1, opt.height, opt.width), generator=torch.Generator().manual_seed(cfg.seed)) * 2 - 1
            ref_path = save_sample(img.numpy(), os.path.join(root, "hc_reference"))
            kw["ref"] = [ref_path]
        latent = (opt.num_frames // opt.temporal_reduction, math.ceil(opt.height / compression),
                  math.ceil(opt.width / compression))
        torch.cuda.reset_peak_memory_stats(device)
        _build.LAUNCHES.clear()
        timings: dict = {}
        with AERecorder(ae) as rec:
            t0 = time.perf_counter()
            x = api_fn(opt, cond_type, seed=cfg.seed, text=HC_PROMPT, patch_size=patch, channel=channel,
                       timings=timings, **kw)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        frames = min(opt.num_frames, latent[0] * opt.temporal_reduction) - (3 if cond_type == "i2v_head" else 0)
        expect_shape = (1, 3, frames, latent[1] * compression, latent[2] * compression)
        expect = {"flash_attention_fwd_sm90": n_blocks * opt.num_steps}
        r = dict(size=[opt.height, opt.width], latent=list(latent), tokens=latent[0] * latent[1] * latent[2],
                 video_shape=list(x.shape), expected_shape=list(expect_shape), finite=bool(torch.isfinite(x).all()),
                 outside_share=float((x.abs() > 1.0).float().mean()), range=[float(x.min()), float(x.max())],
                 text_encode_s=timings["text_encode_s"], step_s=timings["step_s"], decode_s=timings["decode_s"],
                 total_s=total_s, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9, launches=launches,
                 expected=expect)
        if cond_type != "t2v":
            (enc_in, enc_out), = rec.encoded
            decoded, = rec.decoded
            r["encode_ref_s"] = timings["encode_ref_s"]
            r["reference_latent_shape"] = list(enc_out.shape)
            r["first_latent_frame_equals_encoded_reference"] = bool(
                torch.equal(decoded[0, :, :1], enc_out[0][:, :1].to(decoded.dtype)))
        runs[cond_type] = r
        log(f"[hc] {cond_type}: {json.dumps(r)}")
        # a random DC-AE decoder has no trained output range: finite is what holds
        if tuple(x.shape) != expect_shape or not r["finite"]:
            raise AssertionError(f"{cond_type}: video {tuple(x.shape)} (expected {expect_shape}), finite {r['finite']}")
        if launches != expect:
            raise AssertionError(f"{cond_type}: kernel launches {launches} != expected {expect}")
        if cond_type != "t2v" and not r["first_latent_frame_equals_encoded_reference"]:
            raise AssertionError("i2v_head: the first latent frame is not the encoded reference")
        del x
    res = dict(models_build_s=build_s, resident_gb=resident_gb, small_input=small, **runs)
    if profile:
        opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option))
        res["profile"] = profile_run(lambda: api_fn(opt, "t2v", seed=cfg.seed, text=HC_PROMPT, patch_size=patch,
                                                    channel=channel), "hc", out_dir)
    del model, ae, t5, clip, api_fn
    free()
    return res


def run_hc_train_path(device, profile: bool = False, out_dir=None) -> dict:
    """Phase 16: configs/diffusion/train/high_compression.py, a full finetune
    (fp32 masters, bf16 compute, the config's remat_policy "dots") at full
    width and HC_TRAIN_DEPTH blocks, through the training CLI's per-batch
    body (Trainer.run_batch: the DC-AE encode, the mask-type draw, the
    single-frame encodes, T5 / CLIP, the step) for HC_TRAIN_STEPS steps on a
    seeded HC_TRAIN_FRAMES x 256 x 256 clip, B = HC_TRAIN_BATCH. Then, from
    one saved state, batch and generator state, one step with "full" and
    one with "offload": bitwise equal losses (the same forward), gradients
    within HC_REMAT_GRAD_TOL of each other (dQ's atomic sum orders differently from
    run to run; the parameters after AdamW are counted where they differ),
    and the device memory above the step's start held after the forward and
    at the forward's and the backward's peaks side by side: "offload" must
    hold less through the forward (the blocks' saved inputs wait in host
    memory); the backward's peak, reached as the fp32 gradients fill in,
    is printed. Then rf_eval_loss over the trained model. Non-finite
    losses, parameters that did not move or inexact launches fail."""
    from opensora_torch.eval.rf_loss import rf_eval_loss
    from opensora_torch.ops import _build
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    depth, single = HC_TRAIN_DEPTH
    cfg = parse_configs([HC_TRAIN_CFG, "--model.depth", str(depth), "--model.depth_single_blocks", str(single)])
    n_blocks = depth + single
    h, w = HC_TRAIN_SIZE
    log(f"[hc_train] high_compression.py full finetune at full width, depth {depth}+{single} (cut from 19+38); "
        f"{HC_TRAIN_STEPS} steps on a {HC_TRAIN_FRAMES}x{h}x{w} clip, B={HC_TRAIN_BATCH}, remat "
        f"{cfg.model['remat_policy']}")
    free()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = trainer.state
    n_params = sum(p.numel() for p in state.params.values())
    dtypes = sorted({str(p.dtype) for p in state.params.values()})
    log(f"[hc_train] built in {build_s:.1f} s: {n_params / 1e9:.3f}B trainable MMDiT params ({dtypes}, computing in "
        f"{trainer.model.dtype}); {torch.cuda.memory_allocated(device) / 1e9:.2f} GB allocated")
    if dtypes != ["torch.float32"] or trainer.model.dtype != torch.bfloat16:
        raise AssertionError(f"the full finetune trains {dtypes} computing in {trainer.model.dtype}")
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    video = torch.rand((HC_TRAIN_BATCH, 3, HC_TRAIN_FRAMES, h, w), generator=gen, device=device) * 2 - 1
    batch = {"video": video, "text": ["a red panda eating bamboo in a misty forest",
                                      "waves breaking on a rocky shore at sunset",
                                      "a city street at night in the rain, neon signs"]}
    start = {n: p.detach().clone() for n, p in state.params.items()}
    captured: dict = {}
    train_step = trainer.train_step

    def capture(st, tb, generator=None):
        captured["tb"] = tb
        return train_step(st, tb, generator)

    trainer.train_step = capture
    expect = {"flash_attention_fwd_sm90": 2 * n_blocks,  # forward and recompute
              "flash_attention_bwd_fused": n_blocks, "flash_attention_bwd_dq_convert": n_blocks}
    steps = []
    for i in range(HC_TRAIN_STEPS):
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        metrics = trainer.run_batch(batch)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        times = trainer.timers.to_dict()
        rec = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]), mask_conds=trainer.mask_conds,
                   lr=state.optimizer.adamw.param_groups[0]["lr"], launches=dict(_build.LAUNCHES), expected=expect,
                   encode_video_s=times["time/encode_video"], encode_text_s=times["time/encode_text"],
                   step_s=times["time/step"], total_s=total_s)
        steps.append(rec)
        log(f"[hc_train] step {i + 1}: " + json.dumps(rec))
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0):
            raise AssertionError(f"step {i + 1}: loss {rec['loss']} or grad norm {rec['grad_norm']} not finite and > 0")
        if rec["launches"] != expect:
            raise AssertionError(f"step {i + 1}: kernel launches {rec['launches']} != expected {expect}")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    still = [n for n, p in state.params.items() if torch.equal(p, start[n])]
    del start
    tb = captured["tb"]
    tokens = tb["x0"].shape[1] + tb["txt"].shape[1]
    log(f"[hc_train] {HC_TRAIN_STEPS} steps OK; {tokens} tokens a sample ({tb['x0'].shape[1]} latent + "
        f"{tb['txt'].shape[1]} text); peak_mem_gb={peak_gb:.2f}; parameters that did not move: {len(still)}")
    if still or peak_gb >= 80:
        raise AssertionError(f"parameters that did not move: {still[:8]}; peak memory {peak_gb:.2f} GB")

    # one step from one saved state with "full", then with "offload"
    from opensora_torch.training import diffusion as tdiff

    snapshot = _tree_to(state.state_dict(), "cpu")
    rng_states = trainer.gen.get_state(), dict(trainer.host_rng.bit_generator.state)
    optimizer_step = state.optimizer.step
    reading: dict = {}

    def gb_above_start(nbytes):
        return (nbytes - reading["start"]) / 1e9

    def step_from_reset(st, tb_, generator=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reading["start"] = torch.cuda.memory_allocated(device)
        return train_step(st, tb_, generator)

    def loss_reading_memory(fn):
        def wrapped(*args, **kwargs):
            loss = fn(*args, **kwargs)
            reading["forward_peak_gb"] = gb_above_start(torch.cuda.max_memory_allocated(device))
            reading["held_after_forward_gb"] = gb_above_start(torch.cuda.memory_allocated(device))
            return loss
        return wrapped

    def step_reading_backward():
        reading["backward_peak_gb"] = gb_above_start(torch.cuda.max_memory_allocated(device))
        reading["grads"] = {n: p.grad for n, p in state.params.items()}
        optimizer_step()

    remat = {}
    state.optimizer.step = step_reading_backward
    trainer.train_step = step_from_reset
    try:
        with patched(tdiff, "compute_loss", loss_reading_memory):
            for policy in ("full", "offload"):
                if policy != "full":
                    state.load_state_dict(snapshot)
                    trainer.gen.set_state(rng_states[0])
                    trainer.host_rng.bit_generator.state = rng_states[1]
                trainer.model.config.remat_policy = policy
                _build.LAUNCHES.clear()
                t0 = time.perf_counter()
                metrics = trainer.run_batch(batch)
                torch.cuda.synchronize()
                remat[policy] = dict(loss=metrics["loss"].detach().clone(), grad_norm=float(metrics["grad_norm"]),
                                     step_s=trainer.timers.to_dict()["time/step"], total_s=time.perf_counter() - t0,
                                     launches=dict(_build.LAUNCHES), mask_conds=trainer.mask_conds,
                                     grads=reading.pop("grads"),
                                     params={n: p.detach().clone() for n, p in state.params.items()},
                                     **{k: reading[k] for k in ("held_after_forward_gb", "forward_peak_gb",
                                                                "backward_peak_gb")})
    finally:
        del state.optimizer.step
        trainer.train_step = train_step
        trainer.model.config.remat_policy = cfg.model["remat_policy"]
    full, off = remat["full"], remat["offload"]
    grad_rel = {n: float((off["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                for n, g in full["grads"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    n_diff = n_over = 0
    for n, p in off["params"].items():
        d = (p - full["params"][n]).abs()
        n_diff += int((d > 0).sum())
        n_over += int((d > torch.abs(p).nextafter(torch.full_like(p, math.inf)) - torch.abs(p)).sum())
    for r in remat.values():
        del r["grads"], r["params"]
    del snapshot
    cmp = dict(loss_full=float(full["loss"]), loss_offload=float(off["loss"]),
               loss_bitwise_equal=bool(torch.equal(full["loss"], off["loss"])),
               grad_rel_err_max=grad_rel[worst], grad_rel_err_worst=worst,
               grad_rel_err_median=sorted(grad_rel.values())[len(grad_rel) // 2], grad_tol=HC_REMAT_GRAD_TOL,
               params_differing=n_diff, params_differing_by_more_than_their_spacing=n_over, params=n_params,
               **{f"{k}_{p}": remat[p][k] for p in remat for k in (
                   "grad_norm", "held_after_forward_gb", "forward_peak_gb", "backward_peak_gb", "step_s",
                   "launches")})
    log("[hc_train] full vs offload from one state (memory above the step's start): " + json.dumps(cmp))
    if (not cmp["loss_bitwise_equal"] or grad_rel[worst] > HC_REMAT_GRAD_TOL or full["launches"] != expect
            or off["launches"] != expect or full["mask_conds"] != off["mask_conds"]):
        raise AssertionError(f"remat full vs offload: {cmp}")
    if not (off["held_after_forward_gb"] < full["held_after_forward_gb"] and off["forward_peak_gb"] < full["forward_peak_gb"]):
        raise AssertionError("offload holds no less device memory than full through the forward")

    x0 = tb["x0"]
    kwargs = {k: tb[k] for k in ("img_ids", "txt", "txt_ids", "y_vec", "cond", "guidance")}
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    ev = rf_eval_loss(trainer.model, x0, kwargs, torch.Generator(device=device).manual_seed(cfg.seed))
    torch.cuda.synchronize()
    ev = {k: float(v) for k, v in ev.items()}
    eval_launches = dict(_build.LAUNCHES)
    eval_expect = {"flash_attention_fwd_sm90": 5 * n_blocks}
    log(f"[hc_train] rf_eval_loss over the trained model: {json.dumps(ev)} in {time.perf_counter() - t0:.3f} s; "
        f"launches {eval_launches} (expected {eval_expect})")
    if not all(math.isfinite(v) for v in ev.values()) or eval_launches != eval_expect:
        raise AssertionError(f"rf_eval_loss: {ev}, launches {eval_launches}")
    total = {k: sum(r["launches"].get(k, 0) for r in steps) for k in expect}
    res = dict(depth=[depth, single], params=n_params, models_build_s=build_s, steps=steps, launches=total,
               peak_mem_gb=peak_gb, tokens=tokens, remat_full_vs_offload=cmp, eval=ev, eval_launches=eval_launches)
    if profile:
        res["profile"] = profile_run(lambda: trainer.run_batch(batch), "hc_train", out_dir)
    del trainer, state, video, batch, captured, tb, x0, kwargs
    free()
    return res


# ----------------------------------------------------------------------
# phases 3g and 17: tokenizers from the checkpoint directories, and the
# evaluation CLI (CLIP ViT-L/14 scorer, aesthetic head, VBench-style suites)
# ----------------------------------------------------------------------

# Text that predates the port and stays as it is: the tokenizer files are
# generated from it, so that ids computed once on the CPU stay right.
TOKENIZER_CORPUS = ("docs", "opensora_tpu")
# phase 17a's prompt: one of the VBench overall_consistency suite's, so that
# phase 17b's --suite run matches the sample through its --motion-score
# suffix (ROADMAP R3)
TOK_PROMPT = "a dog jumping over a log near the campsite"
TOK_SUITE = "overall_consistency"
TOK_MOTION = "4"
# a text through the T5 charsmap (ligature, full-width letters, no-break space)
TOK_PROBE = "ﬁne Ａpples on a ①st ﬂoor"
# ids computed on the CPU from the files write_{t5,clip}_tokenizer_files
# generate, for TOK_PROMPT + " 4 motion score." (to the end token) and TOK_PROBE
T5_PROMPT_IDS = [144, 1635, 73, 227, 2338, 238, 1356, 144, 2271, 118, 3462, 207, 169, 566, 85, 883, 2662, 6719, 2123,
                 16, 1]
CLIP_PROMPT_IDS = [49406, 320, 7962, 73, 5380, 79, 520, 326, 782, 320, 1223, 77, 1232, 337, 516, 2702, 79, 12277, 324,
                   275, 667, 615, 660, 82, 622, 1165, 269, 49407]
T5_PROBE_IDS = [118, 9692, 1096, 82, 4620, 647, 144, 269, 138, 1153, 128, 1]
# Phase 3g: the CLIP towers at full size, fp32 with TF32 off, card against
# CPU: the same products summed in another order, ~1e-6 of the scale per
# layer, 24 + 12 pre-LN layers; a tower with one layer skipped must fail.
CLIP_CARD_TOL = 1e-4
EVAL_CLIP_FRAMES, EVAL_CLIP_SIZE = 33, (192, 336)  # phase 17b's seeded clips: 33 frames at 256px.py's 192 x 336
EVAL_SLOTS = {  # phase 17b's seeded clips: each names one detection dimension (and its slot) in its sidecar
    "object_class": {"object": "dog"}, "multiple_objects": {"objects": ["cat", "dog"]},
    "color": {"color_object": ["red", "car"]}, "spatial_relationship": {"spatial": ["cat", "left", "dog"]},
    "scene": {"scene": "beach"}, "human_action": {"action": "dancing"},
}
EVAL_STYLED = {"appearance_style": "a river at dawn, in the style of Van Gogh",
               "temporal_style": "a busy market, zoom in"}
# Phase 17b, every sample twice: each mean over its values twice (the same
# scores, from fp32 towers, summed in another order); the peak may grow by
# less than one of the smallest sample's float32 copies on the card
# (33 x 192 x 336 x 3 x 4 bytes = 25.5 MB), so holding one more video there
# fails.
EVAL_TWICE_TOL = 1e-6
EVAL_PEAK_GROWTH = 8e6  # bytes


def tokenizer_corpus() -> str:
    parts = []
    for top in TOKENIZER_CORPUS:
        for root, dirs, names in os.walk(os.path.join(REPO, top)):
            dirs.sort()
            for name in sorted(names):
                if name.endswith((".md", ".py")):
                    with open(os.path.join(root, name), encoding="utf-8") as f:
                        parts.append(f.read())
    return "\n".join(parts)


def write_clip_tokenizer_files(directory: str, corpus: str) -> int:
    """CLIP's vocab.json and merges.txt at the published sizes: the 256
    byte symbols, each again with </w>, 48894 merges, <|startoftext|> 49406
    and <|endoftext|> 49407. The merges build the corpus's words left to
    right (most frequent words first), then pairs over the byte alphabet
    fill the count. Returns the vocabulary's size."""
    import collections

    from opensora_torch.models.text import clip_tokenizer as ct

    be = ct.bytes_to_unicode()
    words = collections.Counter("".join(be[b] for b in w.encode("utf-8"))
                                for w in ct.split_words(ct.basic_clean(corpus)))
    merges, seen = [], set()

    def add(pair):
        if pair not in seen and len(merges) < ct.MAX_MERGES:
            seen.add(pair)
            merges.append(pair)

    for w, _ in sorted(words.items(), key=lambda kv: (-kv[1], kv[0])):
        cur = w[0] if len(w) > 1 else w + "</w>"
        for i, ch in enumerate(w[1:], 1):
            nxt = ch + ("</w>" if i == len(w) - 1 else "")
            add((cur, nxt))
            cur += nxt
    symbols = list(be.values())
    for a in symbols:
        for b in symbols:
            add((a, b))
    vocab = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges] + ["<|startoftext|>",
                                                                                     "<|endoftext|>"]
    if len(set(vocab)) != 49408:
        raise AssertionError(f"CLIP vocabulary of {len(set(vocab))} entries")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({v: i for i, v in enumerate(vocab)}, f)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return len(vocab)


def _pb_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        out.append((v & 0x7F) | (0x80 if v > 0x7F else 0))
        v >>= 7
        if not v:
            return bytes(out)


def _pb_field(number: int, value) -> bytes:
    """One protobuf field: length-delimited for bytes / str, fixed32 for a
    float, else a varint."""
    import struct

    if isinstance(value, (bytes, str)):
        value = value.encode("utf-8") if isinstance(value, str) else value
        return _pb_varint(number << 3 | 2) + _pb_varint(len(value)) + value
    if isinstance(value, float):
        return _pb_varint(number << 3 | 5) + struct.pack("<f", value)
    return _pb_varint(number << 3) + _pb_varint(int(value))


def write_spiece_model(path: str, m) -> None:
    """Write a ``t5_tokenizer.ModelProto`` as a ``spiece.model`` file (the
    field numbers the reader takes)."""
    from opensora_torch.models.text import t5_tokenizer as tt

    out = bytearray()
    for piece, score, kind in m.pieces:
        out += _pb_field(1, _pb_field(1, piece) + _pb_field(2, float(score)) + _pb_field(3, kind))
    out += _pb_field(2, b"".join(_pb_field(n, getattr(m, name)) for n, name in sorted(tt._TRAINER.items())))
    out += _pb_field(3, _pb_field(1, "nmt_nfkc" if m.precompiled_charsmap else "identity")
                     + b"".join(_pb_field(n, getattr(m, name)) for n, name in sorted(tt._NORMALIZER.items())))
    with open(path, "wb") as f:
        f.write(bytes(out))


def build_charsmap(rules: dict) -> bytes:
    """The ``precompiled_charsmap`` blob that replaces each key of ``rules``
    (longest key first) by its value: a darts-clone double array over the
    keys' UTF-8 bytes (a node's children at ``pos ^ offset ^ label``, its
    value in the label-0 child), padded to whole 256-unit blocks, and the
    NUL-terminated values."""
    import struct

    import numpy as np

    normalized, value_of = bytearray(), {}
    trie: dict = {}
    for key, repl in sorted(rules.items()):
        if not key or "\0" in key + repl:
            raise ValueError(f"bad rule {key!r} -> {repl!r}")
        value_of[key] = len(normalized)
        normalized += repl.encode("utf-8") + b"\0"
        node = trie
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[0] = value_of[key]  # label 0: the leaf
    units = [0]
    used, bases = {0}, set()
    first_free = [1]

    def free_base(pos: int, labels: list) -> int:
        while first_free[0] in used:
            first_free[0] += 1
        slot = first_free[0]
        while True:  # the first base whose label slots are all free
            base = slot ^ labels[0]
            if (slot not in used and base and base not in bases and (pos ^ base) < 1 << 21
                    and not any(base ^ c in used for c in labels)):
                return base
            slot += 1

    def place(node: dict, pos: int) -> None:
        labels = sorted(node)
        base = free_base(pos, labels)
        bases.add(base)
        offset = pos ^ base
        units[pos] = (units[pos] & ((1 << 31) | 0x1FF)) | (offset << 10)
        for c in labels:
            used.add(base ^ c)
        units.extend([0] * (max(base ^ c for c in labels) + 1 - len(units)))
        for c in labels:
            child = base ^ c
            if c == 0:
                units[child] = node[0] | (1 << 31)
                units[pos] |= 1 << 8  # has_leaf
            else:
                units[child] = c
        for c in labels:
            if c:
                place(node[c], base ^ c)

    place(trie, 0)
    # every lookup ``base ^ byte`` lands in the 256-unit block of its base: pad to whole blocks
    units.extend([0] * ((max(bases) | 0xFF) + 1 - len(units)))
    blob = np.asarray(units, "<u4").tobytes()
    return struct.pack("<I", len(blob)) + blob + bytes(normalized)


def write_t5_tokenizer_files(directory: str, corpus: str) -> int:
    """T5's spiece.model at the published size: 32000 pieces, <pad> 0, </s> 1,
    <unk> 2, then the corpus's characters and its most frequent substrings
    of up to 8 characters (a word-start mark first where they start a
    word), scored by log frequency; a non-empty precompiled_charsmap of
    NFKC rules (ligatures, full-width and enclosed forms, spaces) and tabs
    and newlines to spaces. Returns the number of pieces."""
    import collections
    import heapq
    import unicodedata

    from opensora_torch.models.text import t5_tokenizer as tt

    counts = collections.Counter()
    for w, n in collections.Counter(corpus.split()).items():
        w = tt.SPACE + w
        for i in range(len(w)):
            for j in range(i + 1, min(len(w), i + 8) + 1):
                counts[w[i:j]] += n
    chars = sorted({c for c in corpus if not c.isspace()} | set(map(chr, range(33, 127))) | {tt.SPACE})
    ranked = [p for p, _ in heapq.nsmallest(32000 - 3 - len(chars), ((p, n) for p, n in counts.items()
                                                                     if len(p) > 1 and tt.SPACE not in p[1:]),
                                            key=lambda kv: (-kv[1], kv[0]))]
    pieces = chars + ranked[:32000 - 3 - len(chars)]
    total = sum(counts.values())
    ranges = [(0xA0, 0xFF), (0x2000, 0x206F), (0x2100, 0x218F), (0x2460, 0x24FF), (0x3000, 0x3000), (0xFB00, 0xFB4F),
              (0xFF01, 0xFF60)]
    rules = {c: n for lo, hi in ranges for c in map(chr, range(lo, hi + 1))
             if (n := unicodedata.normalize("NFKC", c)) != c and n and "\0" not in n}
    rules.update({"\t": " ", "\n": " ", "\r": " "})
    model = tt.ModelProto(
        pieces=[("<pad>", 0.0, tt.CONTROL), ("</s>", 0.0, tt.CONTROL), ("<unk>", 0.0, tt.UNKNOWN)]
        + [(p, math.log(max(counts[p], 1) / total), tt.NORMAL) for p in pieces],
        unk_id=2, bos_id=-1, eos_id=1, pad_id=0, precompiled_charsmap=build_charsmap(rules))
    if len(model.pieces) != 32000:
        raise AssertionError(f"spiece.model of {len(model.pieces)} pieces")
    os.makedirs(directory, exist_ok=True)
    write_spiece_model(os.path.join(directory, tt.FILE), model)
    return len(model.pieces)


def tokenized_prompt() -> str:
    from opensora_torch.utils.inference import add_motion_score_to_text

    return add_motion_score_to_text([TOK_PROMPT], TOK_MOTION)[0]


def ids_to_end(ids, eos: int) -> list:
    ids = [int(i) for i in ids]
    return ids[:ids.index(eos) + 1]


@contextlib.contextmanager
def torch_tf32_defaults():
    """PyTorch's own TF32 defaults (cuBLAS off, cuDNN on) in place of this
    script's (both off), for the code that sets its precision itself, as a
    user's process runs it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def check_clip_small_input(device) -> dict:
    """Phase 3g: the evaluation's CLIP ViT-L/14 vision tower (24 layers of
    1024, patch 14, 224 px) and CLIP-L text tower (12 layers of 768) at full
    size, random weights from a seed, fp32 on the card with TF32 off as the
    scorer sets it (``clip_scorer.full_fp32``, under PyTorch's TF32
    defaults) against the CPU on a 2-frame input and a tokenized prompt:
    last hidden state, pooled output and projected features within
    CLIP_CARD_TOL of their scale; the CPU with one vision layer skipped must
    exceed it."""
    from opensora_torch.eval.clip_scorer import full_fp32
    from opensora_torch.models.text.clip import CLIPModel, clip_l_config, clip_vision_l_config
    from opensora_torch.models.text.conditioner import ByteFallbackTokenizer

    torch.manual_seed(0)
    t0 = time.perf_counter()
    cpu = CLIPModel(clip_l_config(), clip_vision_l_config()).eval()
    card = CLIPModel(clip_l_config(), clip_vision_l_config(), device="meta").eval()
    card.load_state_dict({k: v.to(device) for k, v in cpu.state_dict().items()}, assign=True)
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(3)
    px = torch.randn(2, 3, 224, 224, generator=gen)
    ids = torch.from_numpy(ByteFallbackTokenizer(49408, 77, 49407)([tokenized_prompt()]))

    def run(model, dev, skip_layer=False):
        layers = model.vision_model.encoder.layers
        if skip_layer:
            model.vision_model.encoder.layers = layers[:-1]
        try:
            with torch.inference_mode(), torch_tf32_defaults(), full_fp32():
                hidden, pooled = model.vision_model(px.to(dev))
                txt_hidden, txt_pooled = model.text_model(ids.to(dev))
                return dict(vision_hidden=hidden, vision_pooled=pooled, image_features=model.visual_projection(pooled),
                            text_hidden=txt_hidden, text_features=model.text_projection(txt_pooled))
        finally:
            model.vision_model.encoder.layers = layers

    t0 = time.perf_counter()
    ref = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    out = run(card, device)
    torch.cuda.synchronize()
    bad = run(cpu, "cpu", skip_layer=True)

    def rel(a, b):
        return float((a.float().cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))

    res = {k: rel(out[k], ref[k]) for k in ref}
    control = rel(bad["vision_pooled"], ref["vision_pooled"])
    ok = all(v <= CLIP_CARD_TOL for v in res.values()) and control > CLIP_CARD_TOL
    log(f"[clip_small] ViT-L/14 + CLIP-L text towers (fp32, TF32 off by the scorer's pin), 2 frames of 224 px and "
        f"one prompt, card vs CPU "
        f"(built in {build_s:.1f} s, CPU forward {cpu_s:.1f} s): {json.dumps(res)} (tol {CLIP_CARD_TOL} of the "
        f"scale); control, one vision layer skipped on the CPU: {control:.3g} {'OK' if ok else 'FAIL'}")
    del cpu, card, out, ref, bad
    free()
    if not ok:
        raise AssertionError("the card's CLIP towers disagree with the CPU's, or the limit misses a skipped layer")
    return dict(res, control_layer_skipped=control, tol=CLIP_CARD_TOL)


def tokenized_expected_launches(cfg) -> dict:
    """Phase 17a's launches: the D = 128 forward once a block a step, the
    D = 512 forward once a VAE decode tile (the 33 x 24 x 42 latent decodes
    as two spatial tiles)."""
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    return {"flash_attention_fwd_sm90": n_blocks * cfg.sampling_option["num_steps"], "flash_attention_fwd_d512": 2}


def run_tokenized_path(device, text_dirs: dict, root: str) -> dict:
    """Phase 17a: the tokenizer files written beside phase 13's T5-XXL and
    CLIP-L weights, then the generation CLI (``opensora_torch.inference``)
    on 256px.py at full width and depth -- 2 steps, ``--motion-score 4``,
    t5 / clip naming those directories, the dataset's own fps / motion
    suffixes off so that the sample's prompt is the suite prompt and the
    CLI's suffix -- saving the sample as the port's .npy (OpenCV hidden).
    Checks: the embedders hold the files' tokenizers, the ids the encoders
    saw are the ids computed on the CPU (not the byte fallback's), a T5
    probe through the charsmap too, 57 D = 128 launches a step and 2 D = 512
    launches in the decode, the sample and its prompt on disk."""
    import numpy as np

    import opensora_torch.utils.api as api
    import opensora_torch.utils.inference as inference_utils
    from opensora_torch import inference
    from opensora_torch.models.text.clip_tokenizer import CLIPTokenizer
    from opensora_torch.models.text.conditioner import ByteFallbackTokenizer
    from opensora_torch.models.text.t5_tokenizer import T5Tokenizer
    from opensora_torch.ops import _build
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    t0 = time.perf_counter()
    corpus = tokenizer_corpus()
    n_t5 = write_t5_tokenizer_files(text_dirs["t5"], corpus)
    n_clip = write_clip_tokenizer_files(text_dirs["clip"], corpus)
    files_s = time.perf_counter() - t0
    cfg_path = os.path.join(root, "256px_tokenized.py")
    with open(cfg_path, "w") as f:
        f.write(f"_base_ = [{MAIN_CFG!r}]\ndataset = dict(_delete_=True, type='text')\n")
    samples = os.path.join(root, "samples")
    argv = [cfg_path, "--prompt", TOK_PROMPT, "--motion-score", TOK_MOTION, "--sampling_option.num_steps",
            str(STEPS), "--t5.from_pretrained", text_dirs["t5"], "--clip.from_pretrained", text_dirs["clip"],
            "--save_dir", samples, "--device", str(device)]
    log(f"[tok] spiece.model ({n_t5} pieces) and vocab.json / merges.txt ({n_clip} entries) written in "
        f"{files_s:.1f} s; 256px.py at full width and depth through the CLI, num_steps cut 50 -> {STEPS}, "
        f"--motion-score {TOK_MOTION}, t5 / clip from phase 13's directories")
    seen, timings = {}, {}

    def wrap_models(fn):
        def build(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen["build_s"] = time.perf_counter() - t
            seen["t5"], seen["clip"] = out[2], out[3]
            seen["rec_t5"] = FirstCall(out[2].module).__enter__()
            seen["rec_clip"] = FirstCall(out[3].module).__enter__()
            return out
        return build

    def wrap_api(fn):
        def make(*args, **kwargs):
            api_fn = fn(*args, **kwargs)
            return lambda *a, **k: api_fn(*a, timings=timings, **k)
        return make

    def wrap_save(fn):  # OpenCV hidden around the save only: a module first imported under the patch would not stay
        def save(*args, **kwargs):
            with unittest.mock.patch.dict(sys.modules, {"cv2": None}):
                return fn(*args, **kwargs)
        return save

    torch.cuda.reset_peak_memory_stats(device)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        with patched(api, "prepare_models", wrap_models), patched(api, "prepare_api", wrap_api), \
                patched(inference_utils, "process_and_save", wrap_save):
            paths = inference.main(argv)
        torch.cuda.synchronize()
    finally:
        for k in ("rec_t5", "rec_clip"):
            if k in seen:
                seen[k].__exit__(None, None, None)
    total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    t5, clip = seen.pop("t5"), seen.pop("clip")
    text = tokenized_prompt()
    t5_ids = ids_to_end(seen["rec_t5"].args[0][0], 1)
    clip_ids = ids_to_end(seen["rec_clip"].args[0][0], 49407)
    t5_bytes = ids_to_end(ByteFallbackTokenizer(t5.config.vocab_size, 512)([text])[0], 1)
    probe = ids_to_end(t5.tokenizer([TOK_PROBE])[0], 1)

    def per_prompt_ms(tok, n=200):
        t = time.perf_counter()
        for _ in range(n):
            tok([text])
        return (time.perf_counter() - t) / n * 1e3

    t = time.perf_counter()
    T5Tokenizer(text_dirs["t5"])
    t5_load_s = time.perf_counter() - t
    t = time.perf_counter()
    CLIPTokenizer(text_dirs["clip"])
    clip_load_s = time.perf_counter() - t
    res = dict(
        prompt=text, t5_ids=t5_ids, clip_ids=clip_ids, t5_probe_ids=probe,
        t5_ids_equal_cpu=t5_ids == T5_PROMPT_IDS, clip_ids_equal_cpu=clip_ids == CLIP_PROMPT_IDS,
        t5_probe_equal_cpu=probe == T5_PROBE_IDS, t5_ids_are_not_bytes=t5_ids != t5_bytes,
        tokenizers=[type(t5.tokenizer).__name__, type(clip.tokenizer).__name__],
        t5_tokenizer_ms_per_prompt=per_prompt_ms(t5.tokenizer),
        clip_tokenizer_ms_per_prompt=per_prompt_ms(clip.tokenizer),
        t5_tokenizer_load_s=t5_load_s, clip_tokenizer_load_s=clip_load_s, tokenizer_files_s=files_s,
        text_encode_s=timings.get("text_encode_s"), step_s=timings.get("step_s"), decode_s=timings.get("decode_s"),
        models_build_s=seen["build_s"], total_s=total_s, peak_mem_gb=peak_gb, launches=launches)
    del t5, clip, seen
    free()
    cfg = parse_configs([cfg_path, "--sampling_option.num_steps", str(STEPS)])
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option))
    expect = tokenized_expected_launches(cfg)
    res["expected_launches"] = expect
    sample = paths[0] if len(paths) == 1 else None
    frames = np.load(sample) if sample and sample.endswith(".npy") else None
    with open(os.path.join(samples, "sample_0000.txt")) as f:
        res["saved_prompt"] = f.read()
    res["sample_shape"] = list(frames.shape) if frames is not None else None
    want_shape = [opt.num_frames, opt.height, opt.width, 3]
    log("[tok] " + json.dumps({k: v for k, v in res.items() if k not in ("t5_ids", "clip_ids", "t5_probe_ids")}))
    log(f"[tok] T5 ids {t5_ids}; CLIP ids {clip_ids}; probe {probe}")
    if not (res["t5_ids_equal_cpu"] and res["clip_ids_equal_cpu"] and res["t5_probe_equal_cpu"]
            and res["t5_ids_are_not_bytes"] and res["tokenizers"] == ["T5Tokenizer", "CLIPTokenizer"]):
        raise AssertionError("the embedders did not tokenize with the files' tokenizers as computed on the CPU")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")
    if res["sample_shape"] != want_shape or res["saved_prompt"] != text:
        raise AssertionError(f"sample {sample} {res['sample_shape']}, prompt {res['saved_prompt']!r}")
    res["samples"] = samples
    return res


def write_clip_model(directory: str, corpus: str, device, text=None, vision=None) -> dict:
    """A random-weight CLIPModel (seed 0; ViT-L/14 and CLIP-L unless
    ``text`` / ``vision`` configs are given) in HF's layout:
    model.safetensors (with logit_scale), config.json (the head counts, the
    text eos id) and the CLIP tokenizer files."""
    from opensora_torch.models.text.clip import CLIPModel, clip_l_config, clip_vision_l_config
    from opensora_torch.utils.safetensors_io import save_file

    t0 = time.perf_counter()
    torch.manual_seed(0)
    text, vision = text or clip_l_config(), vision or clip_vision_l_config()
    model = CLIPModel(text, vision, device=device)
    with torch.no_grad():  # HF's initializer scale for the embeddings
        for name, p in model.named_parameters():
            if "embedding" in name:
                p.mul_(0.02)
    os.makedirs(directory, exist_ok=True)
    nbytes = save_file({**model.state_dict(), "logit_scale": torch.tensor(2.6592, device=device)},
                       os.path.join(directory, "model.safetensors"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"architectures": ["CLIPModel"], "projection_dim": vision.projection_dim,
                   "text_config": {"num_attention_heads": text.num_heads, "eos_token_id": text.eos_token_id},
                   "vision_config": {"num_attention_heads": vision.num_heads, "patch_size": vision.patch_size}}, f)
    write_clip_tokenizer_files(directory, corpus)
    del model
    free()
    return dict(gb=nbytes / 1e9, write_s=time.perf_counter() - t0)


def write_eval_clips(directory: str, seed: int = 0) -> list:
    """Seeded clips (a textured background and a moving square, uint8 .npy
    as the port saves samples), each with a prompt and a .json sidecar that
    names one detection dimension and its slot; two more whose prompts carry
    a style and a temporal-style phrase."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t, (h, w) = EVAL_CLIP_FRAMES, EVAL_CLIP_SIZE
    names = []
    for i, (dim, text) in enumerate(list((d, f"seeded clip {k}") for k, d in enumerate(EVAL_SLOTS))
                                    + list(EVAL_STYLED.items())):
        bg = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        v = np.repeat(bg, t, axis=0)
        for f in range(t):
            x0 = (8 + (3 + i) * f) % (w - 48)
            v[f, 40:88, x0:x0 + 48] = 230
        name = f"clip_{i:02d}"
        np.save(os.path.join(directory, name + ".npy"), v)
        with open(os.path.join(directory, name + ".txt"), "w") as f:
            f.write(text)
        with open(os.path.join(directory, name + ".json"), "w") as f:
            json.dump({"dimension": dim, **EVAL_SLOTS.get(dim, {})}, f)
        names.append(name)
    return names


def run_eval_path(device, samples: str, root: str) -> dict:
    """Phase 17b: ``python -m opensora_torch.evaluate`` on the card, in this
    process, over phase 17a's sample and seeded clips naming every detection
    dimension: a random ViT-L/14 CLIPModel with the CLIP tokenizer's files
    and a random LAION-layout aesthetic head (768 -> 1024 -> 128 -> 64 -> 16
    -> 1) on disk. Pooled: every dimension the samples name scored and
    finite. ``--suite vbench``: each dimension with samples scored and
    finite, the others None, phase 17a's sample (its prompt ends in the
    --motion-score suffix) matched to its suite (R3). Pooled over a
    directory holding every sample twice: the same report (each mean over
    its values twice) and a peak within EVAL_PEAK_GROWTH of the first run's,
    since the CLI keeps the samples on the host (control: with the samples
    loaded onto the card first the peak grows past it). No kernel launches. The
    runs time the scorer's and head's loading apart from the scoring (from
    the first video to the last), and the phase times the scorer's vision
    tower on 8 frames and the pooled evaluation of phase 17a's video (129
    frames, 192 x 336) alone."""
    from opensora_torch import evaluate
    from opensora_torch.eval import aesthetic, clip_scorer, suites, vbench
    from opensora_torch.eval.aesthetic import AestheticHead
    from opensora_torch.eval.clip_scorer import CLIPScorer
    from opensora_torch.eval.suites import DIMENSIONS
    from opensora_torch.ops import _build
    from opensora_torch.utils.ckpt import clip_model_configs

    corpus = tokenizer_corpus()
    clip_dir = os.path.join(root, "clip-vit-large-patch14")
    written = write_clip_model(clip_dir, corpus, device)
    aes = os.path.join(root, "aesthetic_predictor.pth")
    torch.manual_seed(1)
    proj = clip_model_configs(clip_dir)[1].projection_dim  # 768: LAION's predictor over ViT-L/14
    torch.save(AestheticHead({0: (1024, proj), 2: (128, 1024), 4: (64, 128), 6: (16, 64), 7: (1, 16)}).state_dict(),
               aes)
    names = write_eval_clips(samples)
    n_videos = len(names) + 1
    twice = os.path.join(root, "samples_twice")  # every sample under two names
    os.makedirs(twice, exist_ok=True)
    for f in os.listdir(samples):
        for prefix in ("a_", "b_"):
            shutil.copyfile(os.path.join(samples, f), os.path.join(twice, prefix + f))
    argv = ["--clip", clip_dir, "--aesthetic", aes, "--device", str(device)]
    res = dict(clip_model=written, videos=n_videos)

    def timed(module, name, seconds: dict):
        fn = getattr(module, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

        return unittest.mock.patch.object(module, name, run)

    for mode, directory, n, extra in (("pooled", samples, n_videos, []),
                                      ("suite", samples, n_videos, ["--suite", "vbench"]),
                                      ("pooled_twice", twice, 2 * n_videos, [])):
        free()
        torch.cuda.reset_peak_memory_stats(device)
        _build.LAUNCHES.clear()
        seconds = {}
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch_tf32_defaults())
            for module, name in ((clip_scorer, "try_load_scorer"), (aesthetic, "try_load_head"),
                                 (vbench, "evaluate_videos"), (suites, "evaluate_suite")):
                stack.enter_context(timed(module, name, seconds))
            report = evaluate.main(["--samples", directory] + argv + extra)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        score_s = seconds.get("evaluate_suite" if extra else "evaluate_videos")
        res[mode] = dict(report=report, videos=n, cli_s=total,
                         load_s=seconds["try_load_scorer"] + seconds["try_load_head"], score_s=score_s,
                         score_s_per_video=score_s / n, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                         launches=dict(_build.LAUNCHES))
    pooled, suite, pooled_twice = (res[m]["report"] for m in ("pooled", "suite", "pooled_twice"))
    named = ["clip_score", "subject_consistency", "background_consistency", "aesthetic_quality", "overall_consistency",
             "temporal_consistency", "motion_magnitude", "temporal_flickering", "motion_smoothness", "dynamic_degree",
             "imaging_quality", *EVAL_SLOTS, *EVAL_STYLED]
    bad_pooled = [k for k in named if not (isinstance(pooled.get(k), float) and math.isfinite(pooled[k]))]
    dims = list(DIMENSIONS)
    bad_suite = [k for k in dims if (suite[k]["n"] > 0) != (suite[k]["score"] is not None)
                 or (suite[k]["score"] is not None and not math.isfinite(suite[k]["score"]))]
    want_scored = {*EVAL_SLOTS, *EVAL_STYLED, TOK_SUITE}
    scored = {k for k in dims if suite[k]["score"] is not None}
    r3 = suite[TOK_SUITE]["n"] == 1 and suite["_summary"]["samples_matched"] == n_videos
    twice_diff = {k: abs(pooled_twice[k] - v) for k, v in pooled.items() if k != "num_samples"}
    twice_same = (set(pooled_twice) == set(pooled) and pooled_twice["num_samples"] == 2 * n_videos
                  and max(twice_diff.values()) <= EVAL_TWICE_TOL)
    growth = res["pooled_twice"]["peak_mem_gb"] - res["pooled"]["peak_mem_gb"]
    res.update(twice_max_abs_diff=max(twice_diff.values()), peak_growth_gb=growth)

    # the parts: the vision tower on 8 frames, the pooled evaluation of phase 17a's video alone
    video = evaluate.to_video(evaluate.load_frames(os.path.join(samples, "sample_0000.npy")), device)
    with torch_tf32_defaults():
        scorer = CLIPScorer.from_pretrained(clip_dir, device=device)
        head = AestheticHead.from_pretrained(aes, device)
        scorer.embed_frames(video, 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            scorer.embed_frames(video, 8)
        torch.cuda.synchronize()
        res["vision_tower_8_frames_s"] = (time.perf_counter() - t0) / 5
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        vbench.evaluate_videos([video], [tokenized_prompt()], scorer, head)
        torch.cuda.synchronize()
        res["eval_one_video_s"] = time.perf_counter() - t0
        res["eval_one_video_shape"] = list(video.shape)
        res["eval_one_video_peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        # control: every sample loaded onto the card first, as a list, once and twice; the peak must grow
        peaks = []
        for directory in (samples, twice):
            files = sorted(f for f in os.listdir(directory) if f.endswith(".npy"))
            resident = [evaluate.to_video(evaluate.load_frames(os.path.join(directory, f)), device) for f in files]
            torch.cuda.reset_peak_memory_stats(device)
            vbench.evaluate_videos(resident, [""] * len(files), scorer, head)
            peaks.append(torch.cuda.max_memory_allocated(device) / 1e9)
            del resident
        res["control_resident_peak_growth_gb"] = peaks[1] - peaks[0]
    res.update(bad_pooled=bad_pooled, bad_suite=bad_suite, scored=sorted(scored), r3_matched=r3)
    del scorer, head, video
    free()
    shutil.rmtree(twice, ignore_errors=True)
    log("[eval] " + json.dumps({k: ({m: v for m, v in r.items() if m != "report"} if isinstance(r, dict)
                                    and "report" in r else r) for k, r in res.items()}))
    log("[eval] pooled " + json.dumps(pooled))
    log("[eval] suite " + json.dumps({k: v for k, v in suite.items()}))
    if bad_pooled or bad_suite or scored != want_scored or not r3:
        raise AssertionError(f"evaluation: unscored or non-finite {bad_pooled} / {bad_suite}, scored {sorted(scored)} "
                             f"(expected {sorted(want_scored)}), R3 match {r3}")
    limit_gb = EVAL_PEAK_GROWTH / 1e9
    if not twice_same or growth > limit_gb or res["control_resident_peak_growth_gb"] <= limit_gb:
        raise AssertionError(f"evaluation over every sample twice: report equal {twice_same} (max abs diff "
                             f"{max(twice_diff.values())}), peak memory grew {growth:.4f} GB (limit "
                             f"{EVAL_PEAK_GROWTH / 1e9} GB; control, samples resident on the card: "
                             f"{res['control_resident_peak_growth_gb']:.4f} GB, must exceed it)")
    if any(res[m]["launches"] for m in ("pooled", "suite", "pooled_twice")):
        raise AssertionError("the evaluation launched a kernel")
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
    small_t2i = check_t2i_small_input(device)
    records: dict = {}  # first calls of phases 4, 6 and 11, replayed by phase 13
    main_res, built = run_main_path(device, "--profile" in argv, out_dir, records)
    main_res["small_input"] = small
    ring_res = run_ring_path(device, built, "--profile" in argv, out_dir)
    ring_res["small_input"] = small_ring
    with tempfile.TemporaryDirectory() as tmp:
        t2i2v_res = run_t2i2v_path(device, built, tmp, "--profile" in argv, out_dir, records)
        t2i2v_res["small_input"] = small_t2i
        v2v_res = run_v2v_path(device, built, tmp)
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
    int8_res = run_int8_path(device, [], STEPS, "--profile" in argv, out_dir, "int8", records)
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
    text_root = tempfile.mkdtemp(prefix="chip_smoke_text_")  # phase 13's T5-XXL and CLIP-L, phase 17's files
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_res = run_ckpt_path(device, records, tmp, text_root)
            cli_res = run_vae_cli_path(device, ckpt_res.pop("vae_file"), tmp)
        del records
        small_hc_train = check_hc_train_small_input(device)
        with tempfile.TemporaryDirectory() as tmp:
            hc_res = run_hc_inference_path(device, tmp, "--profile" in argv, out_dir)
        hc_train_res = run_hc_train_path(device, "--profile" in argv, out_dir)
        hc_train_res["small_input"] = small_hc_train
        small_clip = check_clip_small_input(device)
        tok_res = run_tokenized_path(device, ckpt_res.pop("text_dirs"), text_root)
        eval_res = run_eval_path(device, tok_res.pop("samples"), text_root)
        eval_res["small_input"] = small_clip
    finally:
        shutil.rmtree(text_root, ignore_errors=True)
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
        launches_t2i2v=dict(image=t2i2v_res["image_launches"]["flash_attention_fwd_sm90"],
                            image_and_i2v_video=t2i2v_res["launches"]["flash_attention_fwd_sm90"],
                            v2v=v2v_res["launches"]["flash_attention_fwd_sm90"]),
        launches_ckpt={k: ckpt_res["steps"][k]["launches"].get("flash_attention_fwd_sm90", 0)
                       for k in ("256px", "image")},
        launches_hc=dict(t2v=hc_res["t2v"]["launches"]["flash_attention_fwd_sm90"],
                         i2v_head=hc_res["i2v_head"]["launches"]["flash_attention_fwd_sm90"],
                         train=hc_train_res["launches"]["flash_attention_fwd_sm90"],
                         rf_eval_loss=hc_train_res["eval_launches"]["flash_attention_fwd_sm90"]),
        launches_tokenized_t2v=tok_res["launches"]["flash_attention_fwd_sm90"],
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
        launches_t2i2v=dict(i2v_encode_and_decode=t2i2v_res["launches"]["flash_attention_fwd_d512"],
                            v2v_encode_and_decode=v2v_res["launches"]["flash_attention_fwd_d512"]),
        launches_vae_cli={k: cli_res["hunyuan_vae"][k].get("flash_attention_fwd_d512", 0)
                          for k in ("launches_inference", "launches_stats")},
        launches_tokenized_t2v=tok_res["launches"]["flash_attention_fwd_d512"],
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
        launches_hc_train=hc_train_res["launches"]["flash_attention_bwd_fused"],
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
        launches_hc_train=hc_train_res["launches"]["flash_attention_bwd_dq_convert"],
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
            launches_ckpt_int8_step=ckpt_res["steps"]["256px_int8attn"]["launches"].get(name, 0),
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
            launches_ckpt_int8_step=ckpt_res["steps"]["256px_int8attn"]["launches"].get(name, 0),
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
        entry["launches_eval_cli"] = sum(eval_res[m]["launches"].get(entry["name"], 0)
                                          for m in ("pooled", "suite", "pooled_twice"))
    log("[main] " + json.dumps(main_res))
    log("[ring] " + json.dumps(ring_res))
    log("[t2i2v] " + json.dumps(t2i2v_res))
    log("[v2v] " + json.dumps(v2v_res))
    log("[ring_train] " + json.dumps(ring_train_res))
    log("[train] " + json.dumps(train_res))
    log("[int8] " + json.dumps(int8_res))
    log("[int8_fq] " + json.dumps(fq_res))
    log("[vae] " + json.dumps(vae_res))
    log("[dcae] " + json.dumps(dcae_res))
    log("[ckpt] " + json.dumps(ckpt_res))
    log("[vae_cli] " + json.dumps(cli_res))
    log("[hc] " + json.dumps(hc_res))
    log("[hc_train] " + json.dumps(hc_train_res))
    log("[tok] " + json.dumps(tok_res))
    log("[eval] " + json.dumps({k: v for k, v in eval_res.items() if k not in ("pooled", "suite", "pooled_twice")}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
