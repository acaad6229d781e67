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
     Trainer.run_batch) for 2 steps, and check losses, gradient norms,
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
(the forward's 16 hop launches, the call and SDPA in turns). The ring
phases run the sequence-sharded MMDiT: each of the 4 sp ranks holds its
chunk of the joint [txt, img] tokens through every block (at 256px, B = 3:
2207 tokens and 40.7 MB of residual stream a rank against 8828 and 162.7
MB whole) and only the attention spans the ranks; each prints its ranks'
token counts and residual bytes. Phase 3d runs the full-width MMDiT with
attn_backend="ring_rdma" sharded over those 4 ranks on a small input
(forward, and a LoRA step's gradients) against the CPU's plain dense path.
Phase 9 (run right after phase 4, on its models) switches every block to
ring_rdma over a mesh of 4 logical ranks on the card and drives 256px.py
through prepare_api(mesh=...), which places the MMDiT over the ranks
(unsharded again after the phase), for 2 steps: exact launches, the video
against phase 4's (a control with the last hop skipped must exceed the
limit), then 1 step of attn_backend="ring" (ops/sp.py) against 1 step of
ring_rdma. Phase 10 (after phase 5, on its trainer, whose state it places
over the same mesh) runs 1 LoRA step with ring_rdma: finite loss and
gradient norm, moving factors, exact launches of the ring kernels and the
dQ epilogue.
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
(256px_int8attn.py's fused model from the unfused file, quantized at
load, the image model with ckpt_rope_convention="interleaved"): every
loaded tensor equal to its checksum (the quantized ones to quantize_model_
of the float weights), each phase's first call replayed bitwise on the
loaded model with exact launches (304 + 57, 57), every load's seconds,
GB/s and host RSS printed; one file on disk at a time. Phase 14 runs
python -m opensora_torch.vae_inference and vae_stats on
configs/vae/inference/hunyuan_vae.py (phase 13's VAE file) and
video_dc_ae.py (phase 8's DC-AE drawn again and written) over 4 seeded
33 x 256 x 256 mp4 clips: the latent statistics equal a direct encode's
with the same generator, PSNR finite, D = 512 launches exactly the
tiles' mid-blocks (none for the DC-AE), seconds per clip printed.
The high-compression paths (Video DC-AE latents, patch 1, sized at the
configs' 32 px a token), last: phase 2 holds the D = 128 forward at their
shapes, (3, 24, 2432, 128) for t2v and i2v_head at 192 x 320 and (3, 24,
2528, 128) for the training clip at 224 x 288, and phase 2b the backward at
the training clip's (3, 24, 2528, 128); phase 3f checks one full-finetune
step (fp32 masters, bf16 compute) of the training config's full-width MMDiT
at depth 1 + 1 against the CPU's fp32 step, and, on phase 15's models, the
full-width, full-depth MMDiT on a small latent (the CPU's plain path
streamed block by block; a control with one block skipped must fail) and
the DC-AE decoder; phase 15 runs configs/diffusion/inference/
high_compression.py at full width and depth, t2v for 2 steps at 192 x 320,
129 frames (32 x 6 x 10 latent tokens, decoded 128 x 192 x 320), then
i2v_head for 1 step from a seeded 192 x 320 image: shapes, finite videos,
the first latent frame equal to the encoded reference, 57 launches a step;
phase 16 runs configs/diffusion/train/high_compression.py as a full
finetune at full width and 2 + 4 blocks for 3 steps on a seeded 128 x 224 x
288 clip (a 32-px bucket of 256px), B = 3 (losses, moving parameters, exact launches,
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
768px generation: phase 2 holds the D = 512 forward at the 768px decode's
tiles (latent 33 x 32 x 32, 32 x 8, 24 x 8 besides 24 x 32) and the one-
frame tiles of the reference encode at 576 x 1024; phase 18 (after phase 9,
on phase 4's models, no image model resident) runs configs/diffusion/
inference/768px.py at full width and depth through parse_configs, the
CLI's mesh rule (sp_size=-1 on one card: no mesh) and api_fn for 1 step:
a finite 33 x 72 x 128 latent, 76032 image tokens, 57 D = 128 launches a
step, the peak under 80 GB (its decode left out: phase 32 decodes the same
latent shape with the same VAE); then holds the D = 128 forward at the path's
(3, 24, 76544, 128) against the plain version on three (b, h) pairs with
all keys, in query chunks (one pair on the running-max loop, two on the
anchored), with phase 2's known-wrong outputs, and times the kernel and
SDPA in turns; phase 19 (after phase 11, on its image models) runs
configs/diffusion/inference/t2i2v_768px.py through the CLI's t2i2v code
(inference.ImageStage: the image, then the image models parked in host
memory): the 768 x 768 image, the i2v_head video of (1, 3, 129, 576,
1024) for 1 step on the first 2 + 4 blocks of the MMDiT (T2I2V_768_DEPTH:
phase 18 runs the full depth at that shape), the first latent frame equal
to the encoded reference,
the exact launches (the reference encode's 18 D = 512 tiles among them),
the peak under 80 GB, the host memory and the seconds of parking and
loading; then, as the control, the same video with every model resident
(its peak, or the card's out-of-memory error).
Tensor and data parallelism over logical ranks on the card: phase 2 holds
the D = 128 forward at a TP 4 rank's heads (3, 6, 8828, 128) and phase 2b
the backward at phase 21's per-rank shapes (1, 24, 8828, 128) and (2, 12,
8828, 128); phase 3h runs the full-width MMDiT at 1 + 1 blocks under TP
(1, 1, 4) and (1, 2, 2) with ring_rdma (the tokens in chunks of 40 over
the sp ranks) against the CPU's plain path and
the card's unsharded forward, and one full-finetune step over (2, 1, 2)
with FSDP against the unsharded step, each with known-wrong variants that
must fail (fused axes cut contiguously, the row bias on every rank, one
data rank's rows twice, gradients not divided by dp); phase 20 (after
phase 12, on phase 4's models, sharded in place) runs configs/diffusion/
inference/256px_tp.py at full width and depth over 4 logical ranks, 2
steps, the latent against phase 4's, exact launches, the peak, and with
--profile the all-reduce's share; phase 21 (after phase 10) runs
configs/diffusion/train/stage1.py's full finetune at 2 + 4 blocks through
Trainer.run_batch: one step from one saved state by the trainer without
a mesh, then by Trainer(mesh=...) over (2, 1, 2) and over (4, 1, 1) with
FSDP (the state loaded and resharded), the sharded against the
unsharded, then 1 timed FSDP step.
Pipeline and VAE context parallelism over logical ranks on the card:
phase 22 (after phase 21) runs stage1.py's full finetune at 2 + 4 blocks
through Trainer(cfg, device, mesh=create_pp_mesh(...)) with a pipeline
key, GPipe over (pp 2, data 2) with 2 microbatches and (pp 2, tp 2) with
4, one step each from phase 21's saved state, batch and generator state
against phase 21's unsharded step, exact launches, the stage-to-stage
copies' device time, the peak, and two known-wrong pipelines that must
fail (the last stage fed the neighbouring microbatch, its blocks
skipped); phase 23 encodes and decodes one 33-frame 256 x 256 clip with
the full-width HunyuanVAE, its height over 2 and over 4 logical ranks,
against the unsharded VAE, exact D = 512 launches, times, the peak, and
two known-wrong variants that must fail (interior strip edges
replicate-padded, per-strip group-norm statistics). Phase 2 holds the
D = 128 forward, and phase 2b the backward, at phase 22's PP x TP
microbatch (1, 12, 8828, 128) and phase 24's per-process rank (2, 24,
8828, 128).
Training across processes (multi_host) on the card: phase 24 (after
phases 22 and 27) starts two processes of this script with torchrun's variables
(``--multi-process-worker DIR``); each joins the group as the training CLI
does (both on cuda:0, so gloo, the CUDA tensors staged through host
memory), builds Trainer(cfg, device, mesh=train_mesh(...)) over (data 2,
1, 1) for phase 21's configuration, loads phase 21's saved state from a
file and takes one step on its 2 rows of phase 21's batch from phase 21's
generator states, held to phase 21's limits against the unsharded step
(loss, norm, the masters' change summed over both processes' shards),
exact launches per process, the peaks, the staged copies' device time;
process 0 dropping the cross-process sum of the replicated gradients must
fail the limits. On a host of two cards or more the same runs again, one
process a card, over nccl (else it prints "nccl: not run"). Phase 28
runs in the same two processes after phase 24's step: stage2.py's sp group
across them (Trainer(cfg, device, mesh=train_mesh(...)) over (1, 4, 1),
sp ranks 0-1 in process 0 and 2-3 in process 1, logical ranks on the card;
T5, CLIP and the VAE dropped: the step is taken on phase 21's encoded step
inputs), one step with the default attention (gathered across the
processes) and one with ring_rdma (the ring's KV and dK/dV accumulators
sent between them), from phase 21's saved state and generator state: held
to phase 21's limits (each process's masters), exact launches per process,
the ring's cross-process sends exact by arithmetic, the distance to phase
27's (1, 4, 1) step, the staged bytes, the gloo and ring-wait seconds and
each process's peak; a ring forward reusing the receiving rank's own KV on
the cross-process hop, and process 1 dropping the cross-process sum of the
weight gradients, must fail the limits. Phase 29 runs in the same two
processes after phase 28:
stage1.py at phase 21's cell on its encoded step inputs, over (1, 1, 2)
with one tp rank a process (the row-parallel sums across the processes)
and over the pipeline key's (pp 2, data 1), one stage a process (the
boundaries' activations and gradients sent between them), one step each
from phase 21's state held to phase 21's limits, exact launches, tp
all-reduces and pipeline sends per process with their bytes, each
process's step, gloo seconds, staged bytes and peak; the tp sum's backward
left local, and the boundary's gradient not sent back, must fail the
limits. Then
``python -m torch.distributed.run --nproc-per-node 2 -m
opensora_torch.train`` trains stage1.py at full width and 1 + 0 blocks
for 1 step of one seeded 33 x 256 x 256 clip a process: both exit 0, one
log.txt writer, disjoint samples, and the checkpoint loads into a
single-process Trainer equal to its file; and again with --mesh.tp_size 2
(phase 29(c): one clip both processes read, the mesh across them).
LoRA over a sharded mesh and int8 under TP on the card: phase 25 (after
phase 24) trains lora.py (r = 128) on phase 21's cell (stage1.py at full
width and 2 + 4 blocks, 4 seeded 129 x 192 x 336 clips, lr and eps 1e-2)
through Trainer(cfg, device, mesh=...) over (2, 1, 2) and (4, 1, 1): the
frozen base FSDP / TP-cut, the factors replicated; one step each from the
unsharded LoRA trainer's state after one step, against the unsharded step
(taken twice: the run-to-run spread) within phase 21's loss and norm
limits and LORA_UPDATE_TOL for each factor's change, exact launches, the
peak; over (2, 1, 2) lora_B cut contiguously (not per segment) must fail,
and the sharded trainer's checkpoint loads into the unsharded trainer
bitwise. Phase 26 (right after phase 6, on its models) shards the
quantized MMDiT of 256px_int8attn.py composed with plugins/tp.py over 4
logical ranks through prepare_api(mesh=...) (int8 weights and fp32 scales
cut per rank in their dtypes, each row-parallel product quantized against
the whole row's scale) and runs phase 6's steps: the latent within
INT8_TP_LATENT_TOL of phase 6's (and phase 6 run again within it too),
exact launches of w8a8_matmul and int8 attention at the tp ranks' shapes
(phase 2c holds both kernels at those shapes), the steps' seconds beside
phase 6's, the peak.
Sequence-sharded training: phase 27 (after phase 22) trains stage2.py
(sp 4, remat "offload", the default attention: gathered on sp rank 0 for
one flash call a block, the output cut back) on phase 21's cell through
Trainer(cfg, device, mesh=...) over stage2's own mesh (1, 4, 1) and over
(2, 2, 1) with FSDP, one timed step each from phase 21's saved state,
batch and generator states, held to phase 21's limits against its
unsharded step, exact launches, each rank's tokens and residual bytes,
the peak; the last sp rank's image chunk left out of the gathered output
must fail the limits. Phase 2 holds the D = 128 forward at the gathered sp
group's (4, 24, 8828, 128) and the "ring" backend's hop (3, 24, 2207,
128), phase 2b the backward at (4, 24, 8828, 128); both hold phase 29's
tp rank (4, 12, 8828, 128) (its pipeline microbatch is phase 24's (2, 24,
8828, 128)).
The finetune loop through the dataset and checkpoint tools: phase 31
(right after phase 14, with phase 13's HunyuanVAE file and T5-XXL / CLIP-L
directories as from_pretrained) writes 4 seeded 256 x 256 mp4s and 2 pngs,
builds the table with ``python -m opensora_torch.cnv.meta`` (each row's
size, frames and fps as written), trains stage1.py at full width and 1 + 1
blocks on it through the training CLI for 2 steps with a checkpoint,
exports the EMA with ``cnv.export --layout published`` (every tensor, loaded
back, the EMA bitwise), samples 129 x 192 x 336 for 2 steps with the
inference CLI on 256px.py from the export (its latent the in-memory EMA's,
bitwise), caches latents and embeddings with ``cnv.cache`` (the trainer's
video path and encoders on the same clips, bitwise; one cached_video step)
and runs ``cnv.verify_pretrained`` on the export and on the VAE file;
exact launches of each part.
One-card 768px serving: phase 32 (right after phase 6, on its int8 models;
w8a8 and the configs' w8a8_pallas compute the same function) runs
configs/diffusion/inference/768px_1chip_int8attn.py (int8 products, int8
qk8 attention, cfg_batched=False: three B = 1 passes a step) through
parse_configs, the CLI's mesh rule, sanitize_sampling_option and api_fn
for 1 step and the decode: a finite (1, 3, 129, 576, 1024) video, 912
w8a8_matmul, 171 int8 attention launches (each (b, h)'s loop from its a2)
and 18 D = 512 launches (the 3 x 6 decode tiles), the peak; then
768px_1chip.py (the same weights, the bf16 flash attention) for 1 step
(its decode the same call, left out): 912 + 171 D = 128 launches; the
sequential CFG's velocity against the batched pass's on a small input at
2 + 4 blocks (a control with the prompts swapped must fail the limit);
then holds w8a8_matmul at the B = 1 pass's shapes (76032 / 512 / 76544 /
1 rows; linear1's bf16 output is 3.29 GB) on row bands -- the first, the
last, and the band past 2^31 output bytes, every element exact, its rows
left unwritten, one consumer's rows from the other's and a K slice dropped
rejected --, int8 qk8 attention and the D = 128 forward at (1, 24, 76544,
128) on two (b, h) over every query row in chunks, with known-wrong
outputs, each timed in turns with its library call.
Single-frame and i2v training: phase 33 (after phase 27) trains
configs/diffusion/train/image.py at phase 21's depth from its saved state
through the training CLI's loader (seeded pngs of 1024 x 1024, 768 x 768
and 256 x 256, the rows landing in the 1024px, 768px and 256px buckets by
the sampler's own draws) and Trainer.run_batch: one step per resolution at
the config's batch sizes (7, 11, 50), finite losses, every weight matrix
moved but cond_in's (masters_moved), exact launches (one D = 512 encode a
frame); phase
34 takes one stage1_i2v.py step on phase 21's batch with the host's draws
seeded to include i2v_loop and i2v_tail: finite loss, every weight matrix moved,
exact launches (the single frames' encodes counted).
Each phase's wall time is printed as "[time] <phase>: <s> s", and the sum
as "[time] total: <s> s" before the card's line.
Then it prints the card's name and power limit, one JSON line with the
kernels' numbers, and last {"ok": true, "device": {...}}.

``--out-dir DIR`` writes the compiler's register/shared-memory report
(build_log.txt) there; ``--profile`` adds a profiled second run of each
path (kernel time by kind, device idle share; with ``--out-dir`` the full
tables go to DIR/profile_{main,ring,768px,t2i2v,tp,train,ring_train,fsdp,int8,vae,dcae,hc,hc_train}.txt).
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
TRAIN_STEPS = 2  # LoRA steps of the training path (B = 0 after the first, warmup from lr 0; moves in the second)
TRAIN_BATCH = 3  # the 129-frame 256px bucket's batch size (stage1.py)
TRAIN_FRAMES, TRAIN_RESOLUTION, TRAIN_RATIO = 129, "256px", "16:9"
# api_fn does not clamp (saving clips). With random weights a little of the
# decoded video lies outside [-1, 1] (0.43 % in the runs that measured it);
# a path that blows up puts most of it there.
OUTSIDE_MAX = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_SECONDS: dict = {}  # wall seconds of each phase of main, by label


def timed(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time logged as ``[time] label: s``
    (also when it raises) and kept in PHASE_SECONDS."""
    start = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_SECONDS[label] = time.perf_counter() - start
        log(f"[time] {label}: {PHASE_SECONDS[label]:.1f} s")


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
    ("mmdit_tp4_rank", (3, 6, 8828, 128), None, 1.0),  # phase 20: 256px_tp.py, one of 4 tp ranks' heads
    ("pp2_tp2_microbatch", (1, 12, 8828, 128), None, 1.0),  # phase 22 over (pp 2, tp 2): a 1-row microbatch's heads
    ("multi_process_rank", (2, 24, 8828, 128), None, 1.0),  # phase 24: one process's data rank, 2 rows
    # (and phase 29(b)'s microbatch: one stage a process, 2 rows)
    ("tp_process_rank", (4, 12, 8828, 128), None, 1.0),  # phase 29(a): one tp rank a process, B = 4
    # phase 27 over (1, 4, 1): the default attention on the sp group's gathered q, k, v (its (2, 2, 1) data
    # rank is the 2-row case above); phase 9's "ring" backend: one hop, a rank's queries on one KV shard
    ("sp4_gathered_data_rank", (4, 24, 8828, 128), None, 1.0),
    ("ring_sp4_hop", (3, 24, 2207, 128), None, 1.0),
    ("flux_image_768px", (1, 24, 2816, 128), None, 1.0),  # the t2i2v image stage: 2304 image + 512 text tokens
    # the high-compression paths (patch 1 over DC-AE latents, 512 text tokens):
    # t2v and i2v_head at 256px 16:9 snapped to 32 px, 192 x 320 (32 x 6 x 10
    # latent tokens), and the training clip at the 32-px bucket 224 x 288 (32 x 7 x 9)
    ("hc_192x320", (3, 24, 2432, 128), None, 1.0),
    ("hc_train_224x288", (3, 24, 2528, 128), None, 1.0),
    # image.py's single-frame buckets on phase 21's cell (phase 33): 256px 1:1
    # at B = 50, 768px at B = 11, 1024px at B = 7 (image + 512 text tokens)
    ("image_256px_b50", (50, 24, 256 + 512, 128), None, 1.0),
    ("image_768px_b11", (11, 24, 2304 + 512, 128), None, 1.0),
    ("image_1024px_b7", (7, 24, 4096 + 512, 128), None, 1.0),
    ("vae_mid_tile_24x32", (1, 1, 33 * 768, 512), 768, 1.0),
    ("vae_mid_tile_24x18", (1, 1, 33 * 432, 512), 432, 1.0),
    # the reference encodes: one frame (i2v, t2i2v; causal_block = L) and
    # v2v's 65 frames (17 latent frames), in the encoder's two tile widths
    ("vae_mid_encode_1frame_24x32", (1, 1, 768, 512), 768, 1.0),
    ("vae_mid_encode_1frame_24x18", (1, 1, 432, 512), 432, 1.0),
    ("vae_mid_v2v_17f_24x32", (1, 1, 17 * 768, 512), 768, 1.0),
    ("vae_mid_v2v_17f_24x18", (1, 1, 17 * 432, 512), 432, 1.0),
    ("vae_train_mid_33x256x256", (1, 1, 9216, 512), 1024, 1.0),  # phase 7's mid-blocks (latent 9 x 32 x 32)
    # the 768px decode's tiles (latent 33 x 72 x 128, tile 32, stride 24): 32 x 32, (24 x 32 above), 32 x 8,
    # 24 x 8; the reference encode's at 576 x 1024 (one frame, tile 256 px, stride 192): 32 x 32, (24 x 32
    # above), 32 x 8, 24 x 8
    ("vae_mid_tile_768px", (1, 1, 33 * 1024, 512), 1024, 1.0),
    ("vae_mid_tile_768px_32x8", (1, 1, 33 * 256, 512), 256, 1.0),
    ("vae_mid_tile_768px_24x8", (1, 1, 33 * 192, 512), 192, 1.0),
    ("vae_mid_encode_1frame_32x32", (1, 1, 1024, 512), 1024, 1.0),
    ("vae_mid_encode_1frame_32x8", (1, 1, 256, 512), 256, 1.0),
    ("vae_mid_encode_1frame_24x8", (1, 1, 192, 512), 192, 1.0),
    # phase 33's untiled single-frame encodes (stage1.py's AE tiles nothing):
    # a 768 x 768 frame (96 x 96 latent) and a 1024 x 1024 frame (128 x 128)
    ("vae_mid_encode_1frame_768px", (1, 1, 96 * 96, 512), 96 * 96, 1.0),
    ("vae_mid_encode_1frame_1024px", (1, 1, 128 * 128, 512), 128 * 128, 1.0),
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
    ("hc_train_128x224x288", (3, 24, 2528, 128), None),  # phase 16: 32 x 7 x 9 latent + 512 text tokens
    ("image_256px_b50", (50, 24, 256 + 512, 128), None),  # phase 33: image.py's three single-frame buckets
    ("image_768px_b11", (11, 24, 2304 + 512, 128), None),
    ("image_1024px_b7", (7, 24, 4096 + 512, 128), None),
    ("fsdp4_data_rank", (1, 24, 8828, 128), None),  # phase 21 over (4, 1, 1): one data rank's row
    ("dp2_tp2_rank", (2, 12, 8828, 128), None),  # phase 21 over (2, 1, 2): a rank's rows and heads
    ("pp2_tp2_microbatch", (1, 12, 8828, 128), None),  # phase 22 over (pp 2, tp 2): a 1-row microbatch's heads
    ("multi_process_rank", (2, 24, 8828, 128), None),  # phase 24's data rank; phase 29(b)'s microbatch
    ("tp_process_rank", (4, 12, 8828, 128), None),  # phase 29(a): one tp rank a process, B = 4
    ("sp4_gathered_data_rank", (4, 24, 8828, 128), None),  # phase 27 over (1, 4, 1): the gathered sp group
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
    # a TP 4 rank's (phase 26): linear1's columns, linear2's input rows
    ("tp4_rank_linear1", 3 * 8828, 3072, 21504 // 4),
    ("tp4_rank_linear2", 3 * 8828, 15360 // 4, 3072),
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
    # a TP 4 rank's heads (phase 26)
    ("tp4_rank_anchored", (3, 6, 8828, 128), 1.0),
    ("tp4_rank_running_max", (3, 6, 8828, 128), 3.0),
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
    ("stage2_sp4_b4", (4, 24, 8828, 128), None),  # phase 28's ring_rdma step: B = 4
]
RING_KERNELS = ("ring_flash_fwd", "ring_flash_bwd_fused")


def ring_mesh(device):
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(dp_size=1, sp_size=RING_SP, tp_size=1), [device] * RING_SP)


class RankTokens:
    """While active, records on the first call of a model's first double
    and first single block each rank's tokens of the residual stream (a
    double block's text + image parts, a single block's chunk) and their
    bytes: what each rank holds a block (``summary()``)."""

    def __init__(self, model):
        self.model, self.seen = model, {}

    def __enter__(self):
        for kind, block, n in (("double", self.model.double_blocks[0], 2), ("single", self.model.single_blocks[0], 1)):
            def recorded(g, *args, fwd=block.forward_tp, kind=kind, n=n):
                if kind not in self.seen:
                    self.seen[kind] = [(sum(x[r].shape[1] for x in args[:n]),
                                        sum(x[r].numel() * x[r].element_size() for x in args[:n]))
                                       for r in range(len(args[0]))]
                return fwd(g, *args)

            block.forward_tp = recorded
        return self

    def __exit__(self, *exc):
        for block in (self.model.double_blocks[0], self.model.single_blocks[0]):
            del block.forward_tp

    def summary(self) -> dict:
        return {kind: dict(tokens=[t for t, _ in v], residual_bytes=[b for _, b in v]) for kind, v in self.seen.items()}

    def check(self, tag: str, ranks: int, total: int) -> dict:
        """The summary, after checking that both blocks ran over ``ranks``
        ranks of ``total`` / ``ranks`` tokens each."""
        out = self.summary()
        for kind, v in out.items():
            if v["tokens"] != [total // ranks] * ranks:
                raise AssertionError(f"{tag}: the {kind} block's ranks hold {v['tokens']} tokens, not {total} in "
                                     f"{ranks} chunks")
        if set(out) != {"double", "single"}:
            raise AssertionError(f"{tag}: blocks recorded {sorted(out)}")
        log(f"[{tag}] per rank and block: tokens {out['single']['tokens']}, residual stream "
            f"{[round(b / 1e6, 1) for b in out['single']['residual_bytes']]} MB")
        return out


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
    if mesh is not None:  # the tokens in chunks over the sp ranks
        from opensora_torch.parallel.sharding import shard_params

        shard_params(mesh, card, fsdp=False)
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
        with torch.inference_mode(), RankTokens(card) as tokens:
            ref = cpu(**inputs)
            out = card(**{k: v.to(device) for k, v in inputs.items()})
    finally:
        set_mesh(None)
    launches = dict(_build.LAUNCHES)
    res["mmdit_1+1_rel_err"] = rel_err(out, ref)
    del card, cpu
    if mesh is not None:
        ranks = tokens.check("small", RING_SP, 48 + lt)
        torch.cuda.empty_cache()
        expect = {"ring_flash_fwd": 2 * RING_SP * RING_SP}
        ok = res["mmdit_1+1_rel_err"] <= SMALL_TOL and launches == expect
        log(f"[small] ring_rdma over {RING_SP} logical ranks: full-width MMDiT depth 1+1 (B=3, 80 tokens), card "
            f"bf16 + ring kernels vs CPU fp32 plain dense attention: {res} (tol {SMALL_TOL} of the output's "
            f"scale) launches {launches} (expected {expect}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's ring path disagrees with the plain path on a small input")
        return dict(res, launches=launches, ranks=ranks)

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


def profile_run(fn, tag: str, out_dir, spans=()) -> dict:
    """Device time by kernel kind and the device's idle share over one more
    run of ``fn`` under torch.profiler; the full table goes to
    ``out_dir``/profile_``tag``.txt if given. For each name in ``spans``
    (a ``record_function`` range), ``<name>_device_s``: the device time of
    the kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups = {name: 0.0 for name, _ in KERNEL_KINDS}
    groups["other"] = 0.0
    span_s = {f"{n}_device_s": 0.0 for n in spans}
    for e in prof.key_averages():
        if e.key in spans:  # the range itself, on either side: not a kernel
            if e.device_type != torch.autograd.DeviceType.CUDA:
                us = getattr(e, "device_time_total", None)
                span_s[f"{e.key}_device_s"] += (e.cuda_time_total if us is None else us) / 1e6
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = e.key.lower()
        kind = next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")
        groups[kind] += us
    busy_s = sum(groups.values()) / 1e6
    out = {"wall_s": wall_s, "kernel_s": {k: v / 1e6 for k, v in groups.items()},
           "device_idle_share": max(0.0, 1.0 - busy_s / wall_s), **span_s}
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
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
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
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    prompt = ["a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score."]

    run_kwargs = dict(opt=opt, cond_type=cfg.cond_type, seed=cfg.seed, text=prompt,
                      channel=cfg.model["in_channels"])
    _build.LAUNCHES.clear()
    timings: dict = {}
    with FirstCall(model) as rec_model, FirstCall(t5) as rec_t5, FirstCall(clip) as rec_clip, \
            LatentRecorder(ae) as rec_latent:
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
    return res, dict(cfg=cfg, models=(model, ae, t5, clip), video=x.cpu(), run_kwargs=run_kwargs,
                     latent=rec_latent.latents[0], step_s=timings["step_s"])


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
    """256px.py at full width and depth with the MMDiT's tokens in chunks
    over RING_SP logical ranks on the card (phase 4's models, their blocks
    switched to ``attn_backend="ring_rdma"``), through prepare_api(mesh=...)
    (which places the MMDiT over the ranks; it is unsharded again at the
    end, for the phases after) and api_fn: shape, finiteness, exact
    launches, each rank's tokens, and the video against phase 4's; then one
    step with ``attn_backend="ring"``."""
    from opensora_torch.ops import _build
    from opensora_torch.ops import ring_flash as rf
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.sharding import unshard_params
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.config import ae_spatial_compression
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg, (model, ae, t5, clip), dense = built["cfg"], built["models"], built["video"]
    mesh = ring_mesh(device)
    log(f"[ring] 256px.py at full width and depth, attn_backend=ring_rdma over {mesh}; num_steps cut 50 -> {STEPS}")
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    hops = RING_SP * RING_SP

    def run(backend, steps):
        set_attn_backend(model, backend)
        api_fn = prepare_api(model, ae, t5, clip, mesh=mesh)
        opt = sanitize_sampling_option(SamplingOption(**dict(cfg.sampling_option, num_steps=steps)),
                                       ae_spatial_compression(cfg))
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
        with RankTokens(model) as tokens:
            x, launches, timings = run("ring_rdma", STEPS)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        ranks = tokens.check("ring", RING_SP, sum(tokens.summary()["single"]["tokens"]))
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
        unshard_params(model)
    res = dict(mesh=repr(mesh), ranks=ranks, launches=launches, expected=expect, text_encode_s=timings["text_encode_s"],
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
            unshard_params(model)
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


class StandInDecode:
    """While active, the video AE's decode records its latent (on the host)
    and returns zeros of (B, 3, frames, 8, 8) in its place: a path whose
    decode another phase runs at the same shape skips it."""

    def __init__(self, ae, frames: int):
        self.ae, self.frames, self.latents = ae, frames, []

    def __enter__(self):
        def stand_in(z, *args, **kwargs):
            self.latents.append(z.detach().float().cpu())
            return torch.zeros((z.shape[0], 3, self.frames, 8, 8), device=z.device)

        self.ae.decode = stand_in
        return self

    def __exit__(self, *exc):
        del self.ae.decode
        return False


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
    image model's first call and the Flux AE's decode (phase 13); ``built``
    receives the image models (``image_models``, phase 19)."""
    from opensora_torch.inference import make_reference_images, prepare_image_stage
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_optional_models
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
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
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
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
    built["image_models"] = optional
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
    from opensora_torch.utils.config import ae_spatial_compression
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg, (model, ae, t5, clip) = built["cfg"], built["models"]
    video = built["video"]
    with unittest.mock.patch.dict(sys.modules, {"cv2": None}):
        ref_path = save_sample(video[0].numpy(), os.path.join(out_root, "v2v_reference"))
    opt = sanitize_sampling_option(SamplingOption(**dict(cfg.sampling_option, num_steps=V2V_STEPS)),
                                   ae_spatial_compression(cfg))
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
# phases 18-19: 768px generation (768px.py, t2i2v_768px.py)
# ----------------------------------------------------------------------

CFG_768 = os.path.join(REPO, "configs", "diffusion", "inference", "768px.py")
T2I2V_768_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "t2i2v_768px.py")
STEPS_768 = 1  # phase 18's steps, cut from 50 (one step launches each block's forward)
T2I2V_768_STEPS = 1  # phase 19's video steps, cut from 50 (its image stage takes STEPS)
# phase 19's video stage runs the first 2 double and 4 single blocks of
# phase 4's MMDiT: its full-depth step at 76544 tokens repeats phase 18's
T2I2V_768_DEPTH = (2, 4)
SIZE_768, IMAGE_SIZE_768 = (576, 1024), (768, 768)  # 768px 16:9 (the video), 768px 1:1 (the t2i2v image)
# the 129-frame 576 x 1024 video's latent is 33 x 72 x 128; patches of 2 x 2
IMAGE_TOKENS_768 = 33 * 36 * 64
# the 768px decode's spatial tiles (tile 32, stride 24 over 72 x 128 latent
# rows and columns): 10 of 32 x 32, 5 of 24 x 32, 2 of 32 x 8, 1 of 24 x 8
DECODE_TILES_768 = {(32, 32): 10, (24, 32): 5, (32, 8): 2, (24, 8): 1}
PEAK_LIMIT_GB = 80.0  # every 768px phase's peak (torch.cuda.max_memory_allocated / 1e9)
# 768px's joint attention: 3 CFG passes x 24 heads over 76032 image + 512
# text tokens, held against the plain version on these (b, h) pairs with all
# keys; (0, 0) has q scaled by 3 so that the device picks the running-max
# loop there (A >= 40), the other pairs the anchored loop
ATTN_768 = (3, 24, IMAGE_TOKENS_768 + 512, 128)
ATTN_768_PAIRS = ((0, 0), (1, 11), (2, 23))
ATTN_768_ROWS = 4096  # query rows a chunk of the plain version (1.25 GB of fp32 scores)


def tile_grid(ae, h: int, w: int, decode: bool) -> dict:
    """{(rows, columns): count} of the spatial tiles the HunyuanVAE's tiled
    encode (pixels) or decode (latent rows) cuts an h x w frame into, laid
    out as ``spatial_tiled_encode`` / ``spatial_tiled_decode`` lay them:
    tiles of ``tile`` from every multiple of ``tile * (1 - overlap)``, in
    the encode's latent units (its mid-block runs there)."""
    tile = ae.tile_latent_min_size if decode else ae.tile_sample_min_size
    step = int(tile * (1 - ae.config.tile_overlap_factor))
    scale = 1 if decode else ae.config.spatial_compression_ratio
    grid: dict = {}
    for i in range(0, h, step):
        for j in range(0, w, step):
            key = (min(tile, h - i) // scale, min(tile, w - j) // scale)
            grid[key] = grid.get(key, 0) + 1
    return grid


def grid_text(grid: dict) -> str:
    return ", ".join(f"{n} of {r}x{c}" for (r, c), n in grid.items())


def plain_rows(fa, q, k, v, rows: int = ATTN_768_ROWS):
    """The plain version of one (b, h) over chunks of query rows, all keys."""
    outs, lses = [], []
    for r0 in range(0, q.shape[2], rows):
        o, lse = fa.flash_attention_ref(q[:, :, r0:r0 + rows], k, v)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 2), torch.cat(lses, 2)


def check_attention_768px(device, shape=ATTN_768, pairs_held=ATTN_768_PAIRS, tag: str = "768px") -> dict:
    """The D = 128 forward at 768px's joint attention (``shape``: phase 18's
    batched CFG (3, 24, 76544, 128), or a B = 1 pass of phase 32's) bf16 on
    seeded inputs: the kernel's output and LSE against the plain version on
    ``pairs_held`` with all keys, in query chunks (each pair would need 23
    GB of fp32 scores whole), with phase 2's known-wrong
    outputs read on the same pairs (one consumer's rows from the other's,
    the last 128-key tile dropped, V one tile off, the last 64 keys
    skipped); the loop the device picked for every (b, h); the wrapper and
    SDPA timed in turns; the plain version's time on one pair."""
    from opensora_torch.ops import flash_attention as fa

    b, h, l, d = shape
    gen = torch.Generator(device=device).manual_seed(18)
    q = torch.randn(b, h, l, d, generator=gen, device=device)
    q[0, 0] *= 3.0
    q = q.to(torch.bfloat16)
    k = torch.randn(b, h, l, d, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(b, h, l, d, generator=gen, device=device).to(torch.bfloat16)
    anchor = fa.anchor_log2(q, k, d ** -0.5).cpu()
    out, lse = fa.flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    pairs, ok = [], True
    for bi, hi in pairs_held:
        qs, ks, vs = (t[bi:bi + 1, hi:hi + 1] for t in (q, k, v))
        ref_out, ref_lse = plain_rows(fa, qs, ks, vs)
        scale = ref_out.abs().max().item()
        err_out = (out[bi:bi + 1, hi:hi + 1].float() - ref_out).abs().max().item()
        err_lse = (lse[bi:bi + 1, hi:hi + 1] - ref_lse).abs().max().item()

        def reading(o, s):
            return ((o - ref_out).abs().max().item() / scale, (s - ref_lse).abs().max().item())

        swap_out, swap_lse = ref_out.clone(), ref_lse.clone()
        for m0 in range(0, l - 64, 128):
            n = min(64, l - m0 - 64)
            swap_out[:, :, m0 + 64:m0 + 64 + n] = ref_out[:, :, m0:m0 + n]
            swap_lse[:, :, m0 + 64:m0 + 64 + n] = ref_lse[:, :, m0:m0 + n]
        mutants = {"consumer_rows_from_other_consumer": reading(swap_out, swap_lse)}
        del swap_out, swap_lse
        mutants["last_key_tile_dropped"] = reading(*plain_rows(fa, qs, ks[:, :, :l - 128], vs[:, :, :l - 128]))
        mutants["v_tile_shifted"] = reading(*plain_rows(fa, qs, ks, vs.roll(64, dims=2)))
        mutants["tail_keys_skipped"] = reading(*plain_rows(fa, qs, ks[:, :, :l - 64], vs[:, :, :l - 64]))
        caught = all(r_out > OUT_RTOL or r_lse > LSE_TOL for r_out, r_lse in mutants.values())
        good = math.isfinite(err_out) and err_out <= OUT_RTOL * scale and err_lse <= LSE_TOL
        ok &= good and caught
        pairs.append(dict(b=bi, h=hi, anchor=float(anchor[bi, hi]),
                          branch="anchored" if float(anchor[bi, hi]) < 40 else "running_max",
                          max_abs_err=err_out, ref_max_abs=scale, rel_err=err_out / scale, lse_max_abs_err=err_lse,
                          mutants=mutants, within_limits=good, wrong_rejected=caught))
        del ref_out, ref_lse
    plain_ms = time_cuda(lambda: plain_rows(fa, q[:1, :1], k[:1, :1], v[:1, :1]), 1, warmup=0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = dict(ms=lambda: fa.flash_attention_with_lse(q, k, v), library_ms=lambda: sdpa(q, k, v))
    turns = dict(ms=[], library_ms=[])
    for key in ("ms", "library_ms", "library_ms", "ms"):
        turns[key].append(time_cuda(fns[key], 1))
    ms, library_ms = (sum(x) / len(x) for x in (turns["ms"], turns["library_ms"]))
    bound_ms, bound_by = attention_bound(b, h, l, d, None)
    branches = {"anchored": int((anchor < 40).sum()), "running_max": int((anchor >= 40).sum())}
    res = dict(name=f"mmdit_joint_{tag}", shape=list(shape), causal_block=None, pairs=pairs,
               device_branches=branches, max_abs_err=max(p["max_abs_err"] for p in pairs),
               rel_err=max(p["rel_err"] for p in pairs), lse_max_abs_err=max(p["lse_max_abs_err"] for p in pairs),
               ms=ms, ms_turns=turns["ms"], library_ms=library_ms, library_ms_turns=turns["library_ms"],
               plain_ms_one_pair=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               kernel=fa.KERNEL_FWD_SM90)
    log(f"[{tag}] {fa.KERNEL_FWD_SM90} {list(shape)}: loops picked {branches}; on (b, h) "
        + "; ".join(f"({p['b']}, {p['h']}) {p['branch']} A={p['anchor']:.1f} out_err={p['rel_err']:.3e} of max|ref| "
                    f"(tol {OUT_RTOL}) lse_err={p['lse_max_abs_err']:.3e} (tol {LSE_TOL}) wrong outputs "
                    + ", ".join(f"{n} ({ro:.2e}, {rl:.2e})" for n, (ro, rl) in p["mutants"].items())
                    + (" rejected" if p["wrong_rejected"] else " NOT REJECTED") for p in pairs)
        + f"; ms={ms:.3f} ({min(turns['ms']):.3f}-{max(turns['ms']):.3f}) sdpa_ms={library_ms:.3f} "
        f"({min(turns['library_ms']):.3f}-{max(turns['library_ms']):.3f}) in turns bound_ms={bound_ms:.3f} "
        f"({bound_by}) plain_ms one pair={plain_ms:.3f} {'OK' if ok else 'FAIL'}")
    del q, k, v, out, lse, fns
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the D = 128 forward at 768px disagrees with its plain version, or a known-wrong "
                             "output passes the limits")
    return res


@contextlib.contextmanager
def cut_depth(model, depth: int, single: int):
    """``model`` running its first ``depth`` double-stream and ``single``
    single-stream blocks only (the same modules, no copy), restored after."""
    blocks = model.double_blocks, model.single_blocks
    model.double_blocks = torch.nn.ModuleList(list(blocks[0])[:depth])
    model.single_blocks = torch.nn.ModuleList(list(blocks[1])[:single])
    try:
        yield
    finally:
        model.double_blocks, model.single_blocks = blocks


def check_same_models(cfg, other, keys, what: str) -> None:
    for key in keys:
        if cfg[key] != other[key]:
            raise AssertionError(f"{what}'s {key} differs")


def check_peak(tag: str, peak_gb: float) -> None:
    if peak_gb >= PEAK_LIMIT_GB:
        raise AssertionError(f"{tag}: peak {peak_gb:.2f} GB is not under {PEAK_LIMIT_GB} GB")


def run_768px_path(device, built, profile: bool = False, out_dir=None) -> dict:
    """configs/diffusion/inference/768px.py at full width and depth on phase
    4's models (the config's model, ae, t5 and clip are 256px.py's), while
    no image model is resident, through parse_configs, the CLI's mesh rule
    and api_fn for STEPS_768 steps: a finite latent of 33 x 72 x 128, 76032
    image tokens, 57 D = 128 launches a step, the peak under PEAK_LIMIT_GB;
    then the D = 128 forward at the path's attention shape
    (check_attention_768px). The decode is left out (a stand-in records the
    latent): phase 32 decodes a 768px latent with the same VAE, its tiles
    and launches checked there."""
    from opensora_torch.inference import inference_mesh
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([CFG_768, "--sampling_option.num_steps", str(STEPS_768)])
    check_same_models(cfg, built["cfg"], ("model", "ae", "t5", "clip"), "768px.py (against 256px.py)")
    model, ae, t5, clip = built["models"]
    mesh = inference_mesh(cfg, device)
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    lt = (opt.num_frames - 1) // opt.temporal_reduction + 1
    tokens = lt * (opt.height // 16) * (opt.width // 16)
    log(f"[768px] 768px.py at full width and depth on phase 4's models; num_steps cut 50 -> {STEPS_768}; mesh "
        f"{dict(cfg.mesh)} on {torch.cuda.device_count()} card(s): {'none' if mesh is None else mesh}; video "
        f"{opt.num_frames} x {opt.height} x {opt.width}, latent {lt} x {opt.height // 8} x {opt.width // 8}, "
        f"{tokens} image tokens")
    if mesh is not None or (opt.height, opt.width) != SIZE_768 or tokens != IMAGE_TOKENS_768:
        raise AssertionError(f"768px.py: mesh {mesh}, size {opt.height} x {opt.width}, {tokens} tokens")
    api_fn = prepare_api(model, ae, t5, clip, mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    _build.LAUNCHES.clear()
    timings: dict = {}
    with StandInDecode(ae, opt.num_frames) as rec:
        t0 = time.perf_counter()
        api_fn(opt, cond_type=cfg.cond_type, seed=cfg.seed, text=T2I2V_PROMPT, channel=cfg.model["in_channels"],
               timings=timings)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    latent, = rec.latents
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    expect = {"flash_attention_fwd_sm90": n_blocks * STEPS_768}
    finite = bool(torch.isfinite(latent).all())
    res = dict(latent_shape=list(latent.shape), image_tokens=tokens, text_encode_s=timings["text_encode_s"],
               step_s=timings["step_s"], total_s=total_s, peak_mem_gb=peak_gb, launches=launches, expected=expect)
    log("[768px] " + json.dumps(res))
    if tuple(latent.shape) != (1, 16, lt, opt.height // 8, opt.width // 8) or not finite:
        raise AssertionError(f"768px latent {res['latent_shape']} finite={finite}")
    if launches != expect:
        raise AssertionError(f"768px launches {launches} != {expect}")
    check_peak("768px.py", peak_gb)
    if profile:
        res["profile"] = profile_run(lambda: api_fn(opt, cond_type=cfg.cond_type, seed=cfg.seed, text=T2I2V_PROMPT,
                                                    channel=cfg.model["in_channels"]), "768px", out_dir)
    res["attention"] = check_attention_768px(device)
    return res


def run_t2i2v_768px_path(device, built, out_root) -> dict:
    """configs/diffusion/inference/t2i2v_768px.py at full width and depth on
    phase 4's video models and phase 11's image models (the config's are
    theirs), through the CLI's own t2i2v code (inference.ImageStage:
    prepare_image_stage, make_reference_images, then the image models
    parked in host memory): the 768 x 768 image in STEPS steps, then the
    i2v_head video of (1, 3, 129, 576, 1024) in T2I2V_768_STEPS step(s).
    Checks shapes, finite outputs, that the latent's first frame before
    decoding equals the encoded reference, the exact launches (the
    reference encode's D = 512 tiles among them), the peak under
    PEAK_LIMIT_GB; logs the host memory and the seconds of parking and of
    loading back. Then the control: the image models loaded back and the
    same video made with every model resident, its peak (or the card's
    out-of-memory error) logged, and whether its video equals the parked
    run's if it fits."""
    from opensora_torch.datasets.utils import read_from_path
    from opensora_torch.inference import ImageStage
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import load_to_device, prepare_api
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    cfg = parse_configs([T2I2V_768_CFG, "--sampling_option.num_steps", str(T2I2V_768_STEPS),
                         "--sampling_option_t2i.num_steps", str(STEPS)])
    cfg.sampling_option_t2i["seed"] = cfg.seed
    check_same_models(cfg, built["cfg"], ("model", "ae", "t5", "clip"), "t2i2v_768px.py (against 256px.py)")
    check_same_models(cfg, parse_configs([T2I2V_CFG]), ("img_flux", "img_flux_ae"),
                      "t2i2v_768px.py (against t2i2v_256px.py)")
    model, ae, t5, clip = built["models"]
    optional = built.pop("image_models")
    patch = cfg.get("patch_size", 2)
    stage = ImageStage(cfg, optional, t5, clip, patch)
    api_fn = prepare_api(model, ae, t5, clip)
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    n_img_blocks = cfg.img_flux["depth"] + cfg.img_flux["depth_single_blocks"]
    n_blocks = sum(T2I2V_768_DEPTH)
    log(f"[t2i2v_768px] t2i2v_768px.py at full width on phases 4 and 11's models, the video stage at "
        f"{T2I2V_768_DEPTH[0]} + {T2I2V_768_DEPTH[1]} blocks; num_steps cut 50 -> {STEPS} (image), "
        f"{T2I2V_768_STEPS} (video); the image models parked between the stages: {stage.park}")
    if not stage.park:
        raise AssertionError("the CLI's t2i2v flow does not park the image models on a card")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    resident_gb = torch.cuda.memory_allocated(device) / 1e9
    _build.LAUNCHES.clear()
    img_timings: dict = {}
    t0 = time.perf_counter()
    refs = stage(T2I2V_PROMPT, out_root, 0, img_timings)
    image_s = time.perf_counter() - t0
    img_launches = dict(_build.LAUNCHES)
    image_peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    parked_resident_gb = torch.cuda.memory_allocated(device) / 1e9
    image = read_from_path(refs[0], (stage.opt.height, stage.opt.width))

    def video(tag: str):
        torch.cuda.reset_peak_memory_stats(device)
        _build.LAUNCHES.clear()
        timings: dict = {}
        with AERecorder(ae) as rec, cut_depth(model, *T2I2V_768_DEPTH):
            t0 = time.perf_counter()
            x = api_fn(opt, cond_type=cfg.cond_type, seed=cfg.seed, text=T2I2V_PROMPT,
                       channel=cfg.model["in_channels"], timings=timings, ref=refs)
            torch.cuda.synchronize()
            timings["video_s"] = time.perf_counter() - t0
        log(f"[t2i2v_768px] {tag} video made in {timings['video_s']:.1f} s")
        return x.cpu(), rec, timings, dict(_build.LAUNCHES), torch.cuda.max_memory_allocated(device) / 1e9

    x, rec, timings, launches, video_peak_gb = video("parked")
    (enc_in, enc_out), = rec.encoded
    latent, = rec.decoded
    first_equal = bool(torch.equal(latent[0, :, :1], enc_out[0][:, :1].to(latent.dtype)))
    ref_frame = torch.from_numpy(read_from_path(refs[0], (opt.height, opt.width))[:, :1])
    enc_in_err = float((enc_in[0] - ref_frame).abs().max())
    enc_grid = tile_grid(ae, enc_in.shape[3], enc_in.shape[4], decode=False)
    dec_grid = tile_grid(ae, latent.shape[3], latent.shape[4], decode=True)
    expect_img = {"flash_attention_fwd_sm90": n_img_blocks * STEPS}
    expect = {"flash_attention_fwd_sm90": n_blocks * T2I2V_768_STEPS,
              "flash_attention_fwd_d512": enc_in.shape[0] * sum(enc_grid.values()) + sum(dec_grid.values())}
    finite = bool(torch.isfinite(x).all()) and bool(torch.isfinite(torch.from_numpy(image)).all())
    outside = float((x.abs() > 1.0).float().mean())
    peak_gb = max(image_peak_gb, video_peak_gb)
    res = dict(reference=os.path.basename(refs[0]), image_shape=list(image.shape), video_shape=list(x.shape),
               image_s=image_s, image_step_s=img_timings["step_s"], image_decode_s=img_timings["decode_s"],
               park_s=img_timings.get("park_s"), parked_gb=img_timings.get("parked_gb"),
               host_available_gb=img_timings.get("host_available_gb"), resident_before_gb=resident_gb,
               resident_parked_gb=parked_resident_gb, image_peak_gb=image_peak_gb, video_peak_gb=video_peak_gb,
               peak_mem_gb=peak_gb, encode_ref_s=timings["encode_ref_s"], step_s=timings["step_s"],
               decode_s=timings["decode_s"], video_s=timings["video_s"], outside_share=outside,
               first_latent_frame_equals_encoded_reference=first_equal,
               encode_input_vs_saved_image_max_abs=enc_in_err,
               encode_tiles={f"{r}x{c}": n for (r, c), n in enc_grid.items()},
               decode_tiles={f"{r}x{c}": n for (r, c), n in dec_grid.items()},
               launches=launches, expected=expect, image_launches=img_launches, image_expected=expect_img)
    log(f"[t2i2v_768px] encode tiles ({grid_text(enc_grid)}), decode tiles ({grid_text(dec_grid)}) "
        + json.dumps(res))
    if tuple(image.shape) != (3, 1, *IMAGE_SIZE_768) or tuple(x.shape) != (1, 3, opt.num_frames, *SIZE_768):
        raise AssertionError(f"image {tuple(image.shape)} / video {tuple(x.shape)} shapes")
    if not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"t2i2v_768px output not finite, or {outside:.4f} of the video outside [-1, 1]")
    if not first_equal or enc_in_err > 1e-6:
        raise AssertionError("the video's first latent frame is not the encoded reference image")
    if img_launches != expect_img or launches != expect or dec_grid != DECODE_TILES_768:
        raise AssertionError(f"kernel launches {img_launches} / {launches} != expected {expect_img} / {expect}")
    check_peak("t2i2v_768px.py", peak_gb)

    # the control: every model resident through the video stage
    t0 = time.perf_counter()
    loaded = sum(load_to_device(m, device) for m in stage.models)
    res["load_s"], res["loaded_gb"] = time.perf_counter() - t0, loaded / 1e9
    control = dict(resident_gb=torch.cuda.memory_allocated(device) / 1e9)
    try:
        x_res, _, t_res, _, control["peak_mem_gb"] = video("resident (control)")
        control.update(fits=True, video_s=t_res["video_s"], video_equal_parked=bool(torch.equal(x_res, x)))
        del x_res
    except torch.cuda.OutOfMemoryError as e:
        control.update(fits=False, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                       error=str(e).splitlines()[0])
    res["resident_control"] = control
    log(f"[t2i2v_768px] image models loaded back in {res['load_s']:.2f} s ({res['loaded_gb']:.2f} GB); with every "
        "model resident: " + json.dumps(control))
    del stage, optional, x
    gc.collect()
    torch.cuda.empty_cache()
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
    if mesh is not None:  # the tokens in chunks over the sp ranks; one leaf a factor on the one card
        from opensora_torch.parallel.sharding import shard_params

        shard_params(mesh, card, fsdp=False)
        card_f = {n: card.sharding.placements[n].leaves[0] for n in cpu_f}

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
        with RankTokens(card) as tokens:
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
    if mesh is not None:
        res["ranks"] = tokens.check("small", RING_SP, n_img + lt)
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


RING_TRAIN_STEPS = 1  # LoRA steps of the ring training path (phase 10)


def run_ring_train_path(device, built, profile: bool = False, out_dir=None) -> dict:
    """Phase 5's trainer (lora.py at full width and depth) with its state
    placed over RING_SP logical ranks on the card (``shard_state``: the
    frozen base and the factors replicated, the tokens in chunks over the
    sp ranks) and its MMDiT's attention switched to ``ring_rdma``:
    RING_TRAIN_STEPS steps of Trainer.run_batch; finite loss and gradient
    norm, moving LoRA factors, each rank's tokens, the exact launches of
    the ring kernels, the dQ epilogue (once per rank and backward call) and
    the VAE encode's flash forward. The trainer is not used after."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.training.diffusion import shard_state
    from opensora_torch.utils.train import single_frame_encodes

    trainer, batch = built["trainer"], built["batch"]
    cfg = trainer.cfg
    mesh = ring_mesh(device)
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    hops = RING_SP * RING_SP
    trainer.state = shard_state(mesh, trainer.state, trainer.model)
    trainer.mesh, trainer.place_batch = mesh, True
    factors = list(trainer.state.params.values())  # the factors' leaves
    log(f"[ring_train] lora.py (phase 5's trainer), placed over {mesh}, attn_backend=ring_rdma; "
        f"{RING_TRAIN_STEPS} steps")
    set_attn_backend(trainer.model, "ring_rdma")
    set_mesh(mesh)
    steps = []
    try:
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(RING_TRAIN_STEPS):
            before = [p.detach().clone() for p in factors]
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            with RankTokens(trainer.model) as tokens:
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
                       step_s=times["time/step"], total_s=total_s,
                       ranks=tokens.check("ring_train", RING_SP, sum(tokens.summary()["single"]["tokens"])))
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
                  records=None, keep: bool = False):
    """256px_int8attn.py (with ``overrides``) for ``steps`` steps; ``records``
    (a dict) receives the MMDiT's first call under ``tag``. With ``keep``,
    returns (result, built): the models, the run's arguments and its final
    latent, for phase 26."""
    from opensora_torch.ops import _build
    from opensora_torch.utils.api import prepare_api, prepare_models
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
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
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
    prompt = ["a red panda eating bamboo in a misty forest, 16 FPS. 4 motion score."]
    run_kwargs = dict(opt=opt, cond_type=cfg.cond_type, seed=cfg.seed, text=prompt, channel=cfg.model["in_channels"])
    _build.LAUNCHES.clear()
    timings: dict = {}
    with FirstCall(model) as rec_model, LatentRecorder(ae) as rec_latent:
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
    if keep:
        return res, dict(cfg=cfg, models=(model, ae, t5, clip), run_kwargs=run_kwargs, latent=rec_latent.latents[0],
                         step_s=timings["step_s"], peak_mem_gb=peak_gb)
    del model, ae, t5, clip, api_fn, x
    gc.collect()
    torch.cuda.empty_cache()
    return res


# Phase 26: 256px_int8attn.py composed with plugins/tp.py, tp 4 over logical
# ranks on phase 6's models (sharded in place), phase 6's steps, seed and
# prompt. Its final latent against phase 6's, relative L2, within the bf16
# TP limit of phase 20 (TP_LATENT_TOL; phase 20 read 0.0264 from phase 4's):
# the tp ranks' partial products round in other places, and the int8 path's
# per-token quantization turns an activation an ulp from a rounding edge into
# the next int8 level (the first card run read 0.0397). Phase 6's own
# run-to-run spread (the unsharded run again, before the sharding) is read
# in every run and must lie within the limit too.
INT8_TP_LATENT_TOL = 0.06  # phase 20's TP_LATENT_TOL


def int8_tp_expected_launches(cfg, steps: int, tp: int) -> dict:
    """Phase 26's launches: per forward, each modulation once (replicated:
    the logical ranks share the card), each other block linear and each
    attention once per tp rank; the decode's 2 D = 512 tiles."""
    depth, single = cfg.model["depth"], cfg.model["depth_single_blocks"]
    per_forward = {"w8a8_matmul": depth * (2 + 8 * tp) + single * (1 + 2 * tp),
                   "int8_flash_attention": (depth + single) * tp}
    out = {k: v * steps for k, v in per_forward.items()}
    out["flash_attention_fwd_d512"] = 2
    return out


def run_int8_tp_path(device, built, root: str) -> dict:
    """Phase 26: int8 serving under TP through prepare_api(mesh=...) on
    phase 6's models: the quantized MMDiT (w8a8, int8_qk8) sharded over
    TP_RANKS logical ranks, the int8 weights and fp32 scales cut per rank
    in their dtypes, the row-parallel products quantized against the whole
    row's scale (``QuantLinear.tp_row_partials``). Phase 6's steps: the
    latent against phase 6's within INT8_TP_LATENT_TOL, exact launches at
    the tp ranks' shapes, the steps' seconds beside phase 6's, the peak."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.config import parse_configs

    path = os.path.join(root, "256px_int8attn_tp.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{INT8_CFG!r}, {os.path.join(os.path.dirname(TP_CFG), 'plugins', 'tp.py')!r}]\n")
    steps = built["cfg"].sampling_option["num_steps"]
    cfg = parse_configs([path, "--sampling_option.num_steps", str(steps)])
    check_same_models(cfg, built["cfg"], ("model", "ae", "t5", "clip", "sampling_option"), "256px_int8attn.py + tp")
    model, ae, t5, clip = built["models"]
    mesh = create_mesh(MeshConfig(**cfg.mesh), [device] * TP_RANKS)
    log(f"[int8_tp] 256px_int8attn.py + plugins/tp.py (quantized={cfg.model['quantized']}, attn_backend="
        f"{cfg.model['attn_backend']}) at full width and depth on phase 6's models, mesh {dict(cfg.mesh)} over "
        f"{mesh}; {steps} steps")
    with LatentRecorder(ae) as again:  # phase 6's run-to-run spread
        prepare_api(model, ae, t5, clip)(**built["run_kwargs"])
    spread = float((again.latents[0] - built["latent"]).norm() / built["latent"].norm())
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        api_fn = prepare_api(model, ae, t5, clip, mesh=mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        qkv = model.sharding.placements["double_blocks.0.img_attn.qkv.weight_q"]
        scale = model.sharding.placements["single_blocks.0.linear1.weight_scale"]
        leaves = dict(qkv_weight_q=[[list(p.shape), str(p.dtype)] for p in qkv.leaves],
                      linear1_weight_scale=[[list(p.shape), str(p.dtype)] for p in scale.leaves])
        _build.LAUNCHES.clear()
        timings: dict = {}
        with LatentRecorder(ae) as rec:
            t0 = time.perf_counter()
            x = api_fn(**built["run_kwargs"], timings=timings)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        latent_rel = float((rec.latents[0] - built["latent"]).norm() / built["latent"].norm())
        finite = bool(torch.isfinite(x).all())
        outside = float((x.abs() > 1.0).float().mean())
        shape = tuple(x.shape)
        del x
    finally:
        set_mesh(None)
    expect = int8_tp_expected_launches(cfg, steps, TP_RANKS)
    res = dict(mesh=repr(mesh), tp=model.sharding.tp, leaves=leaves, launches=launches, expected=expect,
               shard_s=shard_s, step_s=timings["step_s"], phase6_step_s=built["step_s"],
               decode_s=timings["decode_s"], total_s=total_s, peak_mem_gb=peak_gb,
               phase6_peak_mem_gb=built["peak_mem_gb"], latent_rel_l2_vs_phase6=latent_rel, tol=INT8_TP_LATENT_TOL,
               phase6_spread_rel_l2=spread, outside_share=outside)
    log("[int8_tp] " + json.dumps(res))
    opt = built["run_kwargs"]["opt"]
    if shape != (1, 3, opt.num_frames, opt.height, opt.width) or not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"int8 tp output {shape}, finite={finite}, outside [-1, 1]: {outside:.4f}")
    if any(p[1] != "torch.int8" for p in leaves["qkv_weight_q"]) or \
            any(p[1] != "torch.float32" for p in leaves["linear1_weight_scale"]):
        raise AssertionError(f"int8 tp leaves lost their dtypes: {leaves}")
    if launches != expect:
        raise AssertionError(f"int8 tp launches {launches} != expected {expect}")
    if not (latent_rel <= INT8_TP_LATENT_TOL and spread <= INT8_TP_LATENT_TOL):
        raise AssertionError(f"int8 tp latent vs phase 6's: relative L2 {latent_rel:.4e} (phase 6 again: "
                             f"{spread:.4e}) > {INT8_TP_LATENT_TOL}")
    check_peak("int8_tp", peak_gb)
    return res


# ----------------------------------------------------------------------
# phase 32: the one-card 768px serving configs on phase 6's int8 models
# ----------------------------------------------------------------------

# configs/diffusion/inference/768px_1chip.py and 768px_1chip_int8attn.py:
# 768px.py with w8a8_pallas products and cfg_batched=False (three B = 1
# passes a step), the second with int8_qk8 attention; seq_chunks=16 is a
# memory lever of the JAX package that the port leaves out (ROADMAP's
# porting rules): its builder ignores the key. Phase 32 runs both on phase
# 6's full-depth int8 model (w8a8 and w8a8_pallas compute the same function:
# opensora_torch/ops/quant.py), its T5-XXL, CLIP-L and VAE, which are the
# configs' own (checked), for STEPS_768_1CHIP denoise steps each.
CFG_768_1CHIP = os.path.join(REPO, "configs", "diffusion", "inference", "768px_1chip.py")
CFG_768_1CHIP_INT8ATTN = os.path.join(REPO, "configs", "diffusion", "inference", "768px_1chip_int8attn.py")
STEPS_768_1CHIP = 1  # denoise steps of each config, cut from 50
# the B = 1 pass's W8A8 products: the image stream's (76032 rows), the text
# stream's (512 rows), the single blocks' over the joint 76544 tokens (linear1's
# bf16 output is 3.29 GB, past 2^31 bytes), and the modulations' one row
GEMM_768_CASES = [
    ("768_double_img_qkv", IMAGE_TOKENS_768, 3072, 9216),
    ("768_double_img_mlp2", IMAGE_TOKENS_768, 12288, 3072),
    ("768_double_txt_mlp0", 512, 3072, 12288),
    ("768_single_linear1", IMAGE_TOKENS_768 + 512, 3072, 21504),
    ("768_single_linear2", IMAGE_TOKENS_768 + 512, 15360, 3072),
    ("768_modulation_b1", 1, 3072, 18432),
]
GEMM_768_HEAD = "768_single_linear1"
GEMM_768_BAND = 1024  # rows of each band of the output held against the plain version
# the int8 and bf16 attention of one B = 1 pass, held on these (b, h) pairs
# over all query rows in chunks; (0, 0) has q scaled by 3 so that its loop is
# the running max
ATTN_768_B1 = (1, 24, IMAGE_TOKENS_768 + 512, 128)
ATTN_768_B1_PAIRS = ((0, 0), (0, 13))
# cfg_batched=False against the batched pass on a small input (2 x 16 x 16
# latent: 128 image + 64 text tokens, so that int8 attention engages) at
# full width and 2 + 4 blocks of phase 6's model: the velocity of one Euler
# step, relative L2. Each token and (b, h) quantizes alone, but the batch
# changes the bf16 products' sums (the embedders and the final layer run in
# bf16 through cuBLAS), and an activation an ulp from an int8 rounding step
# cascades (tests/test_torch_768px_1chip.py reads 2.9e-3 on the CPU's tiny
# model). The control, the sequential passes with the conditional and the
# first unconditional prompt swapped, must exceed the limit.
CFG_BATCHED_DEPTH = (2, 4)
CFG_BATCHED_TOL = 2e-2


def int8_1chip_expected(cfg, steps: int, passes: int = 3) -> dict:
    """Kernel launches of ``steps`` steps of the sequential CFG (``passes``
    B = 1 forwards a step): every block linear a w8a8_matmul (10 per double
    block, 3 per single block; w8a8_pallas quantizes outside at every row
    count), one attention per block: int8_qk8's, or the bf16 flash forward."""
    depth, single = cfg.model["depth"], cfg.model["depth_single_blocks"]
    attn = "int8_flash_attention" if cfg.model.get("attn_backend") == "int8_qk8" else "flash_attention_fwd_sm90"
    return {"w8a8_matmul": passes * steps * (10 * depth + 3 * single), attn: passes * steps * (depth + single)}


def gemm_bands(m: int, n: int) -> dict:
    """Row bands of an (m, n) bf16 product held against the plain version:
    the first and the last GEMM_768_BAND rows and, where the output passes
    2^31 bytes, the band around the row that holds byte 2^31 ("past_2^31")."""
    if m <= 3 * GEMM_768_BAND:
        return {"all": (0, m)}
    bands = {"first": (0, GEMM_768_BAND)}
    if 2 * m * n > 2 ** 31:
        edge = 2 ** 31 // (2 * n)
        lo = edge // 64 * 64 - GEMM_768_BAND // 2
        bands["past_2^31"] = (lo, lo + GEMM_768_BAND)
    bands["last"] = (m - GEMM_768_BAND, m)
    return bands


def check_int8_gemm_768px(device) -> dict:
    """w8a8_matmul at the 768px B = 1 pass's shapes (GEMM_768_CASES), bf16
    output as on the path, on seeded int8 inputs: every element of each row
    band (gemm_bands) equal to the plain version's; on the band past 2^31
    output bytes (else the last band), known-wrong outputs -- its rows left
    unwritten (zero), one consumer's rows from the other's, a 32-wide K
    slice dropped -- each differing; the kernel and torch._int_mm + the
    fp32 rescale timed in turns, the plain version on one band."""
    from opensora_torch.ops import int8_matmul as im

    gen = torch.Generator(device=device).manual_seed(32)
    cases = []
    bf16 = torch.bfloat16
    for name, m, k, n in GEMM_768_CASES:
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        sa = torch.rand((m, 1), generator=gen, device=device) * 1e-2 + 1e-3
        sw = torch.rand((n,), generator=gen, device=device) * 1e-2 + 1e-3
        out = im.w8a8_matmul(x8, w, sa, sw)
        torch.cuda.synchronize()
        bands = gemm_bands(m, n)
        held = "past_2^31" if "past_2^31" in bands else list(bands)[-1]
        rec = dict(name=name, shape_mkn=[m, k, n], output_bytes=2 * m * n, bands={}, mutants={})
        for tag, (lo, hi) in bands.items():
            ref = im.w8a8_matmul_ref(x8[lo:hi], w, sa[lo:hi], sw, bf16)
            got = out[lo:hi]
            rec["bands"][tag] = dict(rows=[lo, hi], elements_differing=int((got != ref).sum()),
                                     max_abs_err=float((got.float() - ref.float()).abs().max()))
            if tag == held:
                def differing(wrong):
                    return int((wrong != ref).sum())

                rec["mutants"] = {"band_rows_not_written": differing(torch.zeros_like(ref)),
                                  "k32_slice_dropped": differing((ref.float() - gemm_from_x8(
                                      x8[lo:hi, 32:64], w[:, 32:64], sa[lo:hi], sw)).to(bf16))}
                if hi - lo > 64:
                    rec["mutants"]["consumer_rows_swapped"] = differing(consumer_rows_swapped(ref))
                rec["held_band"] = tag
                band = (lo, hi)
            del ref, got
        del out
        iters = 3 if 2.0 * m * n * k > 1e12 else 20
        timed = dict(kernel=lambda: im.w8a8_matmul(x8, w, sa, sw))
        if m > 16:  # torch._int_mm takes more than 16 rows
            timed["library"] = lambda: (torch._int_mm(x8, w.t()).float() * sa * sw).to(bf16)
        turns = {key: [] for key in timed}
        for key in (tuple(timed) + tuple(timed)[::-1]) * 2:
            turns[key].append(time_cuda(timed[key], iters))
        mean = {key: sum(v) / len(v) for key, v in turns.items()}
        lo, hi = band
        plain_ms = time_cuda(lambda: im.w8a8_matmul_ref(x8[lo:hi], w, sa[lo:hi], sw, bf16), 1, warmup=0)
        bound_ms, bound_by = gemm_bound(m, k, n, False)
        rec.update(ms=mean["kernel"], ms_turns=turns["kernel"], library_ms=mean.get("library"),
                   library_ms_turns=turns.get("library"), plain_ms=plain_ms, plain_rows=hi - lo,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=max(b["max_abs_err"] for b in rec["bands"].values()))
        ok = all(b["elements_differing"] == 0 for b in rec["bands"].values())
        caught = all(c > 0 for c in rec["mutants"].values())
        rec.update(within_limits=ok, wrong_rejected=caught)
        cases.append(rec)
        library_txt = "n/a (one row)" if "library" not in mean else (
            f"{mean['library']:.3f} ({min(turns['library']):.3f}-{max(turns['library']):.3f})")
        log(f"[768px_1chip] w8a8_matmul {name} (M, K, N) = ({m}, {k}, {n}), bf16 output {2 * m * n / 1e9:.2f} GB: "
            "elements differing from the plain version by band " + ", ".join(
                f"{t} {b['rows']} {b['elements_differing']}" for t, b in rec["bands"].items())
            + f" (must be 0); wrong outputs on the {held} band (elements differing): {rec['mutants']} "
            f"{'rejected' if caught else 'NOT REJECTED'}; in turns ms={mean['kernel']:.3f} "
            f"({min(turns['kernel']):.3f}-{max(turns['kernel']):.3f}) torch._int_mm + rescale {library_txt}; "
            f"bound {bound_ms:.3f} ({bound_by}); plain on {hi - lo} rows {plain_ms:.3f} "
            f"{'OK' if ok and caught else 'FAIL'}")
        del x8, w, sa, sw, timed
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"w8a8_matmul disagrees with its plain version at {name}")
        if not caught:
            raise AssertionError(f"the check at {name} does not reject a known-wrong output")
    return {"cases": cases}


def int8_pair_plain(ia, pre, rows: int = ATTN_768_ROWS):
    """The plain int8 attention of one (b, h) from its preamble (the whole
    head's: a2 and K's tiles need every row), over chunks of query rows."""
    outs = []
    for r0 in range(0, pre["q8"].shape[2], rows):
        band = dict(pre, q8=pre["q8"][:, :, r0:r0 + rows], sq=pre["sq"][:, :, r0:r0 + rows])
        outs.append(ia.attention_from_quantized(band, False))
    return torch.cat(outs, 2)


def check_int8_attention_768px(device, mufu_per_s: float) -> dict:
    """int8_qk8 attention at the 768px B = 1 pass's (1, 24, 76544, 128) on
    seeded inputs: the kernel's output against the plain version on
    ATTN_768_B1_PAIRS over every query row in chunks (a head's fp32 logits
    are 23 GB whole), known-wrong outputs read on the same pairs (sk of the
    neighbouring tile, the tail key tile skipped, one consumer's rows from
    the other's); the loop of every (b, h) from its a2; the kernel alone,
    the wrapper and bf16 SDPA timed in turns; the plain version on one
    pair."""
    from opensora_torch.ops import int8_flash as ia

    b, h, l, d = ATTN_768_B1
    gen = torch.Generator(device=device).manual_seed(33)
    q = torch.randn((b, h, l, d), generator=gen, device=device)
    q[0, 0] *= 3.0
    q = q.to(torch.bfloat16)
    k = torch.randn((b, h, l, d), generator=gen, device=device).to(torch.bfloat16)
    v = (torch.randn((b, h, l, d), generator=gen, device=device) + 0.5).to(torch.bfloat16)
    scale = d ** -0.5
    block_k = ia.default_block_k(l)
    out = ia.int8_flash_attention(q, k, v, pv_int8=False)
    torch.cuda.synchronize()
    pre = ia.kernel_inputs(q, k, v, scale, block_k, False)
    a2 = pre["a2"].cpu()
    pairs, ok = [], True
    keep = l - (l % 64 or 64)
    for bi, hi in ATTN_768_B1_PAIRS:
        qs, ks, vs = (x[bi:bi + 1, hi:hi + 1] for x in (q, k, v))
        pair_pre = ia.quantize_inputs(qs, ks, vs, scale, block_k, False)
        ref = int8_pair_plain(ia, pair_pre)
        ref_scale = ref.abs().max().item()
        err = (out[bi:bi + 1, hi:hi + 1].float() - ref).abs().max().item()

        def reading(wrong):
            return (wrong - ref).abs().max().item() / ref_scale

        swapped = ref.clone()
        for m0 in range(0, l - 64, 128):
            n = min(64, l - m0 - 64)
            swapped[:, :, m0 + 64:m0 + 64 + n] = ref[:, :, m0:m0 + n]
        mutants = {"consumer_rows_from_other_consumer": reading(swapped)}
        del swapped
        mutants["sk_of_neighbouring_tile"] = reading(int8_pair_plain(ia, dict(pair_pre, sk=pair_pre["sk"].roll(-1, 2))))
        tail_pre = ia.quantize_inputs(qs, ks[:, :, :keep], vs[:, :, :keep], scale, block_k, False)
        mutants["tail_tile_skipped"] = reading(int8_pair_plain(ia, tail_pre))
        del tail_pre
        good = math.isfinite(err) and err <= INT8_ATTN_RTOL * ref_scale
        caught = all(r > INT8_ATTN_RTOL for r in mutants.values())
        ok &= good and caught
        pairs.append(dict(b=bi, h=hi, a2=float(a2[bi, hi]), branch="anchored" if a2[bi, hi] < 40 else "running_max",
                          max_abs_err=err, ref_max_abs=ref_scale, rel_err=err / ref_scale, mutants=mutants,
                          within_limits=good, wrong_rejected=caught))
        del ref, pair_pre
    plain_ms = time_cuda(lambda: int8_pair_plain(ia, ia.quantize_inputs(q[:1, :1], k[:1, :1], v[:1, :1], scale,
                                                                       block_k, False)), 1, warmup=0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = dict(kernel=lambda: ia.launch(pre, False), wrapper=lambda: ia.int8_flash_attention(q, k, v, pv_int8=False),
                 library=lambda: sdpa(q, k, v))
    turns = {key: [] for key in timed}
    for key in (tuple(timed) + tuple(timed)[::-1]) * 2:
        turns[key].append(time_cuda(timed[key], 1))
    mean = {key: sum(t) / len(t) for key, t in turns.items()}
    bound_ms, bound_by, exp2_ms = int8_attention_bound(b, h, l, d, False, mufu_per_s)
    branches = {"anchored": int((a2 < 40).sum()), "running_max": int((a2 >= 40).sum())}
    res = dict(name="int8_qk8_768px_b1", mode="qk8", shape=list(ATTN_768_B1), block_k=block_k, pairs=pairs,
               device_branches=branches, max_abs_err=max(p["max_abs_err"] for p in pairs),
               rel_err=max(p["rel_err"] for p in pairs), ms=mean["kernel"], ms_turns=turns["kernel"],
               wrapper_ms=mean["wrapper"], wrapper_ms_turns=turns["wrapper"], library_ms=mean["library"],
               library_ms_turns=turns["library"], library="bf16 SDPA (the bf16 route's yardstick)",
               plain_ms_one_pair=plain_ms, bound_ms=bound_ms, bound_by=bound_by, exp2_ms=exp2_ms)
    log(f"[768px_1chip] int8_flash_attention qk8 {list(ATTN_768_B1)} block_k={block_k}: loops from a2 {branches}; "
        + "; ".join(f"({p['b']}, {p['h']}) {p['branch']} a2={p['a2']:.1f} err={p['rel_err']:.3e} of max|ref| "
                    f"(tol {INT8_ATTN_RTOL}) wrong outputs " + ", ".join(f"{n} {r:.2e}" for n, r in p["mutants"].items())
                    + (" rejected" if p["wrong_rejected"] else " NOT REJECTED") for p in pairs)
        + f"; in turns (ms): kernel {mean['kernel']:.3f} ({min(turns['kernel']):.3f}-{max(turns['kernel']):.3f}), "
        f"wrapper {mean['wrapper']:.3f}, bf16 SDPA {mean['library']:.3f}; bound {bound_ms:.3f} ({bound_by}; exp2 "
        f"{exp2_ms:.3f}); plain one pair {plain_ms:.3f} {'OK' if ok else 'FAIL'}")
    del q, k, v, out, pre, timed
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("int8 attention at 768px disagrees with its plain version, or a known-wrong output "
                             "passes the limit")
    return res


def check_cfg_batched(device, model, opt) -> dict:
    """cfg_batched=False against cfg_batched=True: one Euler step of the I2V
    denoiser (the config's guidance, oscillation and image guidance) on a
    small seeded input at full width and CFG_BATCHED_DEPTH blocks of the
    served model (its int8 products and attention), the velocity of the
    three B = 1 passes against the batched pass's in relative L2 within
    CFG_BATCHED_TOL; the control (the conditional and first unconditional
    prompts swapped) must exceed it; exact launches."""
    from opensora_torch.ops import _build
    from opensora_torch.utils import sampling as S

    gen = torch.Generator(device=device).manual_seed(34)
    lt, lh, lw, n_txt = 2, 16, 16, 64
    c = model.config
    n_img = lt * (lh // 2) * (lw // 2)
    img = torch.randn((1, n_img, c.in_channels), generator=gen, device=device).expand(3, -1, -1)
    base = dict(img_ids=S.build_img_ids(lt, lh, lw, bs=3, device=device),
                txt=torch.randn((3, n_txt, c.context_in_dim), generator=gen, device=device).to(torch.bfloat16),
                txt_ids=torch.zeros((3, n_txt, 3), device=device),
                y_vec=torch.randn((3, c.vec_in_dim), generator=gen, device=device).to(torch.bfloat16),
                masks=torch.zeros((1, 1, lt, lh, lw), device=device),
                masked_ref=torch.zeros((1, c.in_channels // 4, lt, lh, lw), device=device))
    ts = S.get_schedule(1, n_img, lt)
    kw = dict(guidance=opt.guidance, guidance_img=opt.guidance_img, text_osci=opt.text_osci,
              image_osci=opt.image_osci, scale_temporal_osci=False, patch_size=2)
    dt = float(ts[1] - ts[0])
    depth, single = CFG_BATCHED_DEPTH
    velocity, launches = {}, {}
    swapped = {k: base[k][[1, 0, 2]] for k in ("txt", "y_vec")}
    with cut_depth(model, depth, single), torch.inference_mode():
        for tag, batched, over in (("batched", True, {}), ("sequential", False, {}),
                                   ("control_prompts_swapped", False, swapped)):
            _build.LAUNCHES.clear()
            x = S.I2VDenoiser().denoise(model, img=img, timesteps=ts, cfg_batched=batched, **kw,
                                        **dict(base, **over))
            torch.cuda.synchronize()
            velocity[tag] = (x.float() - img[:1].float()) / dt
            launches[tag] = dict(_build.LAUNCHES)
    n_blocks = depth + single
    per_pass = {"w8a8_matmul": 10 * depth + 3 * single, "int8_flash_attention": n_blocks}
    expect = {"batched": per_pass, "sequential": {k: 3 * v for k, v in per_pass.items()}}
    expect["control_prompts_swapped"] = expect["sequential"]
    rel = rel_l2(velocity["sequential"], velocity["batched"])
    control = rel_l2(velocity["control_prompts_swapped"], velocity["batched"])
    finite = all(bool(torch.isfinite(v).all()) for v in velocity.values())
    res = dict(depth=[depth, single], tokens=n_img + n_txt, velocity_rel_l2=rel, control_rel_l2=control,
               tol=CFG_BATCHED_TOL, launches=launches, expected=expect)
    ok = finite and rel <= CFG_BATCHED_TOL < control and launches == expect
    log(f"[768px_1chip] cfg_batched=False vs True on a small input ({n_img} + {n_txt} tokens, {depth}+{single} "
        f"blocks of the int8 model): velocity rel L2 {rel:.3e} (tol {CFG_BATCHED_TOL}); control, the prompts "
        f"swapped, {control:.3e} {'rejected' if control > CFG_BATCHED_TOL else 'NOT REJECTED'}; launches "
        f"{launches} (expected {expect}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"cfg_batched=False vs True: {res}")
    return res


def run_768px_1chip_path(device, built, mufu_per_s: float) -> dict:
    """Phase 32: 768px_1chip_int8attn.py through the CLI's steps (parse_configs,
    inference_mesh, prepare_api, sanitize_sampling_option with the config's
    compression, api_fn) at full width and depth on phase 6's int8 models
    for STEPS_768_1CHIP steps and the decode: a finite (1, 3, 129, 576, 1024)
    video, exact launches (int8_1chip_expected and the decode's tiles), the
    peak; then 768px_1chip.py, the same weights with the bf16 flash
    attention, for its denoise steps (its decode left out: the same VAE
    call as before), exact launches; then the sequential CFG against the
    batched (check_cfg_batched) and both int8 kernels and the D = 128
    forward at these shapes."""
    from opensora_torch.inference import inference_mesh
    from opensora_torch.ops import _build
    from opensora_torch.ops import int8_flash as ia
    from opensora_torch.ops.quant import QuantLinear
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.sampling import SamplingOption, sanitize_sampling_option

    steps = ["--sampling_option.num_steps", str(STEPS_768_1CHIP)]
    cfgs = {"int8attn": parse_configs([CFG_768_1CHIP_INT8ATTN, *steps]), "bf16attn": parse_configs([CFG_768_1CHIP,
                                                                                                   *steps])}
    base = built["cfg"]
    check_same_models(cfgs["int8attn"], base, ("ae", "t5", "clip"), "768px_1chip_int8attn.py (against 256px_int8attn.py)")
    check_same_models(cfgs["bf16attn"], base, ("ae", "t5", "clip"), "768px_1chip.py (against 256px_int8attn.py)")
    mine = ("quantized", "seq_chunks", "attn_backend")
    for tag, cfg in cfgs.items():
        if {k: v for k, v in cfg.model.items() if k not in mine} != {k: v for k, v in base.model.items()
                                                                      if k not in mine}:
            raise AssertionError(f"phase 32 ({tag}): the config's MMDiT is not phase 6's but for {mine}")
        if cfg.model["quantized"] != "w8a8_pallas" or cfg.sampling_option.get("cfg_batched") is not False:
            raise AssertionError(f"phase 32 ({tag}): quantized {cfg.model['quantized']}, cfg_batched "
                                 f"{cfg.sampling_option.get('cfg_batched')}")
    if base.model["quantized"] != "w8a8" or cfgs["int8attn"].model["attn_backend"] != "int8_qk8" \
            or cfgs["bf16attn"].model.get("attn_backend") is not None:
        raise AssertionError("phase 32: the configs' attention or phase 6's quantization changed")
    model, ae, t5, clip = built["models"]
    quant = [m for m in model.modules() if isinstance(m, QuantLinear)]
    modes = {m.mode for m in quant}
    cfg = cfgs["int8attn"]
    mesh = inference_mesh(cfg, device)
    compression = ae_spatial_compression(cfg)
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), compression)
    lt = (opt.num_frames - 1) // opt.temporal_reduction + 1
    tokens = lt * (opt.height // 16) * (opt.width // 16)
    log(f"[768px_1chip] 768px_1chip_int8attn.py and 768px_1chip.py at full width and depth on phase 6's int8 "
        f"models ({len(quant)} products, modes {sorted(modes)} -> w8a8_pallas); num_steps cut 50 -> "
        f"{STEPS_768_1CHIP}; cfg_batched {opt.cfg_batched}; mesh {cfg.mesh}: {mesh}; video {opt.num_frames} x "
        f"{opt.height} x {opt.width}, {tokens} image tokens; seq_chunks {cfg.model['seq_chunks']} not used by the port")
    if mesh is not None or (opt.height, opt.width) != SIZE_768 or tokens != IMAGE_TOKENS_768 or opt.cfg_batched:
        raise AssertionError(f"phase 32: mesh {mesh}, size {opt.height} x {opt.width}, {tokens} tokens")
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    api_fn = prepare_api(model, ae, t5, clip, spatial_compression=compression, mesh=mesh)
    run_kwargs = dict(cond_type=cfg.cond_type, seed=cfg.seed, text=T2I2V_PROMPT, channel=cfg.model["in_channels"])
    res = dict(image_tokens=tokens, runs={})
    loops = {"anchored": 0, "running_max": 0}

    def counting(launch):
        def wrapped(pre, pv_int8):
            anchored = int((pre["a2"] < 40).sum())
            loops["anchored"] += anchored
            loops["running_max"] += pre["a2"].numel() - anchored
            return launch(pre, pv_int8)
        return wrapped

    latents = {}
    try:
        for m in quant:
            m.mode = cfg.model["quantized"]
        for tag in ("int8attn", "bf16attn"):
            set_attn_backend(model, cfgs[tag].model.get("attn_backend"))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            _build.LAUNCHES.clear()
            timings: dict = {}
            ctx = contextlib.ExitStack()
            if tag == "int8attn":
                rec = ctx.enter_context(AERecorder(ae))
                ctx.enter_context(patched(ia, "launch", counting))
            else:  # the denoiser only: the decode is the one above
                rec = ctx.enter_context(StandInDecode(ae, opt.num_frames))
            with ctx:
                t0 = time.perf_counter()
                x = api_fn(opt, **run_kwargs, timings=timings)
                torch.cuda.synchronize()
                total_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
            expect = int8_1chip_expected(cfgs[tag], STEPS_768_1CHIP)
            r = dict(config=os.path.basename(CFG_768_1CHIP_INT8ATTN if tag == "int8attn" else CFG_768_1CHIP),
                     text_encode_s=timings["text_encode_s"], step_s=timings["step_s"], total_s=total_s,
                     peak_mem_gb=peak_gb, launches=launches)
            if tag == "int8attn":
                latent, = rec.decoded
                grid = tile_grid(ae, latent.shape[3], latent.shape[4], decode=True)
                if grid != DECODE_TILES_768:
                    raise AssertionError(f"phase 32: decode tiles {grid} != {DECODE_TILES_768}")
                expect["flash_attention_fwd_d512"] = sum(grid.values())
                finite = bool(torch.isfinite(x).all())
                outside = float((x.abs() > 1.0).float().mean())
                r.update(video_shape=list(x.shape), decode_s=timings["decode_s"], outside_share=outside,
                         finite=finite, int8_attention_loops=dict(loops),
                         decode_tiles={f"{a}x{b}": n for (a, b), n in grid.items()})
                if tuple(x.shape) != (1, 3, opt.num_frames, opt.height, opt.width) or not finite \
                        or outside > OUTSIDE_MAX:
                    raise AssertionError(f"phase 32 video {tuple(x.shape)} finite={finite} outside={outside:.4f}")
            else:
                latent, = rec.latents
            latents[tag] = latent
            r["expected"] = expect
            r["latent_shape"] = list(latent.shape)
            res["runs"][tag] = r
            log(f"[768px_1chip] {tag}: " + json.dumps(r))
            del x
            if launches != expect:
                raise AssertionError(f"phase 32 ({tag}): launches {launches} != expected {expect}")
            check_peak(f"phase 32 ({tag})", peak_gb)
        if sum(loops.values()) != res["runs"]["int8attn"]["expected"]["int8_flash_attention"] * ATTN_768_B1[1]:
            raise AssertionError(f"phase 32: int8 attention loops {loops}: not one a head and launch")
        res["latent_int8_vs_bf16_attention_rel_l2"] = rel_l2(latents["int8attn"], latents["bf16attn"])
        if not all(bool(torch.isfinite(v).all()) for v in latents.values()):
            raise AssertionError("phase 32: a latent is not finite")
        res["peak_mem_gb"] = max(r["peak_mem_gb"] for r in res["runs"].values())
        log(f"[768px_1chip] peak device memory {res['peak_mem_gb']:.2f} GB (768px.py's bf16 batched CFG, phase 18: "
            f"read there); latents of the two attentions {res['latent_int8_vs_bf16_attention_rel_l2']:.3e} apart "
            "(relative L2)")
        set_attn_backend(model, cfg.model["attn_backend"])
        res["cfg_batched"] = check_cfg_batched(device, model, opt)
    finally:
        for m in quant:
            m.mode = base.model["quantized"]
        set_attn_backend(model, base.model["attn_backend"])
    del api_fn, latents
    free()
    res["gemm"] = check_int8_gemm_768px(device)
    res["int8_attention"] = check_int8_attention_768px(device, mufu_per_s)
    res["attention"] = check_attention_768px(device, ATTN_768_B1, ATTN_768_B1_PAIRS, tag="768px_1chip")
    return res


# ----------------------------------------------------------------------
# phases 33 and 34: image.py and stage1_i2v.py on phase 21's cell
# ----------------------------------------------------------------------

IMAGE_CFG = os.path.join(REPO, "configs", "diffusion", "train", "image.py")
STAGE1_I2V_CFG = os.path.join(REPO, "configs", "diffusion", "train", "stage1_i2v.py")
# seeded pngs, one file a size: image.py's buckets walk the resolutions from
# the highest down with keep draws (1024px 0.5, 768px 0.5, 256px 1.0), so a
# 1024 x 1024 image lands in any of the three, a 768 x 768 one in 768px or
# 256px, a 256 x 256 one in 256px
IMAGE_SIZES = ((1024, 1024), (768, 768), (256, 256))


def train_cfg_args(path: str) -> list:
    """``path`` (a child of stage1.py) at phase 21's depth and Adam settings
    (fsdp_cfg_args), as parse_configs arguments."""
    return [path, *fsdp_cfg_args()[1:]]


def image_table(root: str, bucket, seed: int) -> tuple:
    """Phase 33's table: rows of the seeded pngs (one file a size), each
    row's size picked, in row order, as the largest whose sampler draw (the
    seed of its row, as VariableVideoBatchSampler.group_by_bucket seeds it)
    lands it in a bucket still short of one batch, until each holds one.
    Returns (the csv's path, each row's intended resolution)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(33)
    files = {}
    for h, w in IMAGE_SIZES:
        files[(h, w)] = os.path.join(root, f"image_{h}x{w}.png")
        cv2.imwrite(files[(h, w)], rng.integers(0, 255, (h, w, 3), np.uint8))
    need = {res: bucket.get_batch_size((res, 1)) for res in bucket.bucket_bs}
    rows, landed = [], []
    while any(need.values()):
        i = len(rows)
        for h, w in IMAGE_SIZES:
            res = bucket.get_bucket_id(1, h, w, 0.0, seed=seed + i * bucket.num_bucket)[0]
            if need[res]:
                need[res] -= 1
                rows.append(f"{files[(h, w)]},a seeded still image {i},1,{h},{w},0.0")
                landed.append(res)
                break
        else:
            raise AssertionError(f"phase 33: no size lands row {i} in a bucket still short: {need}")
    path = os.path.join(root, "images.csv")
    with open(path, "w") as f:
        f.write("\n".join(["path,text,num_frames,height,width,fps", *rows]) + "\n")
    return path, landed


def masters_moved(state, start: dict) -> dict:
    """The share of the trained parameters' elements that differ from
    ``start`` (host tensors by name), the tensors equal to it, and those
    of them with two dimensions or more. At Adam's eps 1e-2 (TP_ADAM) an
    element moves by lr |g| / (|g| + eps), under the fp32 spacing of a norm's
    scale near 1 where |g| is below ~1e-5: a vector may stay whole, a weight
    matrix must move (but cond_in's under t2v alone, whose input is zero)."""
    changed = total = 0
    still = []
    for n, p in state.params.items():
        diff = int((p.detach() != start[n].to(p.device)).sum())
        changed, total = changed + diff, total + p.numel()
        if diff == 0:
            still.append(n)
    return dict(share=changed / total, still=still, still_matrices=[n for n in still if start[n].dim() >= 2])


def train_step_expected(n_blocks: int, d512: int) -> dict:
    """One step's launches: the D = 128 forward twice a block (forward and
    recompute), the fused backward and its dQ epilogue once, and ``d512``
    mid-block attentions in the encodes."""
    return {"flash_attention_fwd_sm90": 2 * n_blocks, "flash_attention_bwd_fused": n_blocks,
            "flash_attention_bwd_dq_convert": n_blocks, "flash_attention_fwd_d512": d512}


def run_image_train_path(device, carry: dict) -> dict:
    """Phase 33: configs/diffusion/train/image.py at phase 21's depth and
    Adam settings, from phase 21's saved state, through the training CLI's
    loader (VideoTextDataset over a table of seeded pngs, the config's
    bucket_config through prepare_dataloader) and Trainer.run_batch: one
    step per resolution at the config's batch sizes (256px B = 50, 768px
    B = 11, 1024px B = 7). Each row lands in the bucket the table meant
    (the sampler's draws), each batch is one bucket's single frames at its
    size; finite losses, every weight matrix moved but cond_in's
    (masters_moved), exact launches (the D = 128 kernels at (B, 24,
    tokens + 512, 128), one D = 512 encode a frame: the AE tiles nothing),
    each step's peak."""
    from opensora_torch.datasets.bucket import Bucket
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.datasets.datasets import VideoTextDataset
    from opensora_torch.ops import _build
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs

    cfg = parse_configs(train_cfg_args(IMAGE_CFG))
    check_same_models(cfg, carry["cfg"], ("model", "ae", "t5", "clip"), "image.py (against stage1.py)")
    n_blocks = carry["n_blocks"]
    log(f"[image] image.py at full width, depth {cfg.model['depth']}+{cfg.model['depth_single_blocks']}, from "
        f"phase 21's state; buckets {dict(cfg.bucket_config)}; condition_config {dict(cfg.condition_config)}")
    free()
    trainer = Trainer(cfg, device)
    trainer.state.load_state_dict(carry["snapshot"])
    root = tempfile.mkdtemp(prefix="chip_smoke_image_")
    try:
        t0 = time.perf_counter()
        bucket = Bucket(cfg.bucket_config, ae_spatial_compression(cfg))
        table, landed = image_table(root, bucket, cfg.seed)
        loader, sampler = prepare_dataloader(VideoTextDataset(table), bucket_config=cfg.bucket_config, seed=cfg.seed,
                                             spatial_compression=ae_spatial_compression(cfg), num_replicas=1, rank=0)
        groups = sampler.group_by_bucket()
        got = {i: bucket_id[0] for bucket_id, rows in groups.items() for i in rows}
        if [got.get(i) for i in range(len(landed))] != landed:
            raise AssertionError("phase 33: the sampler's buckets are not the table's")
        table_s = time.perf_counter() - t0
        steps = []
        for batch in loader:
            video = batch["video"]
            b, _, t, h, w = video.shape
            _build.LAUNCHES.clear()
            torch.cuda.reset_peak_memory_stats(device)  # each step's own peak
            t0 = time.perf_counter()
            m = trainer.run_batch(batch)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            times = trainer.timers.to_dict()
            tokens = (h // 16) * (w // 16)
            rec = dict(batch=b, frames=t, size=[h, w], image_tokens=tokens, loss=float(m["loss"]),
                       grad_norm=float(m["grad_norm"]), mask_conds=sorted(set(trainer.mask_conds)),
                       launches=dict(_build.LAUNCHES),
                       expected=train_step_expected(n_blocks, hunyuan_mid_launches(trainer.ae, (b, 3, t, h, w), False)),
                       encode_video_s=times["time/encode_video"], encode_text_s=times["time/encode_text"],
                       step_s=times["time/step"], total_s=total_s,
                       peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
            steps.append(rec)
            log(f"[image] {h}x{w} B={b}: " + json.dumps(rec))
        peak_gb = max((s["peak_mem_gb"] for s in steps), default=0.0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    moved = masters_moved(trainer.state, carry["snapshot"]["params"])
    n_params = len(trainer.state.params)
    res = dict(rows=len(landed), rows_by_bucket={r: landed.count(r) for r in sorted(set(landed))}, table_s=table_s,
               steps=steps, masters_moved=moved, masters=n_params, peak_mem_gb=peak_gb,
               launches={k: sum(s["launches"].get(k, 0) for s in steps) for k in steps[0]["expected"]} if steps else {})
    del trainer, loader, sampler
    free()
    want = sorted((bucket.get_batch_size(bid), *bucket.get_thw(bid)[1:]) for bid in groups)
    seen = sorted((s["batch"], *s["size"]) for s in steps)
    log(f"[image] {len(steps)} steps, batches {seen} (expected {want}); the masters' elements moved "
        f"{moved['share']:.6f}, tensors that did not {moved['still']} of {n_params}; peak {peak_gb:.2f} GB ("
        + ", ".join(f"{h}x{w} B={s['batch']}: {s['peak_mem_gb']:.2f} GB" for s in steps for h, w in [s["size"]]) + ")")
    if seen != want or sorted(bid[0] for bid in groups) != sorted(bucket.bucket_bs) \
            or any(s["frames"] != 1 for s in steps):
        raise AssertionError(f"phase 33: batches {seen}, expected one of each resolution: {want}")
    for s in steps:
        if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])) or s["launches"] != s["expected"] \
                or s["mask_conds"] != ["t2v"]:
            raise AssertionError(f"phase 33: step {s}")
    if moved["still_matrices"] != ["cond_in.weight"]:  # t2v alone: the visual condition is zero
        raise AssertionError(f"phase 33: weight matrices that did not move: {moved}")
    check_peak("image.py", peak_gb)
    return res


def i2v_draw_seed(condition_config: dict, batch: int, latent_t: int, time_compression: int) -> int:
    """The first seed of the trainer's host generator whose visual-condition
    draws for ``batch`` clips of ``latent_t`` latent frames include
    i2v_loop and i2v_tail (utils/train.choose_mask_conditions)."""
    import numpy as np

    from opensora_torch.utils.train import choose_mask_conditions

    for seed in range(1000):
        draws = choose_mask_conditions(dict(condition_config), batch, latent_t, time_compression,
                                       np.random.default_rng(seed))
        if "i2v_loop" in draws and "i2v_tail" in draws:
            return seed
    raise AssertionError("no seed below 1000 draws i2v_loop and i2v_tail")


def run_stage1_i2v_path(device, carry: dict) -> dict:
    """Phase 34: configs/diffusion/train/stage1_i2v.py at phase 21's depth
    and Adam settings, one step from phase 21's saved state on phase 21's
    batch (4 seeded 129 x 192 x 336 clips) through Trainer.run_batch, the
    host generator seeded by i2v_draw_seed so that the draws include
    i2v_loop and i2v_tail: finite loss, every weight matrix moved, exact launches (one
    D = 512 encode per clip and per single frame the conditions encode)."""
    import numpy as np

    from opensora_torch.ops import _build
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.train import single_frame_encodes

    cfg = parse_configs(train_cfg_args(STAGE1_I2V_CFG))
    check_same_models(cfg, carry["cfg"], ("model", "ae", "t5", "clip"), "stage1_i2v.py (against stage1.py)")
    n_blocks = carry["n_blocks"]
    batch = carry["batch"]
    b, _, frames = batch["video"].shape[:3]
    free()
    trainer = Trainer(cfg, device)
    trainer.state.load_state_dict(carry["snapshot"])
    tc = trainer.ae.config.time_compression_ratio
    seed = i2v_draw_seed(cfg.condition_config, b, (frames - 1) // tc + 1, tc)
    trainer.gen.set_state(carry["rng_states"][0])
    trainer.host_rng = np.random.default_rng(seed)
    log(f"[stage1_i2v] stage1_i2v.py at full width, depth {cfg.model['depth']}+{cfg.model['depth_single_blocks']}, "
        f"condition_config {dict(cfg.condition_config)}; host draws from seed {seed}")
    torch.cuda.reset_peak_memory_stats(device)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    m = trainer.run_batch(batch)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    times = trainer.timers.to_dict()
    conds = list(trainer.mask_conds)
    res = dict(draw_seed=seed, mask_conds=conds, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               launches=dict(_build.LAUNCHES), expected=train_step_expected(n_blocks, b + single_frame_encodes(conds)),
               encode_video_s=times["time/encode_video"], step_s=times["time/step"], total_s=total_s,
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    res["masters_moved"] = masters_moved(trainer.state, carry["snapshot"]["params"])
    res["masters"] = len(trainer.state.params)
    del trainer
    free()
    log("[stage1_i2v] " + json.dumps(res))
    if not ("i2v_loop" in conds and "i2v_tail" in conds) or not math.isfinite(res["loss"]) \
            or not math.isfinite(res["grad_norm"]) or res["launches"] != res["expected"] \
            or res["masters_moved"]["still_matrices"]:
        raise AssertionError(f"phase 34: {res}")
    check_peak("stage1_i2v.py", res["peak_mem_gb"])
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
    published unfused layout into 256px_int8attn.py's fused model, quantized
    at load, the HunyuanVAE, T5-XXL as a sharded
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
        # one load of the file: quantized at load into the fused model, it
        # also proves the unfused -> fused mapping (every tensor, the float
        # biases and norms among them, equal to quantize_model_ of the
        # in-memory weights)
        want_ae = checksums(ae.state_dict())
        quantize_model_(model, parse_configs([INT8_CFG]).model["quantized"])
        want_int8 = checksums(model.state_dict())
        del model, ae
        free()
        torch.cuda.reset_peak_memory_stats(device)
        cfg_q = parse_configs([INT8_CFG, "--model.from_pretrained", mmdit_path, "--ae.from_pretrained", vae_path])
        model, ae, t5, clip, _ = prepare_models(cfg_q, device=device, seed=cfg.seed)
        res["peak_mem_gb_int8_load"] = torch.cuda.max_memory_allocated(device) / 1e9
        del t5, clip
        compare_checksums("HunyuanVAE", checksums(ae.state_dict()), want_ae)
        del ae
        compare_checksums("MMDiT (unfused file) quantized at load vs quantize_model_ of the float weights",
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
HC_SIZE = (192, 320)  # the inference config's 256px 16:9 at its 32 px a token
HC_I2V_STEPS = 1  # i2v_head steps of phase 15
# The DC-AE halves each tile five times in space and twice in time, so a
# clip of 4k + 1 frames (a last temporal tile of 9) cannot be encoded, in
# the JAX package as here (ROADMAP Queue 3 R11); every size of the configs'
# 32-px sizing does (256px 16:9 is 192 x 320: tiles of 256 and 128 px;
# tests/test_torch_sizing.py encodes each 256px bucket). The training clip
# takes the 129-frame 256px bucket's 224 x 288 (4:3 at 32 px a token), its
# batch, and one frame less.
HC_TRAIN_FRAMES, HC_TRAIN_SIZE, HC_TRAIN_BATCH = 128, (224, 288), 3
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
    prepare_models and api_fn: t2v at the config's 192 x 320 (256px 16:9
    sized at the config's 32 px a token), 129 frames (32 x 6 x 10 latent
    tokens; decoded 128 x 192 x 320), HC_STEPS steps, then i2v_head for
    HC_I2V_STEPS from a seeded image of that size, its 3 padding frames
    trimmed. Checks shapes, finite videos, the
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
        f"{HC_I2V_STEPS} (i2v_head)")
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
    for cond_type, opt_over in (("t2v", {}), ("i2v_head", dict(num_steps=HC_I2V_STEPS))):
        opt = sanitize_sampling_option(SamplingOption(**dict(cfg.sampling_option, **opt_over)), compression)
        if (opt.height, opt.width) != HC_SIZE:
            raise AssertionError(f"{cond_type}: sized {opt.height} x {opt.width}, not {HC_SIZE} (32 px a token)")
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
        opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), compression)
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
    seeded HC_TRAIN_FRAMES x HC_TRAIN_SIZE clip, B = HC_TRAIN_BATCH. Then, from
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
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
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
    opt = sanitize_sampling_option(SamplingOption(**cfg.sampling_option), ae_spatial_compression(cfg))
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


# ----------------------------------------------------------------------
# phases 3h, 20 and 21: tensor parallelism and FSDP over logical ranks
# ----------------------------------------------------------------------

TP_CFG = os.path.join(REPO, "configs", "diffusion", "inference", "256px_tp.py")
STAGE1_CFG = os.path.join(REPO, "configs", "diffusion", "train", "stage1.py")
TP_RANKS = 4  # 256px_tp.py's tp_size=-1 over four logical ranks on the card
# Phase 3h's TP forwards against the card's unsharded bf16 forward on the
# same weights, relative L2 of the output: the tp ranks' partial products,
# each rounded to bf16, summed in fp32 and rounded once, where the
# unsharded product rounds once (an ulp, 2^-8, here and there at the 5
# row-parallel products; the max|difference| reads in whole ulps of the
# bf16 output: 1 right, 4-10 for the known-wrong variants in the first
# card run). Each known-wrong variant must exceed it; against the CPU's
# fp32 plain path they are held to SMALL_TOL, as phase 3
TP_FWD_TOL = 5e-3
# Phase 3h's forward model draws its biases with this standard deviation:
# nn.Linear's default init leaves them within 1/sqrt(fan_in) (0.008-0.018
# at full width), where a row bias added on every tp rank would move the
# output by less than the bf16 limit and pass unseen
TP_BIAS_STD = 0.05
# Phase 3h's train step, (2, 1, 2) with FSDP against the card's unsharded
# step from the same state, batch and draws, both bf16 with fp32 masters:
# the loss's and the gradient norm's relative difference, and the largest
# relative L2 difference of a master's change. The sharded step sums the
# tp ranks' partial products (each rounded to bf16) in fp32 and the data
# ranks' weight gradients (each a bf16 product over its rows) in fp32,
# where the unsharded step rounds one product: bf16 roundings (2^-8) in
# other places. The known-wrong variants move the loss (a data rank's rows
# twice) or the gradient norm (not divided by dp: 2x) far past these.
TP_TRAIN_LOSS_TOL = 5e-3
TP_TRAIN_NORM_TOL = 2e-2
TP_TRAIN_UPDATE_TOL = 5e-2
# Adam's eps and lr of phases 3h and 21: the update is then near linear in
# the clipped gradient (phase 3f's reasoning), so the masters' change
# compares gradients
TP_ADAM = dict(lr=1e-2, eps=1e-2)
# Phase 20: the final latent of 256px_tp.py over TP_RANKS ranks against
# phase 4's from the same seed, relative L2. Both bf16; the random-weight
# 57-block MMDiT carries the other rounding of the tp partial sums through
# 2 steps (the ring's video moved 0.047 from the dense one, phase 9)
TP_LATENT_TOL = 0.06
# Phase 21: stage1.py at depth 2 + 4 on 4 seeded 129-frame clips, the
# sharded steps against the unsharded step from one state
FSDP_BATCH = 4
FSDP_STEPS = 1  # timed FSDP steps after the comparison
FSDP_SIZE = (192, 336)  # the 129-frame 256px bucket at 16:9
FSDP_MESHES = (("dp2_tp2", (2, 1, 2)), ("fsdp4", (4, 1, 1)))


def fsdp_cfg_args() -> list:
    """Phase 21's configuration (stage1.py at HC_TRAIN_DEPTH, TP_ADAM, no
    warmup) as ``parse_configs`` arguments (phase 24's processes parse it
    too)."""
    depth, single = HC_TRAIN_DEPTH
    return [STAGE1_CFG, "--model.depth", str(depth), "--model.depth_single_blocks", str(single),
            "--warmup_steps", "0", "--lr", str(TP_ADAM["lr"]), "--adam_eps", str(TP_ADAM["eps"])]


def logical_mesh(device, sizes):
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(*sizes), [device] * math.prod(sizes))


def _contiguous_segments(name, shape, config):
    """Known-wrong: qkv, linear1, v_mlp and linear2 cut contiguously."""
    return None


def _bias_on_every_rank(linear, partials, group):
    """Known-wrong: the row bias added to every tp rank's partial."""
    from opensora_torch.parallel.comm import all_reduce

    bias = linear._placements.get("bias")
    return all_reduce([p + bias.local(group.data, t, p.dtype) for t, p in enumerate(partials)])


def _one_rank_rows_twice(n_rows, dp, d):
    """Known-wrong: every data rank reads data rank 0's rows."""
    return slice(0, n_rows // dp)


def _gradients_not_divided(losses):
    """Known-wrong: the global loss's value, the gradient of the data
    ranks' sum (FSDP gradients not divided by dp)."""
    stacked = torch.stack(losses)
    return stacked.mean().detach() + (stacked.sum() - stacked.sum().detach())


def check_tp_small_input(device) -> dict:
    """Phase 3h: the full-width MMDiT at 1 + 1 blocks on a small input over
    logical ranks on the card. The TP forward over (1, 1, 4) (the D = 128
    forward at 6 heads a rank) and a (1, 2, 2) forward with ``ring_rdma``
    (each tp coordinate's ring over its own sp group and heads), each
    against the CPU's unsharded fp32 plain path; one full-finetune step
    (stage1.py's model, fp32 masters) over (2, 1, 2) with FSDP against the
    card's unsharded step from the same state and draws. Known-wrong
    variants must fail: the fused axes cut contiguously, the row bias on
    every tp rank (forward); one data rank's rows twice, the gradients not
    divided by dp (step)."""
    import copy

    from opensora_torch.ops import _build
    from opensora_torch.parallel import data as pdata
    from opensora_torch.parallel import sharding as psh
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.registry import MODELS, build_module
    from opensora_torch.training import diffusion as tdiff
    from opensora_torch.utils.api import prepare_models  # noqa: F401  (registers the models)
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.optimizer import create_optimizer
    from opensora_torch.utils.sampling import build_img_ids

    cfg = parse_configs([TP_CFG])
    mcfg = dict(cfg.model, depth=1, depth_single_blocks=1)
    torch.manual_seed(0)
    card = build_module(dict(mcfg), MODELS, device=device).eval()
    with torch.no_grad():  # biases of TP_BIAS_STD (see there)
        bias_gen = torch.Generator(device=device).manual_seed(12)
        for name, p in card.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=bias_gen, device=device) * TP_BIAS_STD)
    cpu = build_module(dict(mcfg, dtype="fp32"), MODELS, device="meta").eval()
    cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()}, assign=True)
    gen = torch.Generator().manual_seed(11)
    b, lt = 3, 32
    img_ids = build_img_ids(2, 8, 12, bs=b)  # 48 image tokens: 80 with the text, 40 a rank under sp 2
    inputs = dict(
        img=torch.randn(b, 48, mcfg["in_channels"], generator=gen), img_ids=img_ids,
        txt=torch.randn(b, lt, mcfg["context_in_dim"], generator=gen), txt_ids=torch.zeros(b, lt, 3),
        timesteps=torch.rand(b, generator=gen), y_vec=torch.randn(b, mcfg["vec_in_dim"], generator=gen),
        cond=torch.zeros(b, 48, mcfg["in_channels"] + 4), guidance=torch.full((b,), 7.5),
    )
    with torch.inference_mode():
        ref = cpu(**inputs)
    del cpu
    on_card = {k: v.to(device) for k, v in inputs.items()}
    with torch.inference_mode():
        whole = card(**on_card).float().cpu()  # the card's unsharded bf16 forward
    variants = {"right": None, "contiguous_segments": (psh, "tp_segments", _contiguous_segments),
                "bias_on_every_tp_rank": (psh, "row_parallel", _bias_on_every_rank)}
    forwards = {}
    for sizes, backend, expect in (((1, 1, TP_RANKS), None, {"flash_attention_fwd_sm90": 2 * TP_RANKS}),
                                   ((1, 2, 2), "ring_rdma", {"ring_flash_fwd": 2 * 2 * 2 * 2})):
        mesh = logical_mesh(device, sizes)
        tag = "x".join(map(str, sizes)) + (f"_{backend}" if backend else "")
        for name, patch in variants.items():
            with contextlib.ExitStack() as stack:
                if patch is not None:
                    stack.enter_context(unittest.mock.patch.object(*patch))
                model = psh.shard_params(mesh, copy.deepcopy(card), fsdp=False)
                set_attn_backend(model, backend)
                set_mesh(mesh)
                _build.LAUNCHES.clear()
                try:
                    with torch.inference_mode(), RankTokens(model) as tokens:
                        out = model(**on_card)
                finally:
                    set_mesh(None)
                launches = dict(_build.LAUNCHES)
                if name == "right" and sizes[1] > 1:  # 80 tokens, 40 on each sp rank (both tp ranks)
                    forwards[f"{tag}_rank_tokens"] = tokens.check("small", sizes[1] * sizes[2], 80 * sizes[2])
                out = out.float().cpu()
                err = float((out - ref).abs().max() / ref.abs().max().clamp(min=1.0))
                forwards[f"{tag}_{name}_vs_unsharded_max"] = float((out - whole).abs().max() / whole.abs().max())
                forwards[f"{tag}_{name}_vs_unsharded"] = float((out - whole).norm() / whole.norm())
                del model, out
            forwards[f"{tag}_{name}"] = err
            if name == "right":
                forwards[f"{tag}_launches"] = launches
                if launches != expect:
                    raise AssertionError(f"3h {tag}: launches {launches} != expected {expect}")
    del card
    free()

    # one full-finetune step, unsharded and over (2, 1, 2) with FSDP
    tcfg = parse_configs([STAGE1_CFG])
    tmcfg = dict(tcfg.model, depth=1, depth_single_blocks=1, param_dtype="fp32")
    torch.manual_seed(1)
    base = build_module(tmcfg, MODELS, device=device)
    start = {k: v.detach().clone() for k, v in base.state_dict().items()}
    bt, t_, h_, w_ = 4, 2, 8, 12
    n_img = t_ * (h_ // 2) * (w_ // 2)
    bf = lambda *shape: torch.randn(shape, generator=gen).to(torch.bfloat16)  # noqa: E731
    batch = dict(x0=bf(bt, n_img, tmcfg["in_channels"]), img_ids=build_img_ids(t_, h_, w_, bs=bt),
                 txt=bf(bt, lt, tmcfg["context_in_dim"]), txt_ids=torch.zeros(bt, lt, 3),
                 y_vec=bf(bt, tmcfg["vec_in_dim"]), cond=bf(bt, n_img, tmcfg["in_channels"] + 4),
                 shift_alpha=torch.full((bt,), tdiff.compute_shift_alpha(h_, w_, t_)))
    batch = {k: v.to(device) for k, v in batch.items()}
    draws = dict(t=torch.rand(bt, generator=gen).to(device),
                 x1=torch.randn(bt, n_img, tmcfg["in_channels"], generator=gen).to(device))

    def step(mesh):
        model = copy.deepcopy(base).requires_grad_(True)
        state = tdiff.TrainState.create(model, create_optimizer(list(model.parameters()), grad_clip=1.0, **TP_ADAM))
        if mesh is not None:
            state = tdiff.shard_state(mesh, state, model, fsdp=True)
        _build.LAUNCHES.clear()
        m = tdiff.make_train_step(model, ema_decay=0.9)(state, dict(batch), draws=draws)
        launches = dict(_build.LAUNCHES)
        out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), launches=launches)
        if mesh is None:  # the reference change, on the card
            out["change"] = {n: p.float() - start[n] for n, p in trained_params(state)}
        else:
            out["update_rel_l2_max"] = max(update_rel_l2(state, start, ref_step["change"]).values())
        del model, state
        free()
        return out

    mesh = logical_mesh(device, (2, 1, 2))
    ref_step = step(None)
    steps = {}
    for name, patch in (("right", None), ("one_data_rank_rows_twice", (pdata, "row_slice", _one_rank_rows_twice)),
                        ("gradients_not_divided_by_dp", (tdiff, "data_mean", _gradients_not_divided))):
        with contextlib.ExitStack() as stack:
            if patch is not None:
                stack.enter_context(unittest.mock.patch.object(*patch))
            got = step(mesh)
        upd = got["update_rel_l2_max"]
        steps[name] = dict(loss_rel=abs(got["loss"] - ref_step["loss"]) / abs(ref_step["loss"]),
                           grad_norm_rel=abs(got["grad_norm"] - ref_step["grad_norm"]) / ref_step["grad_norm"],
                           update_rel_l2_max=upd, launches=got["launches"])
    del base, start, ref_step["change"]
    free()
    n_blk = 2
    expect_step = {"flash_attention_fwd_sm90": 2 * n_blk * 2 * 2, "flash_attention_bwd_fused": n_blk * 2 * 2,
                   "flash_attention_bwd_dq_convert": n_blk * 2 * 2}

    def within(r):
        return (r["loss_rel"] <= TP_TRAIN_LOSS_TOL and r["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and r["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL)

    res = dict(forward_rel_err=forwards, tol=SMALL_TOL, tol_vs_unsharded=TP_FWD_TOL, step=steps, step_ref=dict(
        loss=ref_step["loss"], grad_norm=ref_step["grad_norm"], launches=ref_step["launches"]),
        step_tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL, update=TP_TRAIN_UPDATE_TOL),
        step_launches_expected=expect_step)
    fwd_ok = all(forwards[f"{tag}_right"] <= SMALL_TOL and forwards[f"{tag}_right_vs_unsharded"] <= TP_FWD_TOL
                 < min(forwards[f"{tag}_contiguous_segments_vs_unsharded"],
                       forwards[f"{tag}_bias_on_every_tp_rank_vs_unsharded"])
                 for tag in (f"1x1x{TP_RANKS}", "1x2x2_ring_rdma"))
    step_ok = (within(steps["right"]) and not within(steps["one_data_rank_rows_twice"])
               and not within(steps["gradients_not_divided_by_dp"]) and steps["right"]["launches"] == expect_step)
    log(f"[small] TP / FSDP over logical ranks, full-width MMDiT depth 1+1: {json.dumps(res)} "
        f"{'OK' if fwd_ok and step_ok else 'FAIL'}")
    if not (fwd_ok and step_ok):
        raise AssertionError("phase 3h: the sharded paths disagree with the plain / unsharded paths, or a "
                             "known-wrong variant passed")
    return res


class LatentRecorder:
    """Records the latent each ``ae.decode`` call receives (on the host)."""

    def __init__(self, ae):
        self.ae, self.latents = ae, []

    def __enter__(self):
        decode = self.ae.decode

        def recording(z, *args, **kwargs):
            self.latents.append(z.detach().float().cpu())
            return decode(z, *args, **kwargs)

        self.ae.decode = recording
        return self

    def __exit__(self, *exc):
        del self.ae.decode
        return False


def allreduce_share(prof_out: dict) -> dict:
    """The all-reduce's device time (its ``record_function`` span) over the
    profiled run's device busy time."""
    span = prof_out.get("all_reduce_device_s")
    busy = sum(prof_out["kernel_s"].values())
    return dict(all_reduce_device_s=span, device_busy_s=busy,
                all_reduce_share=None if not span else span / busy)


def run_tp_path(device, built, profile: bool = False, out_dir=None) -> dict:
    """Phase 20: configs/diffusion/inference/256px_tp.py at full width and
    depth, its mesh (tp_size=-1) over TP_RANKS logical ranks on the card,
    through prepare_api(mesh=...) and api_fn on phase 4's models, the MMDiT
    sharded in place (the phases that need it whole ran before). 2 steps:
    the final latent against phase 4's from the same seed within
    TP_LATENT_TOL, exact launches (57 x TP_RANKS D = 128 forwards a step at
    6 heads a rank, 2 D = 512 in the decode), step seconds and the peak;
    with ``--profile`` the all-reduce's share of the device time."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.utils.api import prepare_api
    from opensora_torch.utils.config import parse_configs

    cfg = parse_configs([TP_CFG, "--sampling_option.num_steps", str(STEPS)])
    check_same_models(cfg, built["cfg"], ("model", "ae", "t5", "clip", "sampling_option"), "256px_tp.py")
    model, ae, t5, clip = built["models"]
    mesh = create_mesh(MeshConfig(**cfg.mesh), [device] * TP_RANKS)
    log(f"[tp] 256px_tp.py at full width and depth on phase 4's models, mesh {dict(cfg.mesh)} over {mesh}; "
        f"num_steps cut 50 -> {STEPS}")
    n_blocks = cfg.model["depth"] + cfg.model["depth_single_blocks"]
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        api_fn = prepare_api(model, ae, t5, clip, mesh=mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        resident_gb = torch.cuda.memory_allocated(device) / 1e9
        _build.LAUNCHES.clear()
        timings: dict = {}
        with LatentRecorder(ae) as rec:
            t0 = time.perf_counter()
            x = api_fn(**built["run_kwargs"], timings=timings)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        latent, dense = rec.latents[0], built["latent"]
        latent_rel = float((latent - dense).norm() / dense.norm())
        finite = bool(torch.isfinite(x).all())
        outside = float((x.abs() > 1.0).float().mean())
        video_rel = float((x.float().cpu() - built["video"]).norm() / built["video"].norm())
        shape = tuple(x.shape)
        del x
        prof = None
        if profile:
            prof = profile_run(lambda: api_fn(**built["run_kwargs"]), "tp", out_dir, spans=("all_reduce",))
    finally:
        set_mesh(None)
    expect = {"flash_attention_fwd_sm90": n_blocks * TP_RANKS * STEPS, "flash_attention_fwd_d512": 2}
    res = dict(mesh=repr(mesh), tp=model.sharding.tp, launches=launches, expected=expect, shard_s=shard_s,
               resident_gb_after_sharding=resident_gb, text_encode_s=timings["text_encode_s"],
               step_s=timings["step_s"], decode_s=timings["decode_s"], total_s=total_s, peak_mem_gb=peak_gb,
               latent_rel_l2_vs_phase4=latent_rel, tol=TP_LATENT_TOL, video_rel_l2_vs_phase4=video_rel,
               outside_share=outside, phase4_step_s=built["step_s"])
    if prof is not None:
        res["profile"] = dict(prof, **allreduce_share(prof))
    log("[tp] " + json.dumps(res))
    if shape != tuple(built["video"].shape) or not finite or outside > OUTSIDE_MAX:
        raise AssertionError(f"tp output {shape}, finite={finite}, outside [-1, 1]: {outside:.4f}")
    if launches != expect:
        raise AssertionError(f"tp launches {launches} != expected {expect}")
    if not latent_rel <= TP_LATENT_TOL:
        raise AssertionError(f"tp latent vs phase 4's: relative L2 {latent_rel:.4e} > {TP_LATENT_TOL}")
    check_peak("tp", peak_gb)
    return res


def run_fsdp_train_path(device, profile: bool = False, out_dir=None, carry=None) -> dict:
    """Phase 21: configs/diffusion/train/stage1.py, a full finetune (fp32
    masters, bf16 compute, remat "dots") at full width and HC_TRAIN_DEPTH
    blocks through Trainer.run_batch on FSDP_BATCH seeded 129-frame 192 x
    336 clips (Adam's lr and eps as TP_ADAM, no warmup). One step from one
    saved state, batch and generator state: by Trainer(cfg, device), then
    by Trainer(cfg, device, mesh=...) over (2, 1, 2) and (4, 1, 1), which
    shards the MMDiT with FSDP and loads the saved state with
    ``state.load_state_dict`` (which reshards it); one trainer on the card at
    a time. The sharded steps' loss, gradient norm and masters' change
    against the unsharded step's within the TP_TRAIN_* limits, exact
    launches. Then FSDP_STEPS more steps over (4, 1, 1): timed, finite,
    exact launches, the peak. ``carry`` (a dict), where given, receives
    the saved state, the batch, the generator states, the unsharded step's
    reading and its inputs (the batch as the step takes it, the generator
    state), for phases 22, 24, 27 and 28."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.train import single_frame_encodes

    depth, single = HC_TRAIN_DEPTH
    cfg = parse_configs(fsdp_cfg_args())
    n_blocks = depth + single
    log(f"[fsdp] stage1.py full finetune at full width, depth {depth}+{single}; one step unsharded, over "
        f"{[s for _, s in FSDP_MESHES]} from one state, then {FSDP_STEPS} FSDP steps; B={FSDP_BATCH}, "
        f"{TRAIN_FRAMES} frames at 192x336")
    free()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = seeded_clips(device, cfg.seed)
    snapshot = _tree_to(trainer.state.state_dict(), "cpu")
    start = snapshot["params"]
    n_params = sum(v.numel() for v in start.values())
    rng_states = trainer.gen.get_state(), dict(trainer.host_rng.bit_generator.state)
    build_s_sharded = {}  # per mesh: Trainer(mesh=...) and the resharding load

    def expected(sizes):
        dp, _, tp = sizes
        ranks = dp * tp
        return {"flash_attention_fwd_sm90": 2 * n_blocks * ranks, "flash_attention_bwd_fused": n_blocks * ranks,
                "flash_attention_bwd_dq_convert": n_blocks * ranks,
                "flash_attention_fwd_d512": FSDP_BATCH + single_frame_encodes(trainer.mask_conds)}

    def one(trainer, tag, record=None):
        trainer.gen.set_state(rng_states[0])
        trainer.host_rng.bit_generator.state = rng_states[1]
        if record is not None:  # the step's inputs (phase 28 takes the step on them)
            step = trainer.train_step

            def recorded(state, tb, gen):
                record.update(tb=tb, gen_state=gen.get_state())
                return step(state, tb, gen)

            trainer.train_step = recorded
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        m = trainer.run_batch(batch)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), launches=dict(_build.LAUNCHES),
                   step_s=trainer.timers.to_dict()["time/step"], total_s=total_s, mask_conds=trainer.mask_conds,
                   allocated_gb=torch.cuda.memory_allocated(device) / 1e9)
        log(f"[fsdp] {tag}: " + json.dumps(rec))
        return rec

    step_inputs = {}
    runs = {"unsharded": one(trainer, "unsharded", step_inputs)}
    runs["unsharded"]["expected"] = expected((1, 1, 1))
    step_inputs["tb"] = _tree_to(step_inputs["tb"], "cpu")
    ref_change = {n: p.float().cpu() - start[n] for n, p in trainer.state.state_dict()["params"].items()}
    # the comparisons run on the card
    start_d, ref_change_d = _tree_to(start, device), _tree_to(ref_change, device)
    cmp = {}
    try:
        for tag, sizes in FSDP_MESHES:
            trainer = None
            free()
            t0 = time.perf_counter()
            trainer = Trainer(cfg, device, mesh=logical_mesh(device, sizes))
            trainer.state.load_state_dict(snapshot)
            torch.cuda.synchronize()
            build_s_sharded[tag] = time.perf_counter() - t0
            runs[tag] = one(trainer, tag)
            runs[tag]["expected"] = expected(sizes)
            upd = update_rel_l2(trainer.state, start_d, ref_change_d)
            worst = max(upd, key=upd.get)
            ref = runs["unsharded"]
            cmp[tag] = dict(loss_rel=abs(runs[tag]["loss"] - ref["loss"]) / abs(ref["loss"]),
                            grad_norm_rel=abs(runs[tag]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                            update_rel_l2_max=upd[worst], update_rel_l2_worst=worst,
                            update_rel_l2_median=sorted(upd.values())[len(upd) // 2],
                            same_mask_conds=runs[tag]["mask_conds"] == runs["unsharded"]["mask_conds"])
        del start_d, ref_change_d
        log("[fsdp] sharded vs unsharded from one state: " + json.dumps(cmp))
        if carry is not None:
            carry.update(cfg=cfg, snapshot=snapshot, start=start, batch=batch, rng_states=rng_states,
                         ref=runs["unsharded"], ref_change=ref_change, n_blocks=n_blocks, step_inputs=step_inputs)
        del ref_change, snapshot
        steps = []
        phase_peak_gb = torch.cuda.max_memory_allocated(device) / 1e9  # the three steps from the saved state
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(FSDP_STEPS):
            steps.append(one(trainer, f"fsdp4 step {i + 2}"))
            steps[-1]["expected"] = expected(FSDP_MESHES[-1][1])
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        prof = profile_run(lambda: trainer.run_batch(batch), "fsdp", out_dir) if profile else None
    finally:
        set_mesh(None)
    res = dict(depth=[depth, single], params=n_params, models_build_s=build_s, sharded_build_and_load_s=build_s_sharded,
               runs=runs, sharded_vs_unsharded=cmp,
               tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL, update=TP_TRAIN_UPDATE_TOL),
               fsdp_steps=steps, peak_mem_gb=peak_gb, peak_mem_gb_compared_steps=phase_peak_gb,
               launches={k: sum(r["launches"].get(k, 0) for r in steps) for k in steps[0]["expected"]})
    if prof is not None:
        res["profile"] = prof
    del trainer, batch
    free()
    log(f"[fsdp] {FSDP_STEPS} FSDP steps: losses {[r['loss'] for r in steps]}, step_s "
        f"{[round(r['step_s'], 3) for r in steps]}, peak_mem_gb={peak_gb:.2f}")
    for tag, rec in list(runs.items()) + [(f"fsdp4 step {i + 2}", r) for i, r in enumerate(steps)]:
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"fsdp {tag}: loss {rec['loss']} or grad norm {rec['grad_norm']} not finite")
        if rec["launches"] != rec["expected"]:
            raise AssertionError(f"fsdp {tag}: launches {rec['launches']} != expected {rec['expected']}")
    for tag, c in cmp.items():
        if not (c["same_mask_conds"] and c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL):
            raise AssertionError(f"fsdp {tag} vs the unsharded step: {c}")
    check_peak("fsdp", max(peak_gb, phase_peak_gb))
    return res


def trained_params(state):
    """The trained parameters by unsharded name, each whole where its first
    leaf lies (a sharded state's gathered there: no host copy)."""
    if state.sharding is None:
        return ((n, p.detach()) for n, p in state.params.items())
    leaves = list(state.params.values())
    return ((name, pl.gather([leaves[j].detach() for j in idx])) for name, pl, idx in state._layout())


def update_rel_l2(state, start: dict, ref_change: dict) -> dict:
    """Per trained parameter, the relative L2 of its change from ``start``
    against ``ref_change`` (both by unsharded name, on the card), one
    parameter at a time."""
    out = {}
    for n, p in trained_params(state):
        c = ref_change[n].to(p.device)
        out[n] = float((p.float() - start[n].to(p.device) - c).norm() / c.norm().clamp(min=1e-30))
    return out


def seeded_clips(device, seed: int) -> dict:
    """Phase 21's batch: FSDP_BATCH seeded clips of TRAIN_FRAMES x FSDP_SIZE
    in [-1, 1] and their prompts."""
    gen = torch.Generator(device=device).manual_seed(seed)
    video = torch.rand((FSDP_BATCH, 3, TRAIN_FRAMES, *FSDP_SIZE), generator=gen, device=device) * 2 - 1
    return {"video": video, "text": ["a red panda eating bamboo in a misty forest",
                                     "waves breaking on a rocky shore at sunset",
                                     "a city street at night in the rain, neon signs",
                                     "a hot air balloon over a desert canyon at dawn"]}


# Phase 25: lora.py (r = 128, alpha 128, the default targets) on phase 21's
# cell through Trainer(cfg, device, mesh=...) over logical ranks, one step
# each from the unsharded LoRA trainer's state after one step (lora_B off
# zero, so a wrong merge moves the forward), against the unsharded step:
# loss and norm within phase 21's limits (TP_TRAIN_LOSS_TOL,
# TP_TRAIN_NORM_TOL: the same bf16 roundings in other places), each
# factor's change within LORA_UPDATE_TOL in relative L2. The unsharded step
# taken twice from one state differs by the D = 128 backward's dQ sum
# (reduce-adds in arrival order): its worst factor change read 1.4e-3 apart
# in the first card run (NVIDIA H100 80GB HBM3, 700 W), the sharded steps
# 3.1e-3-3.2e-3 (their bf16 partial sums add roundings), the contiguous
# control 0.68. The limit is about 14 times the run-to-run spread; the
# spread is read again in every run and must stay under it.
LORA_SHARDED_MESHES = (("dp2_tp2", (2, 1, 2)), ("fsdp4", (4, 1, 1)))
LORA_UPDATE_TOL = 0.02


def lora_sharded_cfg_args() -> list:
    """Phase 25's configuration: lora.py at HC_TRAIN_DEPTH with random
    weights, TP_ADAM, no warmup."""
    depth, single = HC_TRAIN_DEPTH
    return [LORA_CFG, "--model.from_pretrained", "", "--ae.from_pretrained", "", "--model.depth", str(depth),
            "--model.depth_single_blocks", str(single), "--warmup_steps", "0", "--lr", str(TP_ADAM["lr"]),
            "--adam_eps", str(TP_ADAM["eps"])]


def _contiguous_lora_b(right):
    """Known-wrong: lora_B's rows cut as one contiguous block per tp rank,
    where the fused weights' rows are cut per segment."""
    def cut(placement, a, b):
        if placement.tp_dim == 0:
            from opensora_torch.parallel.context import get_scope

            return a, b.chunk(placement.sharding.tp, 0)[get_scope()[1]]
        return right(placement, a, b)
    return cut


def run_lora_sharded_path(device, root: str) -> dict:
    """Phase 25: LoRA over a sharded mesh. The unsharded LoRA trainer takes
    one step, then the compared step from its saved state twice (the
    run-to-run spread); Trainer(mesh=...) over each of LORA_SHARDED_MESHES
    (the frozen base FSDP / TP-cut, the factors replicated) loads that state
    and takes the step: loss, norm, each factor's change against the
    unsharded step's, exact launches, step seconds and the peak. Over (2, 1,
    2) a known-wrong factor cut must fail the limits, and the sharded
    trainer's checkpoint (CheckpointIO) loads into the unsharded trainer
    bitwise."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.train import Trainer
    from opensora_torch.training import lora
    from opensora_torch.utils.ckpt import CheckpointIO
    from opensora_torch.utils.config import parse_configs
    from opensora_torch.utils.train import single_frame_encodes

    depth, single = HC_TRAIN_DEPTH
    cfg = parse_configs(lora_sharded_cfg_args())
    n_blocks = depth + single
    log(f"[lora_sharded] lora.py (r={cfg.lora_config['r']}) at full width, depth {depth}+{single}; one step "
        f"unsharded, then the compared step unsharded twice and over {[s for _, s in LORA_SHARDED_MESHES]}; "
        f"B={FSDP_BATCH}, {TRAIN_FRAMES} frames at {FSDP_SIZE[0]}x{FSDP_SIZE[1]}")
    free()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ref_trainer = Trainer(cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = seeded_clips(device, cfg.seed)
    ref_trainer.run_batch(batch)  # lora_B moves off zero
    snapshot = _tree_to(ref_trainer.state.state_dict(), "cpu")
    start = snapshot["params"]
    rng_states = ref_trainer.gen.get_state(), dict(ref_trainer.host_rng.bit_generator.state)

    def expected(sizes):
        ranks = sizes[0] * sizes[2]
        return {"flash_attention_fwd_sm90": 2 * n_blocks * ranks, "flash_attention_bwd_fused": n_blocks * ranks,
                "flash_attention_bwd_dq_convert": n_blocks * ranks,
                "flash_attention_fwd_d512": FSDP_BATCH + single_frame_encodes(ref_trainer.mask_conds)}

    def one(trainer, tag, sizes):
        # a copy: AdamW keeps the loaded step counts (host tensors) and
        # moments where they lie, and adds to them in place
        trainer.state.load_state_dict(_tree_to(snapshot, "cpu"))
        trainer.gen.set_state(rng_states[0])
        trainer.host_rng.bit_generator.state = rng_states[1]
        torch.cuda.reset_peak_memory_stats(device)
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        m = trainer.run_batch(batch)
        torch.cuda.synchronize()
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), launches=dict(_build.LAUNCHES),
                   expected=expected(sizes), step_s=trainer.timers.to_dict()["time/step"],
                   total_s=time.perf_counter() - t0, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        change = {n: p.float().cpu() - start[n] for n, p in trainer.state.state_dict()["params"].items()}
        log(f"[lora_sharded] {tag}: " + json.dumps(rec))
        return rec, change

    def against(rec, change, ref_rec, ref_change):
        upd = {n: float((change[n] - c).norm() / c.norm().clamp(min=1e-30)) for n, c in ref_change.items()}
        worst = max(upd, key=upd.get)
        return dict(loss_rel=abs(rec["loss"] - ref_rec["loss"]) / abs(ref_rec["loss"]),
                    grad_norm_rel=abs(rec["grad_norm"] - ref_rec["grad_norm"]) / ref_rec["grad_norm"],
                    update_rel_l2_max=upd[worst], update_rel_l2_worst=worst)

    def within(c):
        return (c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= LORA_UPDATE_TOL)

    runs, cmp = {}, {}
    ref, ref_change = one(ref_trainer, "unsharded", (1, 1, 1))
    runs["unsharded"] = ref
    again, again_change = one(ref_trainer, "unsharded again", (1, 1, 1))
    cmp["unsharded_again"] = against(again, again_change, ref, ref_change)
    ckpt = {}
    try:
        for tag, sizes in LORA_SHARDED_MESHES:
            free()
            t0 = time.perf_counter()
            trainer = Trainer(cfg, device, mesh=logical_mesh(device, sizes))
            torch.cuda.synchronize()
            build_sharded_s = time.perf_counter() - t0
            runs[tag], change = one(trainer, tag, sizes)
            runs[tag]["build_s"] = build_sharded_s
            runs[tag]["factor_placement"] = sorted({str(pl.spec) for n, pl in trainer.model.sharding.placements.items()
                                                    if "lora_" in n})
            cmp[tag] = against(runs[tag], change, ref, ref_change)
            if sizes[2] > 1:
                d = CheckpointIO().save(os.path.join(root, "lora_sharded"), trainer.state, 0, 1, 1)
                saved = torch.load(os.path.join(d, "state.pt"), map_location="cpu", weights_only=False)
                CheckpointIO().load(d, ref_trainer.state)
                mine = ref_trainer.state.state_dict()
                moments = mine["optimizer"]["adamw"]["state"]
                ckpt = dict(file_gb=file_bytes(os.path.join(d, "state.pt")) / 1e9, tensors=len(saved["params"]),
                            params_equal=all(torch.equal(mine["params"][n].cpu(), p) for n, p in saved["params"].items()),
                            moments_equal=all(torch.equal(moments[i][k].cpu(), st[k])
                                              for i, st in saved["optimizer"]["adamw"]["state"].items()
                                              for k in ("exp_avg", "exp_avg_sq")),
                            ema=saved["ema"])
                del saved, mine, moments
                shutil.rmtree(d)
                with patched(lora, "rank_factors", _contiguous_lora_b):
                    control, control_change = one(trainer, f"{tag} contiguous lora_B control", sizes)
                cmp[f"{tag}_contiguous_control"] = against(control, control_change, ref, ref_change)
            trainer = None
            set_mesh(None)
    finally:
        set_mesh(None)
    del ref_trainer, batch
    free()
    res = dict(depth=[depth, single], rank=cfg.lora_config["r"], factors=sum(v.numel() for v in start.values()),
               models_build_s=build_s, runs=runs, against_unsharded=cmp, checkpoint=ckpt,
               tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL, update=LORA_UPDATE_TOL))
    log("[lora_sharded] against the unsharded step: " + json.dumps(cmp))
    for tag, rec in runs.items():
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"lora_sharded {tag}: loss {rec['loss']} or grad norm {rec['grad_norm']} not finite")
        if rec["launches"] != rec["expected"]:
            raise AssertionError(f"lora_sharded {tag}: launches {rec['launches']} != expected {rec['expected']}")
        check_peak(f"lora_sharded {tag}", rec["peak_mem_gb"])
    for tag, c in cmp.items():
        if within(c) == tag.endswith("_control"):
            raise AssertionError(f"lora_sharded {tag} vs the unsharded step: {c} (a control must fail the limits)")
    if not (ckpt.get("params_equal") and ckpt.get("moments_equal") and ckpt.get("ema") is None):
        raise AssertionError(f"lora_sharded: the sharded checkpoint did not load into the unsharded trainer "
                             f"bitwise: {ckpt}")
    return res


def lora_sharded_launches(res: dict, kernel: str) -> dict:
    """Phase 25's launches of ``kernel`` per step, by run."""
    return {tag: r["launches"].get(kernel, 0) for tag, r in res["runs"].items()}


def fsdp_launches(res: dict, kernel: str) -> dict:
    """Phase 21's launches of ``kernel``: each step from the saved state and
    the FSDP steps' sum."""
    return dict({tag: r["launches"].get(kernel, 0) for tag, r in res["runs"].items()},
                fsdp4_steps=res["launches"].get(kernel, 0))


# Phase 22: stage1.py at depth 2 + 4 (which divides by pp 2) through
# Trainer(cfg, device, mesh=create_pp_mesh(...)) over logical ranks, one step
# each from phase 21's saved state, batch and generator state, held to the
# TP_TRAIN_* limits against phase 21's unsharded step: (tag, (pp, data, tp),
# n_micro)
PP_MESHES = (("pp2_dp2", (2, 2, 1), 2), ("pp2_tp2", (2, 1, 2), 4))


def pp_launches(res: dict, kernel: str) -> dict:
    """Phase 22's launches of ``kernel``, per mesh."""
    return {tag: r["launches"].get(kernel, 0) for tag, r in res["runs"].items()}


def _stage2_neighbour_microbatch(apply):
    """Known-wrong (pp = 2): in the double-stream pipeline the last stage
    runs on the neighbouring microbatch's activation, (m + 1) mod n_micro
    (in both pipelines, n_micro = 2 would undo the swap)."""
    from opensora_torch.parallel import pipeline as pl

    calls = []

    def wrong(stage_fn, stages, x_mb, mesh, axis="pp", **kw):
        calls.append(1)
        if len(calls) > 1:
            return apply(stage_fn, stages, x_mb, mesh, axis, **kw)
        out = []
        for d, row in enumerate(x_mb):
            sent = [pl.send_activation(stage_fn(stages[0], a, d, 0), pl.stage_devices(mesh, d, 1, axis)) for a in row]
            out.append([pl.broadcast_activation(stage_fn(stages[1], sent[(m + 1) % len(row)], d, 1), mesh, d, 1,
                                                axis) for m in range(len(row))])
        return out

    return wrong


def _last_stage_skipped(apply):
    """Known-wrong: the last stage's blocks are not run."""
    return lambda stage_fn, stages, x_mb, mesh, axis="pp", **kw: apply(stage_fn, list(stages[:-1]) + [[]], x_mb,
                                                                        mesh, axis, **kw)


class CopyTimer:
    """CUDA events around every ``parallel/comm.copy_to`` while open: the
    stage-to-stage sends and their reverse copies in the backward; their
    device time and bytes."""

    def __init__(self):
        self.events, self.bytes = [], 0

    def __enter__(self):
        from opensora_torch.parallel import comm

        copy_to = comm.copy_to

        def timed(x, device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = copy_to(x, device)
            end.record()
            self.events.append((start, end))
            self.bytes += x.numel() * x.element_size()
            return out

        self.patch = unittest.mock.patch.object(comm, "copy_to", timed)
        self.patch.__enter__()
        return self

    def __exit__(self, *exc):
        self.patch.__exit__(*exc)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def run_pp_train_path(device, carry: dict) -> dict:
    """Phase 22: GPipe over logical ranks on the card. stage1.py's full
    finetune at full width and phase 21's depth, by Trainer(cfg, device,
    mesh=create_pp_mesh(...)) with a ``pipeline`` key, over each of
    PP_MESHES: phase 21's saved state loaded (resharded by stage), one step
    on phase 21's batch from its generator states, timed, against phase
    21's unsharded step within the TP_TRAIN_* limits; exact launches (2 *
    blocks * n_micro * data * tp forwards with remat, blocks * n_micro *
    data * tp fused backwards and dQ epilogues; the VAE encode's D = 512
    forwards as phase 21's), the stage-to-stage copies' device time and
    bytes (CUDA events around each copy), the peak. On the first mesh two
    known-wrong pipelines rerun the step from the saved state on the same
    step inputs and must fail the limits: the last stage fed the
    neighbouring microbatch, the last stage's blocks skipped."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import create_pp_mesh
    from opensora_torch.train import Trainer, pipeline_mesh
    from opensora_torch.training import pp as pp_mod
    from opensora_torch.utils.config import Config

    ref, ref_change, start, snapshot = carry["ref"], carry["ref_change"], carry["start"], carry["snapshot"]
    n_blocks = carry["n_blocks"]
    log(f"[pp] stage1.py at full width, {n_blocks} blocks, GPipe over {[(t, s, n) for t, s, n in PP_MESHES]} "
        f"(pp, data, tp), n_micro; one step each from phase 21's state, B={FSDP_BATCH}")

    start_d, ref_change_d = _tree_to(start, device), _tree_to(ref_change, device)  # the comparisons on the card

    def compare(trainer, m) -> dict:
        upd = update_rel_l2(trainer.state, start_d, ref_change_d)
        worst = max(upd, key=upd.get)
        return dict(loss_rel=abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"]),
                    grad_norm_rel=abs(float(m["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                    update_rel_l2_max=upd[worst], update_rel_l2_worst=worst,
                    update_rel_l2_median=sorted(upd.values())[len(upd) // 2])

    def held(c) -> bool:
        return (c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL)

    runs, controls = {}, {}
    trainer = None
    try:
        for tag, (pp, data, tp), n_micro in PP_MESHES:
            trainer = None
            free()
            torch.cuda.reset_peak_memory_stats(device)
            cfg = Config(carry["cfg"], pipeline=dict(pp_size=pp, tp_size=tp, data_size=data, n_micro=n_micro))
            mesh = create_pp_mesh(pp, data, tp, [device] * (pp * data * tp))
            if pipeline_mesh(cfg, device).devices != mesh.devices:
                raise AssertionError(f"pp {tag}: the CLI's mesh {pipeline_mesh(cfg, device)} is not {mesh}")
            t0 = time.perf_counter()
            trainer = Trainer(cfg, device, mesh=mesh)
            trainer.state.load_state_dict(snapshot)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            trainer.gen.set_state(carry["rng_states"][0])
            trainer.host_rng.bit_generator.state = carry["rng_states"][1]
            seen = {}
            step = trainer.train_step

            def recorded(state, tb, gen):  # the step's inputs, for the controls
                seen.update(tb=tb, gen_state=gen.get_state())
                return step(state, tb, gen)

            trainer.train_step = recorded
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            with CopyTimer() as copies:
                m = trainer.run_batch(carry["batch"])
                torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            rec = dict(mesh=dict(mesh.shape), n_micro=n_micro, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       launches=dict(_build.LAUNCHES), step_s=trainer.timers.to_dict()["time/step"],
                       total_s=total_s, build_and_load_s=build_s, mask_conds=trainer.mask_conds,
                       copies=dict(n=len(copies.events), bytes=copies.bytes, device_ms=copies.ms()),
                       peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
            rec["copies"]["share_of_step"] = rec["copies"]["device_ms"] / 1e3 / rec["step_s"]
            ranks = n_micro * data * tp
            rec["expected"] = {"flash_attention_fwd_sm90": 2 * n_blocks * ranks,
                               "flash_attention_bwd_fused": n_blocks * ranks,
                               "flash_attention_bwd_dq_convert": n_blocks * ranks,
                               "flash_attention_fwd_d512": ref["expected"]["flash_attention_fwd_d512"]}
            rec["vs_unsharded"] = compare(trainer, m)
            rec["vs_unsharded"]["same_mask_conds"] = trainer.mask_conds == ref["mask_conds"]
            log(f"[pp] {tag}: " + json.dumps(rec))
            runs[tag] = rec
            if tag == PP_MESHES[0][0]:
                for name, wrap in (("stage2_neighbour_microbatch", _stage2_neighbour_microbatch),
                                   ("last_stage_skipped", _last_stage_skipped)):
                    trainer.state.load_state_dict(snapshot)
                    gen = torch.Generator(device=device)
                    gen.set_state(seen["gen_state"])
                    with patched(pp_mod, "pipeline_apply", wrap):
                        m = step(trainer.state, seen["tb"], gen)
                    controls[name] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                          **compare(trainer, m))
                    log(f"[pp] control {name}: " + json.dumps(controls[name]))
                del seen
    finally:
        set_mesh(None)
        trainer = start_d = ref_change_d = None
        free()
    for tag, rec in runs.items():
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"pp {tag}: loss {rec['loss']} or grad norm {rec['grad_norm']} not finite")
        if rec["launches"] != rec["expected"]:
            raise AssertionError(f"pp {tag}: launches {rec['launches']} != expected {rec['expected']}")
        if not (rec["vs_unsharded"]["same_mask_conds"] and held(rec["vs_unsharded"])):
            raise AssertionError(f"pp {tag} vs the unsharded step: {rec['vs_unsharded']}")
        check_peak(f"pp {tag}", rec["peak_mem_gb"])
    for name, c in controls.items():
        if held(c):
            raise AssertionError(f"pp control {name} passed the limits: {c}")
    return dict(depth=[n_blocks], runs=runs, controls=controls,
                tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL, update=TP_TRAIN_UPDATE_TOL),
                launches={k: sum(r["launches"].get(k, 0) for r in runs.values()) for k in runs[PP_MESHES[0][0]]["expected"]})


# Phase 27: configs/diffusion/train/stage2.py (sp 4, seq_align 4, remat
# "offload", the default attention) on phase 21's cell (2 + 4 blocks, 4
# seeded 129 x 192 x 336 clips: 512 + 8316 tokens, which need no seq_align
# padding, the lr / eps overrides), through Trainer(cfg, device, mesh=...)
# over stage2's own mesh (SP_MESHES' None: the config's (dp -1, sp 4) over 4
# logical ranks) and over (2, 2, 1) with FSDP: one timed step each from
# phase 21's saved state, batch and generator states, held to phase 21's
# TP_TRAIN_* limits against its unsharded step (stage1.py: "offload"
# recomputes what "dots" keeps, the same math); the control leaves the last
# sp rank's image chunk out of the gathered output and must fail them
STAGE2_CFG = os.path.join(REPO, "configs", "diffusion", "train", "stage2.py")
SP_MESHES = (("sp4", None), ("dp2_sp2", (2, 2, 1)))


def stage2_cfg_args() -> list:
    """Phase 27's configuration: stage2.py with phase 21's overrides."""
    return [STAGE2_CFG, *fsdp_cfg_args()[1:]]


def _last_chunk_left_out(chunks):
    """Known-wrong: the last sp rank's image chunk left out of the gathered
    output (zeros in its place)."""
    def wrong(self, fn):
        out = chunks(self, fn)
        return out[:-1] + [torch.zeros_like(out[-1])]

    return wrong


def sp_train_launches(res: dict, kernel: str) -> dict:
    """Phase 27's launches of ``kernel``, per mesh."""
    return {tag: r["launches"].get(kernel, 0) for tag, r in res["runs"].items()}


def run_sp_train_path(device, carry: dict) -> dict:
    """Phase 27 (see SP_MESHES): per mesh, Trainer(cfg, device, mesh=...)
    for stage2.py, phase 21's saved state loaded (placed over the mesh), one
    step on phase 21's batch from its generator states, timed, against
    phase 21's unsharded step within the TP_TRAIN_* limits; exact launches
    (the default attention gathers each data rank's sp group for one flash
    call a block: 2 * blocks * dp forwards with the recompute, blocks * dp
    fused backwards and dQ epilogues; the VAE encode's D = 512 forwards as
    phase 21's); each rank's tokens and residual bytes; the peak. On the
    first mesh the control reruns the step from the saved state on the same
    step inputs and must fail the limits."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel import sharding as psh
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.train import Trainer
    from opensora_torch.utils.config import parse_configs

    cfg = parse_configs(stage2_cfg_args())
    ref, ref_change, start, snapshot = carry["ref"], carry["ref_change"], carry["start"], carry["snapshot"]
    n_blocks = carry["n_blocks"]
    log(f"[sp_train] stage2.py (remat {cfg.model['remat_policy']}, seq_align {cfg.seq_align}) at full width, "
        f"{n_blocks} blocks, over {[(t, s or cfg.mesh) for t, s in SP_MESHES]}; one step each from phase 21's "
        f"state, B={FSDP_BATCH}")
    start_d, ref_change_d = _tree_to(start, device), _tree_to(ref_change, device)

    def compare(trainer, m) -> dict:
        upd = update_rel_l2(trainer.state, start_d, ref_change_d)
        worst = max(upd, key=upd.get)
        return dict(loss_rel=abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"]),
                    grad_norm_rel=abs(float(m["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                    update_rel_l2_max=upd[worst], update_rel_l2_worst=worst,
                    update_rel_l2_median=sorted(upd.values())[len(upd) // 2])

    def held(c) -> bool:
        return (c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL)

    runs, controls = {}, {}
    trainer = None
    try:
        for tag, sizes in SP_MESHES:
            trainer = None
            free()
            torch.cuda.reset_peak_memory_stats(device)
            mesh = (create_mesh(MeshConfig(**cfg.mesh), [device] * RING_SP) if sizes is None
                    else logical_mesh(device, sizes))
            t0 = time.perf_counter()
            trainer = Trainer(cfg, device, mesh=mesh)
            trainer.state.load_state_dict(snapshot)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            trainer.gen.set_state(carry["rng_states"][0])
            trainer.host_rng.bit_generator.state = carry["rng_states"][1]
            seen = {}
            step = trainer.train_step

            def recorded(state, tb, gen):  # the step's inputs, for the control
                seen.update(tb=tb, gen_state=gen.get_state())
                return step(state, tb, gen)

            trainer.train_step = recorded
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            with RankTokens(trainer.model) as tokens:
                m = trainer.run_batch(carry["batch"])
                torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            dp, sp = mesh.shape["data"], mesh.shape["sp"]
            rec = dict(mesh=dict(mesh.shape), loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       launches=dict(_build.LAUNCHES), step_s=trainer.timers.to_dict()["time/step"],
                       unsharded_step_s=ref["step_s"], total_s=total_s, build_and_load_s=build_s,
                       mask_conds=trainer.mask_conds, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
            rec["ranks"] = tokens.check("sp_train", sp, sum(tokens.summary()["single"]["tokens"]))
            rec["ranks"]["whole_residual_bytes"] = sp * rec["ranks"]["single"]["residual_bytes"][0]
            rec["expected"] = {"flash_attention_fwd_sm90": 2 * n_blocks * dp,
                               "flash_attention_bwd_fused": n_blocks * dp,
                               "flash_attention_bwd_dq_convert": n_blocks * dp,
                               "flash_attention_fwd_d512": ref["expected"]["flash_attention_fwd_d512"]}
            rec["vs_unsharded"] = compare(trainer, m)
            rec["vs_unsharded"]["same_mask_conds"] = trainer.mask_conds == ref["mask_conds"]
            log(f"[sp_train] {tag}: " + json.dumps(rec))
            runs[tag] = rec
            if sizes is None:  # phase 28 reads its distance to this one-process (1, 4, 1) step
                carry["sp4_ref"] = dict(loss=rec["loss"], grad_norm=rec["grad_norm"])
            if tag == SP_MESHES[0][0]:
                trainer.state.load_state_dict(snapshot)
                gen = torch.Generator(device=device)
                gen.set_state(seen["gen_state"])
                with patched(psh.RankGroup, "chunks", _last_chunk_left_out):
                    m = step(trainer.state, seen["tb"], gen)
                controls["last_chunk_left_out"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                                       **compare(trainer, m))
                log("[sp_train] control last_chunk_left_out: " + json.dumps(controls["last_chunk_left_out"]))
            del seen
    finally:
        set_mesh(None)
        trainer = start_d = ref_change_d = None
        free()
    for tag, rec in runs.items():
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"sp_train {tag}: loss {rec['loss']} or grad norm {rec['grad_norm']} not finite")
        if rec["launches"] != rec["expected"]:
            raise AssertionError(f"sp_train {tag}: launches {rec['launches']} != expected {rec['expected']}")
        if not (rec["vs_unsharded"]["same_mask_conds"] and held(rec["vs_unsharded"])):
            raise AssertionError(f"sp_train {tag} vs the unsharded step: {rec['vs_unsharded']}")
        check_peak(f"sp_train {tag}", rec["peak_mem_gb"])
    for name, c in controls.items():
        if held(c):
            raise AssertionError(f"sp_train control {name} passed the limits: {c}")
    return dict(depth=[n_blocks], runs=runs, controls=controls,
                tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL, update=TP_TRAIN_UPDATE_TOL),
                launches={k: sum(r["launches"].get(k, 0) for r in runs.values())
                          for k in runs[SP_MESHES[0][0]]["expected"]})


# Phase 24: training across processes (multi_host) on the one card. Part (a):
# MP_WORLD worker processes of this script, started with torchrun's variables,
# each joins the group as the training CLI does (parallel/distributed.
# initialize: both on cuda:0, so gloo, the CUDA tensors staged through host
# memory), builds Trainer(cfg, device, mesh=train_mesh(...)) over (data 2, 1,
# 1) for phase 21's configuration, loads phase 21's saved state (a file the
# parent writes), and takes one step on its 2 rows of phase 21's batch from
# phase 21's generator states: held to the TP_TRAIN_* limits against phase
# 21's unsharded step (the loss and norm every process reports, the masters'
# change summed over the processes' shards), exact launches per process, the
# peaks; the control (process 0's replicated gradients not summed across
# processes) must fail them. Part (b): the training CLI under torchrun, two
# processes, stage1.py at full width and MP_CLI_DEPTH blocks for MP_CLI_STEPS
# steps of one seeded clip per process; its checkpoint loads into a
# single-process Trainer.
MP_WORLD = 2
MP_WORKER = "--multi-process-worker"  # the worker's argument (part (a))
MP_TIMEOUT = 600  # seconds for part (a)'s processes, and for part (b)'s run
MP_GROUP_TIMEOUT = 300  # seconds a collective waits before it raises
MP_CLI_DEPTH = (1, 0)  # one double block: the CLI's fixed costs (start, checkpoint) dominate
MP_CLI_STEPS, MP_CLI_FRAMES, MP_CLI_SIZE, MP_CLI_BUCKET = 1, 33, 256, "256px"
MP_CLI_CFG = """_base_ = [{base!r}]
model = dict(depth={depth}, depth_single_blocks={single})
bucket_config = {{"_delete_": True, {bucket!r}: {{{frames}: (1.0, 1)}}}}
warmup_steps = 0
log_every = 1
ckpt_every = 1000
epochs = 1
"""


def mp_launches(res: dict, kernel: str) -> dict:
    """Phase 24's launches of ``kernel``, per part (a) run and process."""
    return {tag: [r["launches"].get(kernel, 0) for r in run["processes"]] for tag, run in res["part_a"].items()}


def sp_proc_launches(res: dict, kernel: str) -> dict:
    """Phase 28's launches of ``kernel``, per part (a) run, step and
    process."""
    return {tag: {name: [p["runs"][name]["launches"].get(kernel, 0) for p in run["processes"]]
                  for name, _ in SP_PROC_BACKENDS} for tag, run in res["sp_processes"].items()}


# Phase 28: stage2.py with its sp group across processes, in phase 24's two
# worker processes after phase 24's step (its trainer freed): each builds
# Trainer(cfg, device, mesh=train_mesh(...)) for stage2.py at phase 21's cell
# over stage2's own (1, 4, 1), sp ranks 0-1 in process 0 and 2-3 in process 1
# (logical ranks on the one card; gloo, the CUDA tensors staged through host
# memory), drops its T5, CLIP and VAE (the step is taken on phase 21's
# encoded inputs: two processes' full states and a T5-XXL each do not fit
# the card), loads phase 21's saved state and takes one step with the
# default attention (the sp group gathered across the processes for one
# flash call a block on every process) and one with ring_rdma (the ring's
# KV slots and dK/dV accumulators sent between the processes), both from
# phase 21's generator state. Each is held to phase 21's limits (TP_TRAIN_*)
# against phase 21's unsharded step: the loss and norm every process reports,
# and each process's copy of every master; exact launches per process; the
# ring's cross-process sends (comm.RING_REMOTE) exact by arithmetic; the
# distance to phase 27's one-process (1, 4, 1) step printed. Known-wrong
# variants, each a step that must fail phase 21's limits: the default step
# with process 1 dropping the cross-process sum of the weight gradients (over
# the sp group split across the processes, where phase 24's control drops
# the sum over 'data'), and the ring_rdma step in which the receiving rank
# reuses its own KV on the cross-process hop (its forward's output distance
# from the right step's is printed beside phase 9's video limit: at 2 + 4
# random-weight blocks it read 0.016, below that limit, in the first card
# run; the masters see it).
SP_PROC_BACKENDS = (("default", None), ("ring_rdma", "ring_rdma"))


def sp_proc_expected(backend, n_blocks: int, local: int, sp: int) -> dict:
    """Phase 28's launches per process and step: the default attention's
    gathered call on every process (forward and recompute, backward and its
    dQ epilogue a block); ring_rdma's (rank, hop) launches of this process's
    ranks and a dQ epilogue per rank and block."""
    if backend is None:
        return {"flash_attention_fwd_sm90": 2 * n_blocks, "flash_attention_bwd_fused": n_blocks,
                "flash_attention_bwd_dq_convert": n_blocks}
    return {"ring_flash_fwd": 2 * n_blocks * local * sp, "ring_flash_bwd_fused": n_blocks * local * sp,
            "flash_attention_bwd_dq_convert": n_blocks * local}


def sp_proc_traffic(tb: dict, heads: int, head_dim: int, n_blocks: int, sp: int, dtype) -> dict:
    """Phase 28's ring sends across processes per process and step, by
    arithmetic: one rank of each process sends to the next process; per
    block the forward and its recompute send the KV slot (2, B, H, L/sp, D)
    in the compute ``dtype`` on sp - 1 hops each, the backward the KV slot
    on sp - 1 hops and the fp32 dK/dV accumulators on all sp."""
    b = tb["x0"].shape[0]
    lq = (tb["x0"].shape[1] + tb["txt"].shape[1]) // sp
    slot = 2 * b * heads * lq * head_dim
    kv_sends, grad_sends = 3 * n_blocks * (sp - 1), n_blocks * sp
    return dict(sends=kv_sends + grad_sends,
                bytes=kv_sends * slot * torch.finfo(dtype).bits // 8 + grad_sends * slot * 4)


def _own_kv_land(self, name, work, buf, slots, slot):
    """Known-wrong: the ring's cross-process KV hop skipped: the receiving
    rank reuses its own KV (its other slot) in place of its left
    neighbour's."""
    work.wait()
    if name == "kv":
        slots[slot].copy_(slots[1 - slot])
    elif buf is not None:
        slots[slot].copy_(buf, non_blocking=True)


def _own_masters_change(state, start: dict, ref_change: dict) -> dict:
    """The relative L2 of each master's change against phase 21's, over
    this process's copy of it (one leaf per shard it holds: every master
    whole at (1, 4, 1)); the worst of each process (a collective)."""
    from opensora_torch.parallel import distributed

    upd = {}
    for name, pl in state.sharding.placements.items():
        acc = torch.zeros(2, dtype=torch.float64, device=pl.leaves[0].device)
        for n in pl.canonical():
            i, j = pl.keys[n][:2]
            leaf = pl.leaves[n]
            change = pl.piece(ref_change[name], i, j).to(leaf.device)
            err = leaf.detach().float() - pl.piece(start[name], i, j).to(leaf.device) - change
            acc += torch.stack([(err.double() ** 2).sum(), (change.double() ** 2).sum()])
        num, den = acc.tolist()
        upd[name] = math.sqrt(num) / max(math.sqrt(den), 1e-30)
    worst = max(upd, key=upd.get)
    every = distributed.all_gather_object(dict(update_rel_l2_max=upd[worst], update_rel_l2_worst=worst,
                                               update_rel_l2_median=sorted(upd.values())[len(upd) // 2]))
    return dict(update_rel_l2_max=max(e["update_rel_l2_max"] for e in every), by_process=every)


def sp_processes_worker(device, data: dict, snapshot: dict) -> dict:
    """Phase 28 in one process (see its comment)."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel import comm, distributed
    from opensora_torch.parallel.comm import process_all_reduce
    from opensora_torch.train import Trainer, train_mesh
    from opensora_torch.utils.config import parse_configs

    t0 = time.perf_counter()
    rank = distributed.process_index()
    cfg = parse_configs(stage2_cfg_args())
    mesh = train_mesh(cfg, device)
    trainer = Trainer(cfg, device, mesh=mesh)
    trainer.t5 = trainer.clip = trainer.ae = None
    free()
    trainer.state.load_state_dict(snapshot)
    torch.cuda.synchronize()
    out = dict(mesh=repr(mesh), local_ranks=mesh.local_ranks, build_and_load_s=time.perf_counter() - t0, runs={})
    tb = _tree_to(data["step_inputs"]["tb"], device)
    model_cfg = trainer.model.config
    n_blocks, sp, local = data["n_blocks"], mesh.shape["sp"], len(mesh.local_ranks)
    traffic = sp_proc_traffic(tb, model_cfg.num_heads, model_cfg.hidden_size // model_cfg.num_heads, n_blocks, sp,
                              trainer.model.dtype)

    def step(backend, patch=None):
        """One step from phase 21's state and generator state: its
        reading, and the model's output (its forward, before the loss)."""
        set_attn_backend(trainer.model, backend)
        trainer.state.load_state_dict(snapshot)
        gen = torch.Generator(device=device)
        gen.set_state(data["step_inputs"]["gen_state"])
        _build.LAUNCHES.clear()
        comm.RING_REMOTE.update(sends=0, bytes=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        outs, forward_rank = [], trainer.model.forward_rank

        def recorded(*args, **kwargs):
            out = forward_rank(*args, **kwargs)
            outs.append(out.detach().float())
            return out

        with StagingTimer() as staging, unittest.mock.patch.object(trainer.model, "forward_rank", recorded), \
                patch or contextlib.nullcontext():
            t0 = time.perf_counter()
            m = trainer.train_step(trainer.state, tb, gen)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), launches=dict(_build.LAUNCHES),
                   expected=sp_proc_expected(backend, n_blocks, local, sp), ring_remote=dict(comm.RING_REMOTE),
                   staging=staging.read(), step_s=step_s, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        rec.update(_own_masters_change(trainer.state, snapshot["params"], data["ref_change"]))
        return rec, outs[0]

    outputs = {}
    for tag, backend in SP_PROC_BACKENDS:
        out["runs"][tag], outputs[tag] = step(backend)
    out["runs"]["ring_rdma"]["expected_ring_remote"] = traffic

    def unsummed(flat, group=None):
        process_all_reduce(flat, group)
        return flat

    out["control_unsummed_on_1"], _ = step(None, unittest.mock.patch(
        "opensora_torch.parallel.sharding.process_all_reduce", unsummed) if rank == 1 else None)
    out["control_kv_skipped"], wrong = step("ring_rdma", unittest.mock.patch.object(comm.RingTransport, "_land",
                                                                                   _own_kv_land))
    out["control_kv_skipped"]["output_rel_l2"] = rel_l2(wrong, outputs["ring_rdma"])
    out["seconds"] = time.perf_counter() - t0
    del trainer, tb, outputs, wrong
    free()
    return out


def torchrun_env(rank: int, world: int, port: int, **extra) -> dict:
    """The variables torchrun sets for process ``rank`` of ``world`` on one
    host."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port), **extra)


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout: float, tag: str) -> None:
    """Wait for every process; one that fails, or the time limit, stops the
    others (each process is killed on the way out, in every case)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"{tag}: exit codes {codes} (-9: stopped after a failure or the {timeout} s limit)")


class StagingTimer:
    """CUDA events around each staged copy of the gloo collectives
    (``parallel/comm.staged_copy``), the host seconds of each
    torch.distributed call (the p2p posts among them) and of the ring
    transport's waits on its sends and receives across processes, while
    open."""

    def __init__(self):
        self.events, self.host_s, self.calls, self.ring_wait_s = [], 0.0, 0, 0.0

    def __enter__(self):
        from opensora_torch.parallel import comm

        staged = comm.staged_copy

        def timed_copy(x, device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = staged(x, device)
            end.record()
            self.events.append((start, end))
            return out

        def timed(op):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return op(*args, **kwargs)
                finally:
                    self.host_s += time.perf_counter() - t0
                    self.calls += 1
            return run

        def ring_timed(op):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return op(*args, **kwargs)
                finally:
                    self.ring_wait_s += time.perf_counter() - t0
            return run

        self.patches = [unittest.mock.patch.object(comm, "staged_copy", timed_copy)] + [
            unittest.mock.patch.object(comm.dist, name, timed(getattr(comm.dist, name)))
            for name in ("all_reduce", "all_gather", "reduce_scatter", "gather", "batch_isend_irecv", "broadcast",
                         "recv")] + [
            unittest.mock.patch.object(comm.RingTransport, name, ring_timed(getattr(comm.RingTransport, name)))
            for name in ("_land", "release")]
        for p in self.patches:
            p.__enter__()
        comm.STAGED.update(copies=0, bytes=0)
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.__exit__(*exc)

    def read(self) -> dict:
        from opensora_torch.parallel import comm

        torch.cuda.synchronize()
        return dict(copies=comm.STAGED["copies"], bytes=comm.STAGED["bytes"],
                    copies_device_ms=sum(a.elapsed_time(b) for a, b in self.events),
                    collectives=self.calls, collectives_host_s=self.host_s, ring_wait_s=self.ring_wait_s)


def _masters_change(state, start: dict, ref_change: dict) -> dict:
    """The relative L2 of each master's change against phase 21's
    unsharded change, over the whole parameter: each process sums the
    squares of its shards (each shard counted on one process), the sums
    are added over the processes."""
    from opensora_torch.parallel.comm import process_all_reduce

    names = list(state.sharding.placements)
    sums = []
    for name in names:
        pl = state.sharding.placements[name]
        acc = torch.zeros(2, dtype=torch.float64, device=pl.leaves[0].device if len(pl.leaves) else "cpu")
        for n, leaf in enumerate(pl.leaves):
            if id(leaf) in state.optimizer.replica_ids:
                continue
            i, j = pl.keys[n][:2]
            change = pl.piece(ref_change[name], i, j).to(leaf.device)
            err = leaf.detach().float() - pl.piece(start[name], i, j).to(leaf.device) - change
            acc += torch.stack([(err.double() ** 2).sum(), (change.double() ** 2).sum()])
        sums.append(acc.cpu())
    sums = process_all_reduce(torch.stack(sums))
    upd = {n: float(sums[k, 0].sqrt() / sums[k, 1].sqrt().clamp(min=1e-30)) for k, n in enumerate(names)}
    worst = max(upd, key=upd.get)
    return dict(update_rel_l2_max=upd[worst], update_rel_l2_worst=worst,
                update_rel_l2_median=sorted(upd.values())[len(upd) // 2])


def multi_process_worker(root: str) -> int:
    """Part (a) in one process: see the phase's comment."""
    import datetime

    from opensora_torch.ops import _build
    from opensora_torch.parallel import distributed
    from opensora_torch.parallel.comm import process_all_reduce
    from opensora_torch.train import Trainer, train_mesh
    from opensora_torch.utils.config import parse_configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = distributed.initialize("cuda", timeout=datetime.timedelta(seconds=MP_GROUP_TIMEOUT))
    rank = distributed.process_index()
    data = torch.load(os.path.join(root, "inputs.pt"), mmap=True, weights_only=False)
    t0 = time.perf_counter()
    cfg = parse_configs(fsdp_cfg_args())
    mesh = train_mesh(cfg, device)
    trainer = Trainer(cfg, device, mesh=mesh)
    snapshot = torch.load(os.path.join(root, "state.pt"), mmap=True, weights_only=False)
    snapshot["ema"] = snapshot["params"]  # the initial state's EMA (see run_multi_process_path)
    trainer.state.load_state_dict(snapshot)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    per = data["video"].shape[0] // distributed.process_count()
    rows = slice(rank * per, (rank + 1) * per)
    batch = {"video": data["video"][rows].to(device), "text": data["text"][rows]}
    trainer.gen.set_state(data["rng_states"][0])
    trainer.host_rng.bit_generator.state = data["rng_states"][1]
    seen = {}
    step = trainer.train_step

    def recorded(state, tb, gen):  # the step's inputs, for the control
        seen.update(tb=tb, gen_state=gen.get_state())
        return step(state, tb, gen)

    trainer.train_step = recorded
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with StagingTimer() as staging:
        m = trainer.run_batch(batch)
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    free_b, total_b = torch.cuda.mem_get_info(device)
    rec = dict(rank=rank, device=str(device), backend=distributed.backend(), mesh=repr(mesh),
               loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), launches=dict(_build.LAUNCHES),
               step_s=trainer.timers.to_dict()["time/step"], total_s=total_s, build_and_load_s=build_s,
               mask_conds=trainer.mask_conds, rows=[rows.start, rows.stop], staging=staging.read(),
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               card_used_gb=(total_b - free_b) / 1e9, card_total_gb=total_b / 1e9)
    rec.update(_masters_change(trainer.state, snapshot["params"], data["ref_change"]))

    # the control: the step again from the saved state on the same inputs,
    # process 0 dropping the cross-process sum of the replicated gradients
    trainer.state.load_state_dict(snapshot)
    gen = torch.Generator(device=device)
    gen.set_state(seen["gen_state"])

    def unsummed(flat, group=None):
        process_all_reduce(flat, group)
        return flat

    with unittest.mock.patch("opensora_torch.parallel.sharding.process_all_reduce", unsummed) if rank == 0 \
            else contextlib.nullcontext():
        c = step(trainer.state, seen["tb"], gen)
    rec["control"] = dict(loss=float(c["loss"]), grad_norm=float(c["grad_norm"]),
                          **_masters_change(trainer.state, snapshot["params"], data["ref_change"]))
    del trainer, seen, step, c, m
    free()
    distributed.barrier()  # phase 24's state freed in both processes
    t0 = time.perf_counter()
    rec["sp_processes"] = sp_processes_worker(device, data, snapshot)
    rec["sp_processes"]["phase_s"] = time.perf_counter() - t0
    distributed.barrier()  # phase 28's trainers freed in both processes
    rec["tp_pp_processes"] = tp_pp_processes_worker(device, data, snapshot)
    distributed.barrier()  # phase 29's trainers freed in both processes
    rec["vae_cp_processes"] = vae_cp_processes_worker(device, data["vae_cp"])
    with open(os.path.join(root, f"result_{rank}.json"), "w") as f:
        json.dump(rec, f)
    distributed.shutdown()
    return 0


def run_multi_process_path(device, carry: dict) -> dict:
    """Phase 24 (see its comment): part (a) on the one card over gloo (and,
    where the host has two cards or more, over nccl, one process a card),
    then part (b)."""
    ref, n_blocks = carry["ref"], carry["n_blocks"]
    res = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        t0 = time.perf_counter()
        # phase 21's state is the initial one: its EMA equals the masters,
        # which the workers give it again (the file holds them once)
        snapshot = carry["snapshot"]
        if snapshot["step"] != 0 or any(not torch.equal(snapshot["ema"][n], p) for n, p in snapshot["params"].items()):
            raise AssertionError("phase 21's saved state is not the initial one (its EMA differs from the masters)")
        torch.save(dict(snapshot, ema=None), os.path.join(root, "state.pt"))
        torch.save(dict(video=carry["batch"]["video"].cpu(), text=carry["batch"]["text"],
                        rng_states=carry["rng_states"], ref_change=carry["ref_change"],
                        step_inputs=carry["step_inputs"], n_blocks=n_blocks, vae_cp=carry["vae_cp"]),
                   os.path.join(root, "inputs.pt"))
        write_s = time.perf_counter() - t0
        free()
        res["parent_gb"] = dict(allocated=torch.cuda.memory_allocated(device) / 1e9,
                                reserved=torch.cuda.memory_reserved(device) / 1e9)
        log(f"[multi_process] phase 21's state and inputs written in {write_s:.1f} s; this process holds "
            f"{res['parent_gb']['allocated']:.2f} GB on the card ({res['parent_gb']['reserved']:.2f} GB reserved)")
        # expandable segments: two processes' states on one card, allocated and freed phase by phase
        alloc = dict(PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        runs = {"gloo_one_card": dict(CUDA_VISIBLE_DEVICES=str(device.index or 0), **alloc)}
        if torch.cuda.device_count() >= MP_WORLD:
            runs["nccl"] = alloc
        else:
            log(f"[multi_process] nccl: not run ({torch.cuda.device_count()} CUDA device; phases 24, 28 and 29)")
        res["part_a"] = {tag: _multi_process_part_a(root, tag, extra, ref, n_blocks) for tag, extra in runs.items()}
        res["sp_processes"] = {tag: check_sp_processes(tag, run, ref, carry["sp4_ref"])
                               for tag, run in res["part_a"].items()}
        res["tp_pp_processes"] = {tag: check_tp_pp_processes(tag, run, ref) for tag, run in res["part_a"].items()}
        res["vae_cp_processes"] = {tag: check_vae_cp_processes(tag, run, carry["vae_cp"]["limits"])
                                   for tag, run in res["part_a"].items()}
        res["inputs_write_s"] = write_s
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["cli"] = _multi_process_part_b(device)
    t0 = time.perf_counter()
    res["cli_tp"] = _multi_process_part_b(device, TP_PROC_ARGS, "tp_processes_cli")
    log(f"[time] phase 29 (c) the CLI with --mesh.tp_size 2: {time.perf_counter() - t0:.1f} s")
    return res


def check_sp_processes(tag: str, run: dict, ref: dict, sp4_ref: dict) -> dict:
    """Phase 28's readings from one part (a) run's processes, held to the
    phase's limits (see its comment)."""
    recs = [r["sp_processes"] for r in run["processes"]]

    def rel(r, want):
        return dict(loss_rel=abs(r["loss"] - want["loss"]) / abs(want["loss"]),
                    grad_norm_rel=abs(r["grad_norm"] - want["grad_norm"]) / want["grad_norm"])

    def held(c):
        return (c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL)

    controls = ("control_unsummed_on_1", "control_kv_skipped")
    for p, rec in enumerate(recs):
        for name, r in list(rec["runs"].items()) + [(c, rec[c]) for c in controls]:
            r["vs_unsharded"] = dict(rel(r, ref), update_rel_l2_max=r["update_rel_l2_max"])
            r["vs_phase27"] = rel(r, sp4_ref)
        log(f"[sp_processes] {tag} process {p} ({rec['mesh']}, ranks {rec['local_ranks']}): " + json.dumps(rec))
        for name, r in rec["runs"].items():
            log(f"[sp_processes] {tag} process {p} {name}: step {r['step_s']:.2f} s, loss/norm/masters vs phase 21 "
                f"{r['vs_unsharded']}, vs phase 27 {r['vs_phase27']}; ring sends {r['ring_remote']}; staged "
                f"{r['staging']['bytes'] / 1e9:.2f} GB in {r['staging']['copies']} copies; collectives "
                f"{r['staging']['collectives_host_s']:.2f} s, ring waits {r['staging']['ring_wait_s']:.2f} s; "
                f"peak {r['peak_mem_gb']:.2f} GB")
            if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and held(r["vs_unsharded"])):
                raise AssertionError(f"sp_processes {tag} process {p} {name} vs phase 21's step: {r['vs_unsharded']}")
            if r["launches"] != r["expected"]:
                raise AssertionError(f"sp_processes {tag} process {p} {name}: launches {r['launches']} != expected "
                                     f"{r['expected']}")
            check_peak(f"sp_processes {tag} process {p} {name}", r["peak_mem_gb"])
        ring = rec["runs"]["ring_rdma"]
        if ring["ring_remote"] != ring["expected_ring_remote"]:
            raise AssertionError(f"sp_processes {tag} process {p}: the ring's sends across processes "
                                 f"{ring['ring_remote']} != {ring['expected_ring_remote']}")
        kv = rec["control_kv_skipped"]
        log(f"[sp_processes] {tag} process {p} controls: unsummed on process 1 "
            f"{rec['control_unsummed_on_1']['vs_unsharded']}; the cross-process KV hop skipped "
            f"{kv['vs_unsharded']}, its forward's output {kv['output_rel_l2']:.4f} from the right ring_rdma step's "
            f"(phase 9's video limit {RING_VIDEO_TOL})")
        for c in controls:
            if held(rec[c]["vs_unsharded"]):
                raise AssertionError(f"sp_processes {tag}: the control {c} passed phase 21's limits: "
                                     f"{rec[c]['vs_unsharded']}")
    for name in recs[0]["runs"]:
        if sum(r["runs"][name]["peak_mem_gb"] for r in recs) >= PEAK_LIMIT_GB:
            raise AssertionError(f"sp_processes {tag} {name}: the processes' peaks add up to "
                                 f"{sum(r['runs'][name]['peak_mem_gb'] for r in recs):.2f} GB")
    log(f"[time] phase 28 ({tag}, inside phase 24's processes): {max(r['phase_s'] for r in recs):.1f} s")
    return dict(processes=recs, tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL,
                                          update=TP_TRAIN_UPDATE_TOL))


# Phase 29: tp groups and pipeline stages across processes, in phase 24's two
# worker processes after phase 28 (its trainer freed): stage1.py at phase
# 21's cell (full width, 2 + 4 blocks, phase 21's encoded step inputs and
# generator state; the T5, CLIP and VAE dropped, as phase 28 drops them),
# phase 21's saved state loaded. Part (a): Trainer(cfg, device,
# mesh=train_mesh(...)) with --mesh.tp_size 2, (data 1, sp 1, tp 2), one tp
# rank a process: each row-parallel product's fp32 partial summed across the
# two processes (comm.tp_all_reduce, whose backward sums the gradient the
# same way), the row bias added once. Part (b): the pipeline key (pp 2,
# data 1, n_micro 2) through pipeline_mesh, one stage a process, on the
# ordered transport: each boundary's activation sent to the other process
# in one message, its gradient sent back in one, every message under one
# tag and posted by both processes in the order of the tick loop's slots
# (comm.post_pipeline_messages; gloo then pairs them by posting order, as
# nccl does), the backward run slot by slot in reverse tick order on both
# processes (pipeline.PipelineTape), the loss's value broadcast to stage 0's
# process from the last stage's. One step each, held to phase 21's limits
# (TP_TRAIN_*) against phase 21's unsharded step: the loss and norm every
# process reports, the masters' change summed over the processes' shards;
# exact launches per process; the tp all-reduces (comm.TP_REMOTE) and the
# pipeline's sends (comm.PP_REMOTE) per process, with their bytes, exact by
# arithmetic; each process's sequence of pipeline messages (posted and
# received, in posting order) the mirror of the other's. Known-wrong
# controls, each a step that must fail those limits: (a) the tp sum's
# backward left local; (b) the last stage's received activations sending
# back zero gradients, and process 0 running its microbatches' backwards in
# forward order (its messages the same in size and place, so they meet the
# other microbatches' gradients). Part (c), after phase 24(b): the
# training CLI under torchrun with --mesh.tp_size 2 at MP_CLI_DEPTH blocks
# (phase 24(b)'s run, both processes reading the same clip), its checkpoint
# loaded by one process.
TP_PROC_ARGS = ["--mesh.tp_size", "2"]  # (data 1, sp 1, tp 2) over the two processes
PP_PROC = dict(pp_size=2, data_size=1, n_micro=2)  # one stage a process


def tp_proc_traffic(tb: dict, hidden: int, n_double: int, n_single: int) -> dict:
    """Phase 29(a)'s tp all-reduces across processes per process and step,
    by arithmetic: each row-parallel product's fp32 sum (B, its tokens,
    hidden) -- a double block's img and txt proj and MLP out, a single
    block's linear2 -- in the forward, its remat recompute and the
    backward."""
    b, n_img, n_txt = tb["x0"].shape[0], tb["x0"].shape[1], tb["txt"].shape[1]
    tokens = n_double * 2 * (n_img + n_txt) + n_single * (n_img + n_txt)
    return dict(all_reduces=3 * (4 * n_double + n_single), bytes=3 * tokens * b * hidden * 4)


def pp_proc_traffic(tb: dict, model_cfg, n_micro: int, dtype) -> list:
    """Phase 29(b)'s pipeline messages per process and step, by arithmetic
    (stage 0's process, then the last stage's), each boundary's tensors
    packed in one message and their gradients in one back: per microbatch
    of mb rows, stage 0 sends the double stack's (img, txt, vec, pe) and the
    single stack's (x, vec, pe) forward and the gradients of the double
    stack's output (img, txt, vec) back; the last stage sends the double
    stack's output (img, txt, vec, pe) to stage 0 and the gradients of its
    two inputs ((img, txt, vec), (x, vec)). The activations and their
    gradients in the compute ``dtype``; pe is RoPE's cos and sin, each (mb,
    L, head_dim / 2) fp32."""
    b, n_img, n_txt = tb["x0"].shape[0], tb["x0"].shape[1], tb["txt"].shape[1]
    mb, h, e = b // n_micro, model_cfg.hidden_size, torch.finfo(dtype).bits // 8
    img, txt, vec, x = (mb * n * h * e for n in (n_img, n_txt, 1, n_img + n_txt))
    pe = 2 * mb * (n_img + n_txt) * sum(model_cfg.axes_dim) // 2 * 4
    first = dict(sends=3, bytes=(img + txt + vec + pe) + (x + vec + pe) + (img + txt + vec))
    last = dict(sends=3, bytes=(img + txt + vec + pe) + (img + txt + vec) + (x + vec))
    return [{k: n_micro * v for k, v in d.items()} for d in (first, last)]


def _tp_sum_local(ctx, grad):
    """Known-wrong: the backward of the tp group's cross-process sum left
    local (each process keeps its own share of the gradient)."""
    return grad, None


def _gradient_not_sent(slot):
    """Known-wrong: a received activation sends back a zero gradient, so
    the stages before it get none."""
    return [torch.zeros_like(x) for x in slot.received]


def _microbatches_forward(slots):
    """Known-wrong: the slots' backwards in reverse order, each with the
    microbatch of the mirrored slot (the microbatches' backwards in forward
    order): the messages keep their sizes and places, so the gradients meet
    other microbatches."""
    at = {s.key: s for s in slots}
    out = []
    for s in reversed(slots):
        if len(s.key) == 6:
            call, tick, stage, d, m, n = s.key
            s = at[(call, tick + n - 1 - 2 * m, stage, d, n - 1 - m, n)]
        out.append(s)
    return out


def mirrored(log: dict, peer_log: dict, me: int, peer: int) -> bool:
    """Whether this process's pipeline messages with ``peer`` (posting
    order, (direction, bytes)) mirror the peer's with it element by
    element: each send here a receive there, of the same size."""
    flip = {"send": "recv", "recv": "send"}
    mine, theirs = log.get(str(peer), []), peer_log.get(str(me), [])  # JSON's keys
    return bool(mine) and [(flip[d], n) for d, n in mine] == [tuple(x) for x in theirs]


def tp_pp_processes_worker(device, data: dict, snapshot: dict) -> dict:
    """Phase 29's parts (a) and (b) in one process (see its comment)."""
    from opensora_torch.ops import _build
    from opensora_torch.parallel import comm, distributed, pipeline
    from opensora_torch.parallel.context import set_mesh
    from opensora_torch.train import Trainer, pipeline_mesh, train_mesh
    from opensora_torch.utils.config import Config, parse_configs

    rank = distributed.process_index()
    t0 = time.perf_counter()
    tb = _tree_to(data["step_inputs"]["tb"], device)
    n_blocks = data["n_blocks"]
    out = dict(runs={})

    def build(cfg, mesh):
        t1 = time.perf_counter()
        trainer = Trainer(cfg, device, mesh=mesh)
        trainer.t5 = trainer.clip = trainer.ae = None
        free()
        trainer.state.load_state_dict(snapshot)
        torch.cuda.synchronize()
        return trainer, time.perf_counter() - t1

    def step(trainer, patch=None) -> dict:
        """One step from phase 21's state and generator state."""
        trainer.state.load_state_dict(snapshot)
        gen = torch.Generator(device=device)
        gen.set_state(data["step_inputs"]["gen_state"])
        _build.LAUNCHES.clear()
        comm.TP_REMOTE.update(all_reduces=0, bytes=0)
        comm.reset_pp_remote()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        with StagingTimer() as staging, patch or contextlib.nullcontext():
            t1 = time.perf_counter()
            m = trainer.train_step(trainer.state, tb, gen)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t1
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), launches=dict(_build.LAUNCHES),
                   tp_remote=dict(comm.TP_REMOTE), pp_remote={k: comm.PP_REMOTE[k] for k in ("sends", "bytes")},
                   pp_log={str(p): v for p, v in comm.PP_REMOTE["log"].items()}, staging=staging.read(),
                   step_s=step_s, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        rec.update(_masters_change(trainer.state, snapshot["params"], data["ref_change"]))
        return rec

    # (a) the tp group across the processes
    cfg = parse_configs(fsdp_cfg_args() + TP_PROC_ARGS)
    mesh = train_mesh(cfg, device)
    trainer, build_s = build(cfg, mesh)
    model_cfg, dtype = trainer.model.config, trainer.model.dtype
    rec = step(trainer)
    rec.update(mesh=repr(mesh), build_and_load_s=build_s,
               expected={"flash_attention_fwd_sm90": 2 * n_blocks, "flash_attention_bwd_fused": n_blocks,
                         "flash_attention_bwd_dq_convert": n_blocks},
               expected_tp_remote=tp_proc_traffic(tb, model_cfg.hidden_size, model_cfg.depth,
                                                  model_cfg.depth_single_blocks))
    out["runs"]["tp"] = rec
    out["control_tp_sum_local"] = step(trainer, unittest.mock.patch.object(comm._TpSum, "backward", _tp_sum_local))
    set_mesh(None)
    del trainer
    free()
    distributed.barrier()

    # (b) one pipeline stage a process
    cfg = Config(parse_configs(fsdp_cfg_args()), pipeline=dict(PP_PROC))
    mesh = pipeline_mesh(cfg, device)
    trainer, build_s = build(cfg, mesh)
    per = (model_cfg.depth + model_cfg.depth_single_blocks) // PP_PROC["pp_size"]  # blocks of a stage
    rec = step(trainer)
    rec.update(mesh=repr(mesh), stages=mesh.local_mid, build_and_load_s=build_s,
               expected={"flash_attention_fwd_sm90": 2 * per * PP_PROC["n_micro"],
                         "flash_attention_bwd_fused": per * PP_PROC["n_micro"],
                         "flash_attention_bwd_dq_convert": per * PP_PROC["n_micro"]},
               expected_pp_remote=pp_proc_traffic(tb, model_cfg, PP_PROC["n_micro"], dtype)[rank])
    out["runs"]["pp"] = rec
    out["control_gradient_not_sent"] = step(trainer, unittest.mock.patch.object(pipeline, "sent_back",
                                                                                 _gradient_not_sent))
    # process 0 alone runs its microbatches' backwards in forward order
    out["control_microbatches_forward"] = step(
        trainer, unittest.mock.patch.object(pipeline, "backward_order", _microbatches_forward) if rank == 0 else None)
    set_mesh(None)
    del trainer, tb
    free()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_tp_pp_processes(tag: str, run: dict, ref: dict) -> dict:
    """Phase 29's readings from one part (a) run's processes, held to the
    phase's limits (see its comment)."""
    recs = [r["tp_pp_processes"] for r in run["processes"]]

    def vs(r):
        return dict(loss_rel=abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                    grad_norm_rel=abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                    update_rel_l2_max=r["update_rel_l2_max"])

    def held(c):
        return (c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL)

    controls = ("control_tp_sum_local", "control_gradient_not_sent", "control_microbatches_forward")
    for p, rec in enumerate(recs):
        for name, r in list(rec["runs"].items()) + [(c, rec[c]) for c in controls]:
            r["vs_unsharded"] = vs(r)
        log(f"[tp_pp_processes] {tag} process {p}: " + json.dumps(rec))
        for name, r in rec["runs"].items():
            gloo_s = r["staging"]["collectives_host_s"]
            log(f"[tp_pp_processes] {tag} process {p} {name} ({r['mesh']}): step {r['step_s']:.2f} s, gloo calls "
                f"{gloo_s:.2f} s, staged {r['staging']['bytes'] / 1e9:.2f} GB in {r['staging']['copies']} copies, tp "
                f"all-reduces {r['tp_remote']}, pipeline sends {r['pp_remote']}, peak {r['peak_mem_gb']:.2f} GB; vs "
                f"phase 21 {r['vs_unsharded']}")
            if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and held(r["vs_unsharded"])):
                raise AssertionError(f"tp_pp_processes {tag} process {p} {name} vs phase 21's step: "
                                     f"{r['vs_unsharded']}")
            if r["launches"] != r["expected"]:
                raise AssertionError(f"tp_pp_processes {tag} process {p} {name}: launches {r['launches']} != "
                                     f"expected {r['expected']}")
            check_peak(f"tp_pp_processes {tag} process {p} {name}", r["peak_mem_gb"])
        tp, pp = rec["runs"]["tp"], rec["runs"]["pp"]
        if tp["tp_remote"] != tp["expected_tp_remote"] or tp["pp_remote"]["sends"]:
            raise AssertionError(f"tp_pp_processes {tag} process {p}: the tp all-reduces across processes "
                                 f"{tp['tp_remote']} != {tp['expected_tp_remote']}, or pipeline sends {tp['pp_remote']}")
        if pp["pp_remote"] != pp["expected_pp_remote"] or pp["tp_remote"]["all_reduces"]:
            raise AssertionError(f"tp_pp_processes {tag} process {p}: the pipeline's sends {pp['pp_remote']} != "
                                 f"{pp['expected_pp_remote']}, or tp all-reduces {pp['tp_remote']}")
        q = 1 - p  # the other stage's process
        if not mirrored(pp["pp_log"], recs[q]["runs"]["pp"]["pp_log"], p, q):
            raise AssertionError(f"tp_pp_processes {tag}: process {p}'s pipeline messages {pp['pp_log']} do not "
                                 f"mirror process {q}'s {recs[q]['runs']['pp']['pp_log']}")
        log(f"[tp_pp_processes] {tag} process {p}: {len(pp['pp_log'][str(q)])} pipeline messages posted and "
            f"received with process {q}, in one order on both sides: {pp['pp_log'][str(q)]}")
        log(f"[tp_pp_processes] {tag} process {p} controls: the tp sum's backward left local "
            f"{rec['control_tp_sum_local']['vs_unsharded']}; the stage's gradient not sent back "
            f"{rec['control_gradient_not_sent']['vs_unsharded']}; process 0's microbatches' backwards in forward "
            f"order {rec['control_microbatches_forward']['vs_unsharded']}")
        for c in controls:
            if held(rec[c]["vs_unsharded"]):
                raise AssertionError(f"tp_pp_processes {tag}: the control {c} passed phase 21's limits: "
                                     f"{rec[c]['vs_unsharded']}")
    for name in recs[0]["runs"]:
        if sum(r["runs"][name]["peak_mem_gb"] for r in recs) >= PEAK_LIMIT_GB:
            raise AssertionError(f"tp_pp_processes {tag} {name}: the processes' peaks add up to "
                                 f"{sum(r['runs'][name]['peak_mem_gb'] for r in recs):.2f} GB")
    log(f"[time] phase 29 (a, b; {tag}, inside phase 24's processes): {max(r['seconds'] for r in recs):.1f} s")
    return dict(processes=recs, tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL,
                                          update=TP_TRAIN_UPDATE_TOL))


def tp_pp_launches(res: dict, kernel: str) -> dict:
    """Phase 29's launches of ``kernel``, per part (a) run, step and
    process."""
    return {tag: {name: [p["runs"][name]["launches"].get(kernel, 0) for p in run["processes"]]
                  for name in ("tp", "pp")} for tag, run in res["tp_pp_processes"].items()}


# Phase 30: HunyuanVAE context parallelism with the sp ranks in other
# processes, in phase 24's two worker processes after phase 29: each process
# builds phase 23's VAE (stage1.py's ae, random bf16 weights from the seed;
# the weights' fingerprint checked against phase 23's) and clip, and runs
# make_sharded_vae_fn's encode (posterior mode) and decode (of phase 23's
# unsharded latent) over (data 1, sp) for each of VAE_CP_PROC_SP, the sp
# ranks split evenly over the two processes (sp 2: one rank a process; sp 4:
# two): each process runs its own strips, the halo rows at the process
# boundary come from the other process, the group norms' fp32 sums are
# all-reduced across the processes and the mid-block attention's height is
# all-gathered, each process running the D = 512 forward once a pass. Held
# on each process, with the whole result it gets back, to phase 23's limits
# against phase 23's unsharded pass; the traffic across the processes
# (vae_sharding.VAE_REMOTE: halo sends, moment all-reduces, gathers, with
# their bytes) exact against arithmetic over the unsharded pass's layers
# (vae_cp_traffic, run before the sharded passes); exactly one D = 512 launch
# per process and pass. Known-wrong control: the sp-2 encode with the halo
# not exchanged across the process boundary (the boundary strips' own edge
# rows replicated) must exceed the encode's limit.
VAE_CP_PROC_SP = (2, 4)


def vae_cp_traffic(vae, run, process: int, n_processes: int) -> dict:
    """``VAE_REMOTE`` of one process for one pass, by arithmetic over the
    unsharded pass's layers (``run(vae)``): per causal conv of kernel height
    k and stride s on (B, C, T, H, W), a process above another sends it its
    last strip's k // 2 bottom rows, a process below another its first
    strip's k - s - k // 2 top rows; per group norm two fp32 all-reduces of
    (B, groups); per mid-block attention, and per output (the quant_conv's
    moments of each sample, the decoder's video), one all-gather of this
    process's share of the height."""
    from opensora_torch.models.hunyuan_vae.blocks import CausalAttention, CausalConv3d, GroupNorm
    from opensora_torch.parallel import vae_sharding

    convs, norms, gathers = [], [], []

    def conv_hook(m, args, _):
        convs.append((tuple(args[0].shape), m.conv.kernel_size[1], m.conv.stride[1], args[0].element_size()))

    def gather_hook(m, args, out):
        x = args[0] if isinstance(m, CausalAttention) else out
        gathers.append(x.numel() * x.element_size())

    hooks = [m.register_forward_hook(conv_hook) for m in vae.modules() if isinstance(m, CausalConv3d)]
    hooks += [m.register_forward_hook(lambda m, a, o: norms.append((a[0].shape[0], m.num_groups)))
              for m in vae.modules() if isinstance(m, GroupNorm)]
    hooks += [m.register_forward_hook(gather_hook) for m in vae.modules() if isinstance(m, CausalAttention)]
    hooks += [vae.quant_conv.register_forward_hook(gather_hook), vae.decoder.register_forward_hook(gather_hook)]
    try:
        with torch.no_grad():
            run(vae)
    finally:
        for h in hooks:
            h.remove()
    out = dict.fromkeys(vae_sharding.VAE_REMOTE, 0)
    for (b, c, t, _, w), k, s, e in convs:
        for rows, sends in ((k // 2, process < n_processes - 1), (k - s - k // 2, process > 0)):
            if rows and sends:
                out["halo_sends"] += 1
                out["halo_bytes"] += b * c * t * rows * w * e
    out.update(moment_all_reduces=2 * len(norms), moment_bytes=sum(2 * b * g * 4 for b, g in norms),
               gathers=len(gathers), gather_bytes=sum(n // n_processes for n in gathers))
    return out


def _halo_from_own_rows(self, xs, top, bottom):
    """Known-wrong: no halo rows across the process boundary: a process's
    end strips take their own edge rows, replicated, for the other
    process's."""
    return ((xs[0][:, :, :, :1].expand(-1, -1, -1, top, -1) if self.group.first > 0 and top else None),
            (xs[-1][:, :, :, -1:].expand(-1, -1, -1, bottom, -1)
             if self.group.first + len(xs) < self.n and bottom else None))


def vae_cp_processes_worker(device, ref: dict) -> dict:
    """Phase 30 in one process (see its comment)."""
    from opensora_torch.models.hunyuan_vae.model import CausalVAE3D_HUNYUAN
    from opensora_torch.ops import _build
    from opensora_torch.parallel import distributed, vae_sharding
    from opensora_torch.parallel.mesh import MeshConfig, create_mesh
    from opensora_torch.utils.config import parse_configs

    t0 = time.perf_counter()
    rank, world = distributed.process_index(), distributed.process_count()
    cfg = parse_configs([STAGE1_CFG])
    torch.manual_seed(cfg.seed)
    vae = CausalVAE3D_HUNYUAN(device=device, **{k: v for k, v in dict(cfg.ae).items() if k != "type"}).eval()
    if vae_fingerprint(vae) != ref["fingerprint"]:
        raise AssertionError(f"vae_cp_processes: the VAE's weights {vae_fingerprint(vae)} are not phase 23's "
                             f"{ref['fingerprint']}")
    x = vae_cp_clip(device, VAE_CP_FRAMES, VAE_CP_SIZE, cfg.seed)
    want = dict(encode=ref["z_ref"].to(device), decode=ref["y_ref"].to(device))
    runs = dict(encode=lambda fn: fn(x, sample_posterior=False), decode=lambda fn: fn(want["encode"]))
    out = dict(expected={w: vae_cp_traffic(vae, lambda v, w=w: runs[w](getattr(v, w)), rank, world) for w in runs},
               sp={})
    for sp in VAE_CP_PROC_SP:
        mesh = create_mesh(MeshConfig(1, sp, 1), [device] * (sp // world))
        out["sp"][sp] = dict(mesh=repr(mesh))
        for w in runs:
            fn = vae_sharding.make_sharded_vae_fn(vae, mesh, w)
            free()
            torch.cuda.reset_peak_memory_stats(device)
            vae_sharding.reset_vae_remote()
            _build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.no_grad():
                y = runs[w](fn)
                torch.cuda.synchronize()
            out["sp"][sp][w] = dict(seconds=time.perf_counter() - t1, rel_l2=rel_l2(y, want[w]),
                                    max_rel=max_rel(y, want[w]), shape=list(y.shape), launches=dict(_build.LAUNCHES),
                                    traffic=dict(vae_sharding.VAE_REMOTE),
                                    peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
            del y
    mesh = create_mesh(MeshConfig(1, VAE_CP_PROC_SP[0], 1), [device] * (VAE_CP_PROC_SP[0] // world))
    vae_sharding.reset_vae_remote()
    with unittest.mock.patch.object(vae_sharding.HeightStrips, "_edges", _halo_from_own_rows), torch.no_grad():
        z = vae_sharding.make_sharded_vae_fn(vae, mesh, "encode")(x, sample_posterior=False)
    out["control_halo_left_out"] = dict(rel_l2=rel_l2(z, want["encode"]), max_rel=max_rel(z, want["encode"]),
                                        traffic=dict(vae_sharding.VAE_REMOTE))
    del vae, x, want, z
    free()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_vae_cp_processes(tag: str, run: dict, limits: dict) -> dict:
    """Phase 30's readings from one part (a) run's processes, held to phase
    23's limits (see the phase's comment)."""
    recs = [r["vae_cp_processes"] for r in run["processes"]]
    for p, rec in enumerate(recs):
        log(f"[vae_cp_processes] {tag} process {p}: " + json.dumps(rec))
        for sp, r in rec["sp"].items():
            for w in ("encode", "decode"):
                got = r[w]
                log(f"[vae_cp_processes] {tag} process {p} sp {sp} {w} ({r['mesh']}): {got['seconds']:.2f} s, rel L2 "
                    f"{got['rel_l2']:.3e} (limit {limits[w]:.3e}), traffic {got['traffic']}, launches "
                    f"{got['launches']}, peak {got['peak_mem_gb']:.2f} GB")
                if not got["rel_l2"] <= limits[w]:
                    raise AssertionError(f"vae_cp_processes {tag} process {p} sp {sp} {w}: {got['rel_l2']} over "
                                         f"{limits[w]}")
                if got["traffic"] != rec["expected"][w]:
                    raise AssertionError(f"vae_cp_processes {tag} process {p} sp {sp} {w}: traffic {got['traffic']} "
                                         f"!= expected {rec['expected'][w]}")
                if got["launches"] != {"flash_attention_fwd_d512": 1}:
                    raise AssertionError(f"vae_cp_processes {tag} process {p} sp {sp} {w}: launches {got['launches']}")
                check_peak(f"vae_cp_processes {tag} process {p} sp {sp} {w}", got["peak_mem_gb"])
        c = rec["control_halo_left_out"]
        log(f"[vae_cp_processes] {tag} process {p} control, the halo left out across the processes: {c}")
        if not (c["rel_l2"] > limits["encode"] and c["traffic"]["halo_sends"] == 0):
            raise AssertionError(f"vae_cp_processes {tag}: the control passed the encode's limit {limits['encode']}: "
                                 f"{c}")
    log(f"[time] phase 30 ({tag}, inside phase 24's processes): {max(r['seconds'] for r in recs):.1f} s")
    return dict(processes=recs, limits=limits)


def vae_cp_proc_launches(res: dict) -> dict:
    """Phase 30's D = 512 launches per part (a) run, sp, pass and
    process."""
    return {tag: {f"sp{sp}": {w: [p["sp"][sp][w]["launches"].get("flash_attention_fwd_d512", 0) for p in run["processes"]]
                               for w in ("encode", "decode")} for sp in run["processes"][0]["sp"]}
            for tag, run in res["vae_cp_processes"].items()}


def _multi_process_part_a(root: str, tag: str, extra_env: dict, ref: dict, n_blocks: int) -> dict:
    from opensora_torch.utils.train import single_frame_encodes

    port = free_port()
    logs = [open(os.path.join(root, f"{tag}_worker_{r}.log"), "w") for r in range(MP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), MP_WORKER, root],
                              env=torchrun_env(r, MP_WORLD, port, **extra_env), stdout=logs[r],
                              stderr=subprocess.STDOUT, start_new_session=True) for r in range(MP_WORLD)]
    try:
        wait_all(procs, MP_TIMEOUT, f"multi_process {tag}")
    except AssertionError:
        for r in range(MP_WORLD):
            logs[r].close()
            with open(os.path.join(root, f"{tag}_worker_{r}.log")) as f:
                log(f"[multi_process] {tag} process {r}'s output (end):\n{f.read()[-6000:]}")
        raise
    finally:
        for f in logs:
            f.close()
    wall_s = time.perf_counter() - t0
    recs = []
    for r in range(MP_WORLD):
        with open(os.path.join(root, f"result_{r}.json")) as f:
            recs.append(json.load(f))
        os.remove(os.path.join(root, f"result_{r}.json"))
    for rec in recs:
        log(f"[multi_process] {tag} process {rec['rank']}: backend {rec['backend']}, device {rec['device']}")
    out = dict(processes=recs, wall_s=wall_s, tols=dict(loss=TP_TRAIN_LOSS_TOL, grad_norm=TP_TRAIN_NORM_TOL,
                                                          update=TP_TRAIN_UPDATE_TOL))
    log(f"[multi_process] {tag}: " + json.dumps(out))

    def compare(r):
        return dict(loss_rel=abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                    grad_norm_rel=abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                    update_rel_l2_max=r["update_rel_l2_max"])

    def held(c):
        return (c["loss_rel"] <= TP_TRAIN_LOSS_TOL and c["grad_norm_rel"] <= TP_TRAIN_NORM_TOL
                and c["update_rel_l2_max"] <= TP_TRAIN_UPDATE_TOL)

    out["vs_unsharded"] = [compare(r) for r in recs]
    out["control_vs_unsharded"] = [compare(r["control"]) for r in recs]
    for rec, c, cc in zip(recs, out["vs_unsharded"], out["control_vs_unsharded"]):
        mine = rec["mask_conds"][rec["rows"][0]:rec["rows"][1]]
        rec["expected"] = {"flash_attention_fwd_sm90": 2 * n_blocks, "flash_attention_bwd_fused": n_blocks,
                           "flash_attention_bwd_dq_convert": n_blocks,
                           "flash_attention_fwd_d512": len(mine) + single_frame_encodes(mine)}
        if rec["launches"] != rec["expected"]:
            raise AssertionError(f"multi_process {tag} process {rec['rank']}: launches {rec['launches']} != "
                                 f"expected {rec['expected']}")
        if not (rec["mask_conds"] == ref["mask_conds"] and held(c)):
            raise AssertionError(f"multi_process {tag} process {rec['rank']} vs the unsharded step: {c}, mask "
                                 f"conditions {rec['mask_conds']} vs {ref['mask_conds']}")
        if held(cc):
            raise AssertionError(f"multi_process {tag}: the control (process 0's replicated gradients not summed) "
                                 f"passed the limits: {cc}")
        check_peak(f"multi_process {tag} process {rec['rank']}", rec["peak_mem_gb"])
    if sum(r["peak_mem_gb"] for r in recs) >= PEAK_LIMIT_GB:
        raise AssertionError(f"multi_process {tag}: the processes' peaks add up to "
                             f"{sum(r['peak_mem_gb'] for r in recs):.2f} GB")
    return out


def _multi_process_part_b(device, extra=(), tag: str = "multi_process_cli") -> dict:
    """Part (b): the training CLI under torchrun (see the phase's comment),
    the processes along 'data' (each reads its own clips); with ``extra``
    (phase 29(c)'s --mesh.tp_size 2) over a mesh of one data coordinate,
    whose processes read the same clips."""
    import re

    from opensora_torch.train import Trainer
    from opensora_torch.utils.ckpt import CheckpointIO
    from opensora_torch.utils.config import parse_configs

    depth, single = MP_CLI_DEPTH
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_mp_")
    try:
        blocks = 1 if extra else MP_WORLD  # the mesh's data blocks: each reads MP_CLI_STEPS clips
        csv = write_clip_csv(os.path.join(root, "clips"), n=blocks * MP_CLI_STEPS, frames=MP_CLI_FRAMES,
                             size=MP_CLI_SIZE)
        cfg_file = os.path.join(root, "stage1_mp.py")
        with open(cfg_file, "w") as f:
            f.write(MP_CLI_CFG.format(base=STAGE1_CFG, depth=depth, single=single, frames=MP_CLI_FRAMES,
                                      bucket=MP_CLI_BUCKET))
        out = os.path.join(root, "out")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(MP_WORLD), "--master-addr",
               "localhost", "--master-port", str(free_port()), "-m", "opensora_torch.train", cfg_file,
               "--multi_host", "True", "--outputs", out, "--exp_name", "mh", "--dataset.data_path", csv, *extra]
        log(f"[{tag}] {' '.join(cmd[2:])}")
        t0 = time.perf_counter()
        with open(os.path.join(root, "torchrun.log"), "w") as f:
            proc = subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=f,
                                    stderr=subprocess.STDOUT, start_new_session=True)
            try:
                wait_all([proc], MP_TIMEOUT, tag)
            except AssertionError:
                with open(os.path.join(root, "torchrun.log")) as g:
                    log(f"[{tag}] torchrun's output (end):\n{g.read()[-8000:]}")
                raise
        wall_s = time.perf_counter() - t0
        exp = os.path.join(out, "mh")
        with open(os.path.join(exp, "log.txt")) as f:
            text = f.read()
        losses = [float(v) for v in re.findall(r" loss (-?\d+\.\d+|nan)", text)]
        read = [json.loads(v) for v in re.findall(r"samples by process (\[.*\])", text)]
        steps = [float(v) for v in re.findall(r"'time/step': (\d+\.\d+)", text)]
        procs = re.findall(r"multi_host: (\d+) processes, backend (\w+), devices (\[.*\])", text)
        meshes = re.findall(r"MMDiT sharded over (Mesh\(.*\))", text)
        ckpt = os.path.join(exp, f"epoch0-global_step{MP_CLI_STEPS}")
        t1 = time.perf_counter()
        saved = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu", weights_only=False)
        trainer = Trainer(parse_configs([cfg_file]), device)
        CheckpointIO().load(ckpt, trainer.state)
        again = trainer.state.state_dict()
        equal = (again["step"] == saved["step"] == MP_CLI_STEPS
                 and all(torch.equal(again["params"][n].cpu(), p) and torch.equal(again["ema"][n].cpu(),
                                                                                  saved["ema"][n])
                         for n, p in saved["params"].items())
                 and all(torch.equal(again["optimizer"]["adamw"]["state"][i][k].cpu(), st[k])
                         for i, st in saved["optimizer"]["adamw"]["state"].items() for k in ("exp_avg", "exp_avg_sq")))
        load_s = time.perf_counter() - t1
        ckpt_gb = os.path.getsize(os.path.join(ckpt, "state.pt")) / 1e9
        del trainer, again, saved
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = dict(depth=[depth, single], wall_s=wall_s, losses=losses, step_s=steps, samples_by_process=read,
               log_writers=text.count("experiment dir"), processes=procs, meshes=meshes, checkpoint_gb=ckpt_gb,
               checkpoint_equal=equal, load_and_compare_s=load_s)
    log(f"[{tag}] " + json.dumps(res))
    if len(procs) != 1 or int(procs[0][0]) != MP_WORLD:
        raise AssertionError(f"{tag}: the run's processes were not logged once: {procs}")
    log(f"[{tag}] backend {procs[0][1]}, the processes' devices {procs[0][2]}, mesh {meshes}")
    if not (len(losses) == MP_CLI_STEPS and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if res["log_writers"] != 1:
        raise AssertionError(f"{tag}: {res['log_writers']} log.txt writers")
    if extra:  # one data coordinate: both processes read the same clips, and the mesh spans them
        if not (len(read) == MP_CLI_STEPS and all(r[0] == r[1] for r in read)
                and len(meshes) == 1 and "'tp': 2" in meshes[0] and "in 2 processes" in meshes[0]):
            raise AssertionError(f"{tag}: the processes' samples {read} differ, or the mesh {meshes}")
    elif not (len(read) == MP_CLI_STEPS and all(not set(r[0]) & set(r[1]) for r in read)
              and len({i for r in read for p in r for i in p}) == MP_WORLD * MP_CLI_STEPS):
        raise AssertionError(f"{tag}: the processes' samples {read} are not disjoint")
    if not equal:
        raise AssertionError(f"{tag}: the checkpoint loaded into one process differs from the file")
    return res


# Phase 23: the full-width HunyuanVAE (stage1.py's ae, random bf16 weights from
# seed 42) on one 33-frame 256 x 256 clip, encoded and decoded with its height
# over VAE_CP_SP logical ranks, against the unsharded VAE on the card. The two
# bf16 passes round differently (the sharded group norms apply whole-height
# fp32 statistics themselves, F.group_norm its own), and a random-weight VAE
# carries a rounding through its ~30 layers to the output: the first card run
# read 2.1e-2 (encode) and 5.2e-2 (decode) in relative L2 between them, as far
# as the unsharded bf16 pass itself lies from the fp32 pass. So the limit of
# each pass is VAE_CP_FP32_FACTOR times the unsharded bf16 pass's relative L2
# from the CPU's fp32 pass, measured in the same run on a small clip
# (VAE_CP_SMALL), where the sharded bf16 pass must also lie no farther from
# the fp32 pass than VAE_CP_SHARDED_FACTOR times the unsharded one. The halo
# convolutions are held alone to the kernels' limit (OUT_RTOL of the largest
# value), and the known-wrong variants must exceed the encode's limit.
VAE_CP_SP = (2, 4)
VAE_CP_FRAMES, VAE_CP_SIZE = 33, 256
VAE_CP_SMALL = (9, 32)  # frames, side: 32 rows split over 4 ranks at every level
VAE_CP_FP32_FACTOR = 2.0
VAE_CP_SHARDED_FACTOR = 1.25


def rel_l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def max_rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _own_edges(halo):
    """Known-wrong: every strip replicate-pads its own edges (no halo rows
    from the neighbours)."""
    from opensora_torch.parallel.vae_sharding import ONE_STRIP

    return lambda self, xs, top, bottom: [halo(ONE_STRIP, [x], top, bottom)[0] for x in xs]


def _per_strip_moments(moments):
    """Known-wrong: each strip's own group-norm statistics."""
    def wrong(self, xs, num_groups):
        flat = [x.float().reshape(x.shape[0], num_groups, -1) for x in xs]
        return [f.mean(-1, keepdim=True) for f in flat], [f.var(-1, unbiased=False, keepdim=True) for f in flat]

    return wrong


def vae_cp_clip(device, frames: int, size: int, seed: int) -> torch.Tensor:
    """(1, 3, frames, size, size) in [-1, 1]: a vertical ramp under seeded
    noise, so that a strip's group-norm statistics are not the whole
    height's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ramp = torch.linspace(-0.8, 0.8, size, device=device)[:, None]
    return (0.2 * torch.randn((1, 3, frames, size, size), generator=gen, device=device) + ramp).clamp(-1, 1)


def vae_fingerprint(vae) -> list:
    """The sum and the sum of squares of every weight, in float64: equal in
    two processes that built the VAE from one seed."""
    weights = [p.detach().double() for p in vae.parameters()]
    return [float(sum(w.sum() for w in weights)), float(sum(w.square().sum() for w in weights))]


def run_vae_cp_path(device, carry: dict) -> dict:
    """Phase 23: HunyuanVAE context parallelism over height
    (``parallel/vae_sharding.make_sharded_vae_fn``) on logical ranks of the
    card. On a small clip, the unsharded and the sp-4 bf16 passes against
    the CPU's fp32 VAE (the limits, see VAE_CP_FP32_FACTOR). On the full
    clip: the halo convolutions alone (conv_in and the first stride-2
    downsampler over 4 strips) within OUT_RTOL of the unsharded
    convolution; the encode (posterior mode) and the decode unsharded, then
    over a (1, sp, 1) mesh for each of VAE_CP_SP, within the limits in
    relative L2 of the unsharded result; exact D = 512 launches (one
    mid-block attention per encode and per decode: the ranks share the
    card, so the gathered attention runs once), the time of a second call
    and the peak of each. Two known-wrong sharded encodes at sp 4 must
    exceed the encode's limit: interior strip edges replicate-padded,
    per-strip group-norm statistics."""
    import copy

    from opensora_torch.models.hunyuan_vae.model import CausalVAE3D_HUNYUAN
    from opensora_torch.ops import _build
    from opensora_torch.parallel.comm import shard
    from opensora_torch.parallel.vae_sharding import HeightStrips, make_sharded_vae_fn
    from opensora_torch.utils.config import parse_configs

    cfg = parse_configs([STAGE1_CFG])
    torch.manual_seed(cfg.seed)
    vae = CausalVAE3D_HUNYUAN(device=device, **{k: v for k, v in dict(cfg.ae).items() if k != "type"}).eval()
    sp_max = VAE_CP_SP[-1]
    log(f"[vae_cp] full-width HunyuanVAE, {VAE_CP_FRAMES}x{VAE_CP_SIZE}x{VAE_CP_SIZE}, height over sp "
        f"{list(VAE_CP_SP)} logical ranks; limits from a {VAE_CP_SMALL} clip against the CPU's fp32 VAE")

    # the limits: the bf16 passes against the fp32 pass on a small clip
    small = vae_cp_clip(device, *VAE_CP_SMALL[:1], VAE_CP_SMALL[1], cfg.seed + 1)
    cpu = copy.deepcopy(vae).float().cpu()
    mesh = logical_mesh(device, (1, sp_max, 1))
    with torch.no_grad():
        z32 = cpu.encode(small.float().cpu(), sample_posterior=False)
        zb = z32.to(device, torch.bfloat16)  # both decodes start from the bf16 latent
        y32 = cpu.decode(zb.float().cpu())
        del cpu
        fp32 = dict(unsharded=dict(encode=rel_l2(vae.encode(small, sample_posterior=False), z32),
                                   decode=rel_l2(vae.decode(zb), y32)),
                    sharded=dict(encode=rel_l2(make_sharded_vae_fn(vae, mesh, "encode")(small, sample_posterior=False),
                                               z32),
                                 decode=rel_l2(make_sharded_vae_fn(vae, mesh, "decode")(zb), y32)))
    limits = {w: VAE_CP_FP32_FACTOR * fp32["unsharded"][w] for w in ("encode", "decode")}
    log(f"[vae_cp] bf16 against fp32 on the small clip: {json.dumps(fp32)}; limits {json.dumps(limits)}")

    x = vae_cp_clip(device, VAE_CP_FRAMES, VAE_CP_SIZE, cfg.seed)
    cp = HeightStrips([device] * sp_max)
    with torch.no_grad():  # the halo convolutions alone, at the full clip
        conv_in, down = vae.encoder.conv_in, vae.encoder.down_blocks[0].downsamplers[0]
        h = conv_in(x.to(vae.dtype))
        halo = dict(conv_in=max_rel(torch.cat(conv_in.forward_strips(cp, shard(x.to(vae.dtype), 3, cp.devices)), 3),
                                    h),
                    downsample=max_rel(torch.cat(down.forward_strips(cp, list(h.chunk(sp_max, 3))), 3), down(h)))
        del h

    def run(fn, arg) -> tuple:
        free()
        torch.cuda.reset_peak_memory_stats(device)
        _build.LAUNCHES.clear()
        with torch.no_grad():
            out = fn(arg)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            fn(arg)
            torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0, launches=launches,
                   peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        return out, rec

    z_ref, rec_enc = run(lambda v: vae.encode(v, sample_posterior=False), x)
    y_ref, rec_dec = run(vae.decode, z_ref)
    # phase 30's references: the same VAE and clip, rebuilt from the seed in each process
    carry["vae_cp"] = dict(z_ref=z_ref.cpu(), y_ref=y_ref.cpu(), limits=limits, fingerprint=vae_fingerprint(vae))
    res = dict(shape=list(x.shape), latent=list(z_ref.shape), small_clip=list(small.shape), fp32=fp32, limits=limits,
               halo_convs_max_rel=halo, unsharded=dict(encode=rec_enc, decode=rec_dec), sp={}, controls={})
    for sp in VAE_CP_SP:
        mesh = logical_mesh(device, (1, sp, 1))
        enc = make_sharded_vae_fn(vae, mesh, "encode")
        z, rec_e = run(lambda v: enc(v, sample_posterior=False), x)
        y, rec_d = run(make_sharded_vae_fn(vae, mesh, "decode"), z_ref)
        for rec, out, ref in ((rec_e, z, z_ref), (rec_d, y, y_ref)):
            rec.update(rel_l2=rel_l2(out, ref), max_rel=max_rel(out, ref))
        res["sp"][sp] = dict(encode=rec_e, decode=rec_d)
        log(f"[vae_cp] sp {sp}: " + json.dumps(res["sp"][sp]))
        del z, y
    mesh = logical_mesh(device, (1, sp_max, 1))
    for name, attr, wrap in (("own_edges_replicated", "halo", _own_edges),
                             ("per_strip_group_norm", "group_moments", _per_strip_moments)):
        with patched(HeightStrips, attr, wrap), torch.no_grad():
            z = make_sharded_vae_fn(vae, mesh, "encode")(x, sample_posterior=False)
        res["controls"][name] = dict(rel_l2=rel_l2(z, z_ref), max_rel=max_rel(z, z_ref))
        del z
    log("[vae_cp] halo convolutions " + json.dumps(halo) + ", controls " + json.dumps(res["controls"]))
    del vae, x, z_ref, y_ref
    free()
    for w in ("encode", "decode"):
        if not fp32["sharded"][w] <= VAE_CP_SHARDED_FACTOR * fp32["unsharded"][w]:
            raise AssertionError(f"vae_cp {w}: the sharded bf16 pass lies {fp32['sharded'][w]} from fp32, the "
                                 f"unsharded {fp32['unsharded'][w]}")
    for name, err in halo.items():
        if not err <= OUT_RTOL:
            raise AssertionError(f"vae_cp halo {name}: {err} over {OUT_RTOL}")
    for sp, r in res["sp"].items():
        for w in ("encode", "decode"):
            rec = r[w]
            if not rec["rel_l2"] <= limits[w]:
                raise AssertionError(f"vae_cp sp {sp} {w}: {rec['rel_l2']} over {limits[w]}")
            if rec["launches"] != {"flash_attention_fwd_d512": 1}:
                raise AssertionError(f"vae_cp sp {sp} {w}: launches {rec['launches']}")
            check_peak(f"vae_cp sp {sp} {w}", rec["peak_mem_gb"])
    for w, rec in res["unsharded"].items():
        if rec["launches"] != {"flash_attention_fwd_d512": 1}:
            raise AssertionError(f"vae_cp unsharded {w}: launches {rec['launches']}")
    for name, c in res["controls"].items():
        if not c["rel_l2"] > limits["encode"]:
            raise AssertionError(f"vae_cp control {name} passed the limit {limits['encode']}: {c}")
    res["launches"] = {"flash_attention_fwd_d512": sum(r[w]["launches"]["flash_attention_fwd_d512"]
                                                       for r in res["sp"].values() for w in ("encode", "decode"))}
    return res


# ----------------------------------------------------------------------
# phase 31: the finetune loop through the dataset and checkpoint tools
# ----------------------------------------------------------------------

LOOP_DEPTH = (1, 1)  # phase 3d's cut: a full finetune's state takes 20 bytes a parameter on disk
LOOP_CLIPS = [(33, 16.0), (36, 12.0), (40, 16.0), (33, 8.0)]  # (frames, fps <= fps_max 16) of the seeded 256 x 256 mp4s
LOOP_IMAGES = [(256, 256), (192, 336)]  # (height, width) of the seeded pngs
LOOP_SIZE, LOOP_FRAMES, LOOP_BATCH, LOOP_BUCKET = 256, 33, 2, "256px"  # 2 clips a step: 2 steps
LOOP_STEPS = 2  # the inference CLI's steps, cut from 50
LOOP_PROMPT = "a red panda eating bamboo in a misty forest"
LOOP_CFG = """_base_ = [{base!r}]
model = dict(depth={depth}, depth_single_blocks={single})
bucket_config = {{"_delete_": True, {bucket!r}: {{{frames}: (1.0, {batch})}}}}
dataset = dict(type="video_text", data_path={table!r})
ae = dict(from_pretrained={vae!r})
t5 = dict(from_pretrained={t5!r})
clip = dict(from_pretrained={clip!r})
warmup_steps = 0
epochs = 1
log_every = 1
ckpt_every = 1000
"""


def write_loop_media(root: str) -> dict:
    """Phase 31(a)'s folder: LOOP_CLIPS as mp4 (moving seeded noise) and
    LOOP_IMAGES as png, through OpenCV; returns each file's (height,
    width, num_frames, fps) as written."""
    import cv2
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(31)
    written = {}
    for i, (frames, fps) in enumerate(LOOP_CLIPS):
        path = os.path.join(root, f"clip{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (LOOP_SIZE, LOOP_SIZE))
        base = rng.integers(0, 255, (LOOP_SIZE, LOOP_SIZE, 3), np.uint8)
        for k in range(frames):
            writer.write(np.roll(base, 4 * k, axis=1))
        writer.release()
        written[path] = (LOOP_SIZE, LOOP_SIZE, frames, fps)
    for i, (h, w) in enumerate(LOOP_IMAGES):
        path = os.path.join(root, f"still{i}.png")
        cv2.imwrite(path, rng.integers(0, 255, (h, w, 3), np.uint8))
        written[path] = (h, w, 1, 0.0)
    return written


def loop_train_expected(n_blocks: int, steps: list) -> dict:
    """The training CLI's launches: per step the D = 128 forward twice a
    block (forward and recompute), the fused backward and its dQ epilogue
    once a block, and one D = 512 mid-block attention per clip and per
    single frame the visual conditions encode."""
    n = len(steps)
    return {"flash_attention_fwd_sm90": 2 * n_blocks * n, "flash_attention_bwd_fused": n_blocks * n,
            "flash_attention_bwd_dq_convert": n_blocks * n,
            "flash_attention_fwd_d512": sum(s["clips"] + s["single_frames"] for s in steps)}


def image_launches(res: dict, kernel: str) -> dict:
    """Phase 33's launches of ``kernel``, per bucket's step."""
    return {f"{s['size'][0]}x{s['size'][1]}_b{s['batch']}": s["launches"].get(kernel, 0) for s in res["steps"]}


def loop_launches(res: dict, kernel: str) -> dict:
    """Phase 31's launches of ``kernel``, per part."""
    parts = dict(train=res["train"]["launches"], serve=res["serve"]["launches"], cache=res["cache"]["launches"],
                 cached_step=res["cache"]["cached_step"]["launches"])
    return {part: launches.get(kernel, 0) for part, launches in parts.items()}


def run_finetune_loop_path(device, vae_file: str, text_dirs: dict, root: str) -> dict:
    """Phase 31: a finetune from a folder of clips to a video sampled from
    its own exported weights, through the entry points a user calls, with
    phase 13's HunyuanVAE file and T5-XXL / CLIP-L directories as the
    config's from_pretrained. (a) ``cnv.meta`` over the folder (4 seeded
    mp4s, 2 pngs) and over a caption table of it: each row's height,
    width, frames and fps as written. (b) The training CLI on that table
    with stage1.py at full width and LOOP_DEPTH blocks (fp32 masters, the
    EMA), 2 steps of 2 clips, a checkpoint at the end (its write, and its
    read as ``--load`` reads it, timed).
    (c) ``cnv.export --source ema --layout published``: unfused q/k/v and
    v_mlp, no qkv / linear1; loaded back with ``load_checkpoint`` into the
    fp32 model, every tensor equals the trainer's EMA bitwise. (d) The
    inference CLI on 256px.py at LOOP_DEPTH from the export, LOOP_STEPS
    steps at 129 x 192 x 336: its MMDiT equals the in-memory EMA cast to
    bf16, and its final latent equals the latent ``api_fn`` gives from
    that in-memory model on the same call, bitwise. (e) ``cnv.cache`` over
    (a)'s table with (b)'s config: each latent equals the trainer's video
    path (``Trainer.encode_rows``) on the same clips from the generator
    seeded with ``seed``, each T5 / CLIP row the trainer's encoders', and
    one ``cached_video`` step runs on the cache with ``--model.cond_embed
    False`` (R4). (f) ``cnv.verify_pretrained`` on (c)'s file and on the
    VAE file: both reports, the RoPE pairings within 1e-3. Exact launches
    of (b), (d) and (e)'s training step; the checkpoint and the export are
    deleted with ``root``'s files at the end."""
    import numpy as np

    import opensora_torch.utils.api as api
    import opensora_torch.utils.ckpt as ckpt_mod
    import opensora_torch.utils.safetensors_io as st_io
    from opensora_torch import inference, train
    from opensora_torch.cnv import cache, export, meta, verify_pretrained
    from opensora_torch.datasets.dataloader import prepare_dataloader
    from opensora_torch.datasets.datasets import read_data_file
    from opensora_torch.ops import _build
    from opensora_torch.registry import DATASETS, build_module
    from opensora_torch.utils.config import ae_spatial_compression, parse_configs
    from opensora_torch.utils.train import single_frame_encodes

    res = {}
    depth, single = LOOP_DEPTH
    n_blocks = depth + single
    loop = os.path.join(root, "finetune_loop")
    # (a) the table
    t0 = time.perf_counter()
    written = write_loop_media(os.path.join(loop, "media"))
    captions = os.path.join(loop, "captions.csv")
    with open(captions, "w") as f:
        f.write("path,text\n" + "".join(f"{p},{LOOP_PROMPT} {i}\n" for i, p in enumerate(sorted(written))))
    folder_table = meta.main([os.path.join(loop, "media"), os.path.join(loop, "folder.csv")])
    table = os.path.join(loop, "meta.csv")
    meta.main([captions, table])
    rows = {r["path"]: (r["height"], r["width"], r["num_frames"], r["fps"]) for r in read_data_file(table)}
    res["meta"] = dict(rows=len(rows), seconds=time.perf_counter() - t0, columns=read_data_file(table).columns)
    log(f"[loop] (a) meta: {json.dumps(res['meta'])}")
    folder_rows = {r["path"]: (r["height"], r["width"], r["num_frames"], r["fps"]) for r in folder_table}
    if rows != written or folder_rows != written:
        raise AssertionError(f"loop (a): meta's rows {rows} / {folder_rows} are not the files written {written}")

    # (b) train
    cfg_file = os.path.join(loop, "stage1_loop.py")
    with open(cfg_file, "w") as f:
        f.write(LOOP_CFG.format(base=STAGE1_CFG, depth=depth, single=single, bucket=LOOP_BUCKET, frames=LOOP_FRAMES,
                                batch=LOOP_BATCH, table=table, vae=vae_file, t5=text_dirs["t5"], clip=text_dirs["clip"]))
    steps, saves = [], []

    def wrap_run_batch(fn):
        def run(self, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, batch)
            torch.cuda.synchronize()
            steps.append(dict(seconds=time.perf_counter() - t, clips=len(batch["text"]),
                              single_frames=single_frame_encodes(self.mask_conds), loss=float(out["loss"])))
            return out
        return run

    def wrap_save(fn):
        def save(self, exp_dir, state, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            d = fn(self, exp_dir, state, *args, **kwargs)
            saves.append(dict(dir=d, seconds=time.perf_counter() - t,
                              gb=os.path.getsize(os.path.join(d, "state.pt")) / 1e9))
            return d
        return save

    free()
    torch.cuda.reset_peak_memory_stats(device)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    with patched(train.Trainer, "run_batch", wrap_run_batch), patched(ckpt_mod.CheckpointIO, "save", wrap_save):
        trainer = train.main([cfg_file, "--outputs", os.path.join(loop, "out"), "--exp_name", "loop", "--device",
                              str(device)])
    torch.cuda.synchronize()
    expect = loop_train_expected(n_blocks, steps)
    res["train"] = dict(wall_s=time.perf_counter() - t0, steps=steps, save=saves[-1], launches=dict(_build.LAUNCHES),
                        expected=expect, peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                        state_pt_gb_per_s_write=saves[-1]["gb"] / saves[-1]["seconds"])
    log(f"[loop] (b) train: {json.dumps(res['train'])}")
    if not (len(steps) == len(LOOP_CLIPS) // LOOP_BATCH and all(math.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"loop (b): steps {steps}")
    if res["train"]["launches"] != expect:
        raise AssertionError(f"loop (b): launches {res['train']['launches']} != {expect}")
    # the checkpoint read back as --load reads it (into the trainer's own state: the same values)
    ckpt = saves[-1]["dir"]
    t0 = time.perf_counter()
    ckpt_mod.CheckpointIO().load(ckpt, trainer.state)
    torch.cuda.synchronize()
    res["train"]["state_pt_read_s"] = time.perf_counter() - t0
    res["train"]["state_pt_gb_per_s_read"] = saves[-1]["gb"] / res["train"]["state_pt_read_s"]
    log(f"[loop] (b) state.pt: {saves[-1]['gb']:.3f} GB written in {saves[-1]['seconds']:.2f} s, read back "
        f"(--load, warm) in {res['train']['state_pt_read_s']:.2f} s")

    # (c) export
    exported = os.path.join(loop, "finetuned.safetensors")
    writes = []

    def wrap_write(fn):
        def write(tensors, path, *args, **kwargs):
            t = time.perf_counter()
            n = fn(tensors, path, *args, **kwargs)
            writes.append(dict(seconds=time.perf_counter() - t, gb=n / 1e9))
            return n
        return write

    t0 = time.perf_counter()
    with patched(st_io, "save_file", wrap_write):
        out = export.main([ckpt, exported, "--config", cfg_file, "--source", "ema", "--layout", "published"])
    export_s = time.perf_counter() - t0
    names = list(st_io.SafetensorsFile(exported).keys())
    cfg = parse_configs([cfg_file])
    ema = trainer.state.ema
    t0 = time.perf_counter()
    back = ckpt_mod.load_checkpoint(export.build_meta(cfg.model), exported, "mmdit", device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    differ = [n for n, p in back.state_dict().items() if not torch.equal(p, ema[n])]
    # state.pt is mapped: the EMA's pages are read as save_file writes them
    res["export"] = dict(n_tensors=out["n_tensors"], gb=out["bytes"] / 1e9, seconds=export_s,
                         read_and_write_s=writes[-1]["seconds"], load_back_s=load_s, differ_from_ema=len(differ))
    log(f"[loop] (c) export: {json.dumps(res['export'])}")
    del back
    free()
    unfused = all(any(f".{p}." in n for n in names) for p in ("q_proj", "k_proj", "v_proj", "v_mlp"))
    if not unfused or any(".qkv." in n or ".linear1." in n for n in names):
        raise AssertionError(f"loop (c): not the published layout: {names[:12]}")
    if differ:
        raise AssertionError(f"loop (c): the exported weights differ from the EMA: {differ[:8]}")

    # (d) serve
    seen, calls = {}, []

    def wrap_models(fn):
        def build(*args, **kwargs):
            built = fn(*args, **kwargs)
            seen["models"] = built[:4]
            seen["latents"] = LatentRecorder(built[1]).__enter__()
            return built
        return build

    def wrap_api(fn):
        def make(*args, **kwargs):
            api_fn = fn(*args, **kwargs)

            def call(*a, **k):
                calls.append((a, k))
                return api_fn(*a, **k)
            return call
        return make

    overrides = [MAIN_CFG, "--model.from_pretrained", exported, "--model.depth", str(depth),
                 "--model.depth_single_blocks", str(single), "--sampling_option.num_steps", str(LOOP_STEPS),
                 "--sampling_option.seed", "42", "--ae.from_pretrained", vae_file, "--t5.from_pretrained", text_dirs["t5"], "--clip.from_pretrained",
                 text_dirs["clip"], "--save_dir", os.path.join(loop, "samples")]
    argv = [*overrides, "--prompt", LOOP_PROMPT, "--device", str(device)]
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        with LoadRecorder() as loads, patched(api, "prepare_models", wrap_models), patched(api, "prepare_api",
                                                                                             wrap_api):
            paths = inference.main(argv)
        torch.cuda.synchronize()
    finally:
        if "latents" in seen:
            seen["latents"].__exit__(None, None, None)
    serve_s = time.perf_counter() - t0
    serve_launches = dict(_build.LAUNCHES)
    model, ae, t5, clip = seen.pop("models")
    latent = seen["latents"].latents[-1]
    cfg_inf = parse_configs(overrides)
    serve_expect = {"flash_attention_fwd_sm90": n_blocks * LOOP_STEPS,
                    "flash_attention_fwd_d512": hunyuan_mid_launches(ae, tuple(latent.shape), decode=True)}
    in_memory = build_module(dict(cfg_inf.model, from_pretrained=None), api.MODELS, device="meta")
    in_memory.load_state_dict({n: ema[n].to(device, p.dtype) for n, p in in_memory.state_dict().items()},
                              strict=True, assign=True)
    in_memory.eval().requires_grad_(False)
    weights_equal = all(torch.equal(p, in_memory.state_dict()[n]) for n, p in model.state_dict().items())
    del model
    free()
    with LatentRecorder(ae) as rec:
        api.prepare_api(in_memory, ae, t5, clip, spatial_compression=ae_spatial_compression(cfg_inf))(
            *calls[0][0], **calls[0][1])
    in_memory_latent = rec.latents[-1]
    res["serve"] = dict(wall_s=serve_s, sample=[os.path.basename(p) for p in paths], latent_shape=list(latent.shape),
                        weights_equal_in_memory=weights_equal,
                        latent_bitwise_equal=bool(torch.equal(latent, in_memory_latent)),
                        latent_max_abs_diff=float((latent - in_memory_latent).abs().max()),
                        export_load=[dict(gb=d["gb"], seconds=d["seconds"], gb_per_s=d["gb_per_s"])
                                     for d in loads.loads if d["kind"] == "mmdit"],
                        launches=serve_launches, expected=serve_expect)
    log(f"[loop] (d) serve: {json.dumps(res['serve'])}")
    del in_memory, ae, t5, clip
    free()
    if not (len(paths) == 1 and weights_equal and res["serve"]["latent_bitwise_equal"]
            and torch.isfinite(latent).all()):
        raise AssertionError(f"loop (d): {res['serve']}")
    if serve_launches != serve_expect:
        raise AssertionError(f"loop (d): launches {serve_launches} != {serve_expect}")

    # (e) cache
    cache_dir = os.path.join(loop, "cache")
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    meta_csv = cache.main([cfg_file, "--out_dir", cache_dir, "--device", str(device)])
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    cache_launches = dict(_build.LAUNCHES)
    cached = read_data_file(meta_csv)
    loader, _ = prepare_dataloader(build_module(dict(cfg.dataset), DATASETS), bucket_config=cfg.bucket_config,
                                   batch_size=cfg.get("batch_size", 1), shuffle=False, seed=cfg.seed,
                                   spatial_compression=ae_spatial_compression(cfg))
    trainer.gen = torch.Generator(device=device).manual_seed(cfg.seed)
    n, bad, encodes = 0, [], 0
    with torch.inference_mode():
        for batch in loader:
            x = torch.as_tensor(batch["video"]).to(device, torch.float32)
            texts = list(batch["text"])
            z = trainer.encode_rows(x, train.Rows(0, x.shape[0], x.shape[0])).float().cpu().numpy()
            t5_emb, clip_emb = trainer.t5(texts).float().cpu().numpy(), trainer.clip(texts).float().cpu().numpy()
            encodes += hunyuan_mid_launches(trainer.ae, tuple(x.shape), decode=False)
            for i in range(x.shape[0]):
                row = cached[n]
                for key, want in (("latent_path", z[i]), ("t5_path", t5_emb[i]), ("clip_path", clip_emb[i])):
                    if not np.array_equal(np.load(row[key]), want):
                        bad.append((n, key))
                if row["text"] != texts[i]:
                    bad.append((n, "text"))
                n += 1
    del trainer
    free()
    cfg_cached = [cfg_file, "--cached_video", "True", "--model.cond_embed", "False", "--dataset.type",
                  "cached_video_text", "--dataset.data_path", meta_csv]
    cached_cfg = parse_configs(cfg_cached)
    step_trainer = train.Trainer(cached_cfg, device)
    cached_loader, _ = prepare_dataloader(build_module(dict(cached_cfg.dataset), DATASETS), batch_size=LOOP_BATCH,
                                          shuffle=False, spatial_compression=ae_spatial_compression(cached_cfg))
    _build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step_trainer.run_batch(next(iter(cached_loader)))
    loss = float(metrics["loss"])
    cached_step_s = time.perf_counter() - t0
    cached_launches = dict(_build.LAUNCHES)
    cached_expect = {"flash_attention_fwd_sm90": 2 * n_blocks, "flash_attention_bwd_fused": n_blocks,
                     "flash_attention_bwd_dq_convert": n_blocks}
    del step_trainer
    free()
    res["cache"] = dict(rows=len(cached), seconds=cache_s, differ=bad, launches=cache_launches,
                        expected={"flash_attention_fwd_d512": encodes}, cached_step=dict(
                            loss=loss, seconds=cached_step_s, launches=cached_launches, expected=cached_expect))
    log(f"[loop] (e) cache: {json.dumps(res['cache'])}")
    if n != len(cached) or n != len(LOOP_CLIPS) or bad:
        raise AssertionError(f"loop (e): {n} rows replayed of {len(cached)}; differ: {bad}")
    if cache_launches != res["cache"]["expected"] or cached_launches != cached_expect or not math.isfinite(loss):
        raise AssertionError(f"loop (e): {res['cache']}")

    # (f) verify
    t0 = time.perf_counter()
    reports = {"mmdit": verify_pretrained.main(["mmdit", exported, "--device", str(device)]),
               "vae": verify_pretrained.main(["vae", vae_file, "--device", str(device)])}
    res["verify"] = dict(seconds=time.perf_counter() - t0, reports=reports)
    log(f"[loop] (f) verify: {json.dumps(res['verify'])}")
    if not (reports["mmdit"]["rope_convention_max_delta"] < verify_pretrained.ROPE_TOL
            and reports["mmdit"]["depth"] == depth and reports["mmdit"]["depth_single"] == single
            and reports["mmdit"]["fwd"]["finite"] and reports["vae"]["latent"]["finite"]
            and reports["vae"]["recon"]["finite"]):
        raise AssertionError(f"loop (f): {reports}")
    shutil.rmtree(loop, ignore_errors=True)  # the checkpoint, the export and the cache
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
    if MP_WORKER in argv:  # one of phase 24's processes
        return multi_process_worker(argv[argv.index(MP_WORKER) + 1])
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

    def build_all():
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            return dict(zip(sources, pool.map(_build.build, sources)))

    start = time.perf_counter()
    built = timed("phase 1 build", build_all)
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

    attn = timed("phase 2 flash forward", check_attention, device)
    attn_bwd = timed("phase 2b flash backward", check_attention_bwd, device)
    attn_bwd_d512 = timed("phase 2d D=512 backward", check_attention_bwd, device, BWD_D512_CASES, seed=8)
    gemm = timed("phase 2c W8A8 GEMMs", check_int8_gemm, device)
    int8_attn = timed("phase 2c int8 attention", check_int8_attention, device, mufu_per_s)
    ring = timed("phase 2e ring", check_ring, device)
    small = timed("phase 3 small input", check_small_input, device)
    small_train = timed("phase 3 LoRA small input", check_train_small_input, device)
    small_int8 = timed("phase 3b int8 small input", check_int8_small_input, device)
    small_vae = timed("phase 3c VAE small input", check_vae_train_small_input, device)
    small_ring = timed("phase 3d ring small input", check_small_input, device, ring_mesh(device))
    small_ring_train = timed("phase 3d ring LoRA small input", check_train_small_input, device, ring_mesh(device))
    small_t2i = timed("phase 3e image stage small input", check_t2i_small_input, device)
    small_tp = timed("phase 3h TP / FSDP small input", check_tp_small_input, device)
    records: dict = {}  # first calls of phases 4, 6 and 11, replayed by phase 13
    main_res, built = timed("phase 4 256px", run_main_path, device, "--profile" in argv, out_dir, records)
    main_res["small_input"] = small
    ring_res = timed("phase 9 ring 256px", run_ring_path, device, built, "--profile" in argv, out_dir)
    ring_res["small_input"] = small_ring
    res_768 = timed("phase 18 768px", run_768px_path, device, built, "--profile" in argv, out_dir)
    with tempfile.TemporaryDirectory() as tmp:
        t2i2v_res = timed("phase 11 t2i2v", run_t2i2v_path, device, built, tmp, "--profile" in argv, out_dir, records)
        t2i2v_res["small_input"] = small_t2i
        t2i2v_768_res = timed("phase 19 t2i2v 768px", run_t2i2v_768px_path, device, built, tmp)
        v2v_res = timed("phase 12 v2v", run_v2v_path, device, built, tmp)
    tp_res = timed("phase 20 TP 256px", run_tp_path, device, built, "--profile" in argv, out_dir)  # shards phase 4's MMDiT: the last user
    tp_res["small_input"] = small_tp
    del built
    gc.collect()
    torch.cuda.empty_cache()
    train_res, built = timed("phase 5 LoRA training", run_train_path, device, "--profile" in argv, out_dir)
    train_res["small_input"] = small_train
    ring_train_res = timed("phase 10 ring LoRA training", run_ring_train_path, device, built, "--profile" in argv, out_dir)
    ring_train_res["small_input"] = small_ring_train
    del built
    gc.collect()
    torch.cuda.empty_cache()
    carry: dict = {}  # phase 21's saved state, batch and unsharded step, for phase 22
    fsdp_res = timed("phase 21 FSDP training", run_fsdp_train_path, device, "--profile" in argv, out_dir, carry)
    pp_res = timed("phase 22 GPipe training", run_pp_train_path, device, carry)
    sp_train_res = timed("phase 27 stage2 over sp", run_sp_train_path, device, carry)
    image_res = timed("phase 33 image.py", run_image_train_path, device, carry)
    i2v_train_res = timed("phase 34 stage1_i2v.py", run_stage1_i2v_path, device, carry)
    vae_cp_res = timed("phase 23 VAE context parallel", run_vae_cp_path, device, carry)  # phase 30's references
    mp_res = timed("phase 24 processes (and phases 28, 29 and 30 in them)", run_multi_process_path, device, carry)
    del carry
    with tempfile.TemporaryDirectory() as tmp:
        lora_res = timed("phase 25 LoRA over a sharded mesh", run_lora_sharded_path, device, tmp)
    int8_res, int8_built = timed("phase 6 int8", run_int8_path, device, [], STEPS, "--profile" in argv, out_dir,
                                 "int8", records, keep=True)
    int8_res["small_input"] = small_int8
    res_768_1chip = timed("phase 32 768px on one card (int8)", run_768px_1chip_path, device, int8_built, mufu_per_s)
    with tempfile.TemporaryDirectory() as tmp:
        int8_tp_res = timed("phase 26 int8 under TP", run_int8_tp_path, device, int8_built, tmp)
    del int8_built
    free()
    fq_res = timed("phase 6 w8a8_fq / int8", run_int8_path, device,
                   ["--model.quantized", "w8a8_fq", "--model.attn_backend", "int8"], INT8_FQ_STEPS, tag="int8_fq")
    log(f"[int8_fq] w8a8_fq / int8 denoise step: {[round(s, 3) for s in fq_res['step_s']]} s "
        f"({fq_res['launches'].get('w8a8_fq_matmul', 0)} launches of w8a8_fq_matmul; the w8a8 / int8_qk8 "
        f"steps {[round(s, 3) for s in int8_res['step_s']]} s)")
    with tempfile.TemporaryDirectory() as tmp:
        vae_res = timed("phase 7 HunyuanVAE training", run_vae_train_path, device, "hunyuan_vae", VAE_STEPS, 33,
                        write_lpips_files(tmp), "vae", "--profile" in argv, out_dir)
    vae_res["small_input"] = small_vae
    dcae_res = timed("phase 8 DC-AE training", run_vae_train_path, device, "dc_ae", DCAE_STEPS, 32, tag="dcae",
                     profile="--profile" in argv, out_dir=out_dir)
    text_root = tempfile.mkdtemp(prefix="chip_smoke_text_")  # phase 13's T5-XXL and CLIP-L, phase 17's files
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt_res = timed("phase 13 checkpoints", run_ckpt_path, device, records, tmp, text_root)
            vae_file = ckpt_res.pop("vae_file")
            cli_res = timed("phase 14 VAE CLIs", run_vae_cli_path, device, vae_file, tmp)
            loop_res = timed("phase 31 the finetune loop", run_finetune_loop_path, device, vae_file,
                             ckpt_res["text_dirs"], tmp)
        del records
        small_hc_train = timed("phase 3f full finetune small input", check_hc_train_small_input, device)
        with tempfile.TemporaryDirectory() as tmp:
            hc_res = timed("phase 15 high compression", run_hc_inference_path, device, tmp, "--profile" in argv, out_dir)
        hc_train_res = timed("phase 16 full finetune", run_hc_train_path, device, "--profile" in argv, out_dir)
        hc_train_res["small_input"] = small_hc_train
        small_clip = timed("phase 3g CLIP small input", check_clip_small_input, device)
        tok_res = timed("phase 17a tokenized 256px", run_tokenized_path, device, ckpt_res.pop("text_dirs"), text_root)
        eval_res = timed("phase 17b evaluation", run_eval_path, device, tok_res.pop("samples"), text_root)
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
                       for k in ("rebuild_256px", "image")},
        launches_hc=dict(t2v=hc_res["t2v"]["launches"]["flash_attention_fwd_sm90"],
                         i2v_head=hc_res["i2v_head"]["launches"]["flash_attention_fwd_sm90"],
                         train=hc_train_res["launches"]["flash_attention_fwd_sm90"],
                         rf_eval_loss=hc_train_res["eval_launches"]["flash_attention_fwd_sm90"]),
        launches_tokenized_t2v=tok_res["launches"]["flash_attention_fwd_sm90"],
        launches_768px=dict(t2v=res_768["launches"]["flash_attention_fwd_sm90"],
                            t2i2v_image=t2i2v_768_res["image_launches"]["flash_attention_fwd_sm90"],
                            t2i2v_video=t2i2v_768_res["launches"]["flash_attention_fwd_sm90"]),
        launches_768px_1chip=res_768_1chip["runs"]["bf16attn"]["launches"].get("flash_attention_fwd_sm90", 0),
        launches_image_train=image_launches(image_res, "flash_attention_fwd_sm90"),
        launches_stage1_i2v=i2v_train_res["launches"].get("flash_attention_fwd_sm90", 0),
        launches_tp=tp_res["launches"]["flash_attention_fwd_sm90"],
        launches_fsdp=fsdp_launches(fsdp_res, "flash_attention_fwd_sm90"),
        launches_pp=pp_launches(pp_res, "flash_attention_fwd_sm90"),
        launches_multi_process=mp_launches(mp_res, "flash_attention_fwd_sm90"),
        launches_lora_sharded=lora_sharded_launches(lora_res, "flash_attention_fwd_sm90"),
        launches_sp_train=sp_train_launches(sp_train_res, "flash_attention_fwd_sm90"),
        launches_sp_processes=sp_proc_launches(mp_res, "flash_attention_fwd_sm90"),
        launches_tp_pp_processes=tp_pp_launches(mp_res, "flash_attention_fwd_sm90"),
        launches_ring_sp_step=ring_res["sp_ring"]["launches"].get("flash_attention_fwd_sm90", 0),
        launches_finetune_loop=loop_launches(loop_res, "flash_attention_fwd_sm90"),
        max_abs_err=max([c["max_abs_err"] for c in sm90_cases] + [res_768["attention"]["max_abs_err"],
                                                                   res_768_1chip["attention"]["max_abs_err"]]),
        ms=head["ms"], ms_is="flash_attention_with_lse (the bound A on the device, then the kernel), the mean of "
        "4 readings in turns with SDPA's 4 (library_ms)", anchor_ms=head["anchor_ms"],
        running_max_ms=sm90_cases[1]["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        cases=sm90_cases + [res_768.pop("attention"), res_768_1chip.pop("attention")],
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
        launches_768px=dict(t2v_decode=res_768["launches"].get("flash_attention_fwd_d512", 0),
                            t2i2v_encode_and_decode=t2i2v_768_res["launches"]["flash_attention_fwd_d512"]),
        launches_768px_1chip_decode=res_768_1chip["runs"]["int8attn"]["launches"].get("flash_attention_fwd_d512", 0),
        launches_image_train=image_launches(image_res, "flash_attention_fwd_d512"),
        launches_stage1_i2v=i2v_train_res["launches"].get("flash_attention_fwd_d512", 0),
        launches_pp=pp_launches(pp_res, "flash_attention_fwd_d512"),
        launches_multi_process=mp_launches(mp_res, "flash_attention_fwd_d512"),
        launches_lora_sharded=lora_sharded_launches(lora_res, "flash_attention_fwd_d512"),
        launches_vae_cp={f"sp{sp}": {w: r[w]["launches"]["flash_attention_fwd_d512"] for w in ("encode", "decode")}
                         for sp, r in vae_cp_res["sp"].items()},
        launches_vae_cp_processes=vae_cp_proc_launches(mp_res),
        launches_finetune_loop=loop_launches(loop_res, "flash_attention_fwd_d512"),
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
        launches_fsdp=fsdp_launches(fsdp_res, "flash_attention_bwd_fused"),
        launches_pp=pp_launches(pp_res, "flash_attention_bwd_fused"),
        launches_multi_process=mp_launches(mp_res, "flash_attention_bwd_fused"),
        launches_lora_sharded=lora_sharded_launches(lora_res, "flash_attention_bwd_fused"),
        launches_sp_train=sp_train_launches(sp_train_res, "flash_attention_bwd_fused"),
        launches_sp_processes=sp_proc_launches(mp_res, "flash_attention_bwd_fused"),
        launches_tp_pp_processes=tp_pp_launches(mp_res, "flash_attention_bwd_fused"),
        launches_finetune_loop=loop_launches(loop_res, "flash_attention_bwd_fused"),
        launches_image_train=image_launches(image_res, "flash_attention_bwd_fused"),
        launches_stage1_i2v=i2v_train_res["launches"].get("flash_attention_bwd_fused", 0),
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
        launches_fsdp=fsdp_launches(fsdp_res, "flash_attention_bwd_dq_convert"),
        launches_pp=pp_launches(pp_res, "flash_attention_bwd_dq_convert"),
        launches_multi_process=mp_launches(mp_res, "flash_attention_bwd_dq_convert"),
        launches_lora_sharded=lora_sharded_launches(lora_res, "flash_attention_bwd_dq_convert"),
        launches_sp_train=sp_train_launches(sp_train_res, "flash_attention_bwd_dq_convert"),
        launches_sp_processes=sp_proc_launches(mp_res, "flash_attention_bwd_dq_convert"),
        launches_tp_pp_processes=tp_pp_launches(mp_res, "flash_attention_bwd_dq_convert"),
        launches_finetune_loop=loop_launches(loop_res, "flash_attention_bwd_dq_convert"),
        launches_image_train=image_launches(image_res, "flash_attention_bwd_dq_convert"),
        launches_stage1_i2v=i2v_train_res["launches"].get("flash_attention_bwd_dq_convert", 0),
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
        fq_kernel = name == "w8a8_fq_matmul"
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
            launches_int8_tp=int8_tp_res["launches"].get(name, 0),
            launches_768px_1chip={tag: r["launches"].get(name, 0) for tag, r in res_768_1chip["runs"].items()},
            max_abs_err=max([c[name]["max_abs_err"] for c in gemm["cases"]]
                            + ([c["max_abs_err"] for c in res_768_1chip["gemm"]["cases"]] if not fq_kernel else [])),
            ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape_mkn=gemm_head["shape_mkn"],
            library="torch._int_mm + the fp32 rescale epilogue" if head["library_ms"] is not None else None,
            cases=[dict(name=c["name"], shape_mkn=c["shape_mkn"], **c[name]) for c in gemm["cases"]],
            **({} if fq_kernel else {"cases_768px_1chip": res_768_1chip["gemm"]["cases"]}),
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
            launches_int8_tp=int8_tp_res["launches"].get(name, 0),
            launches_768px_1chip=res_768_1chip["runs"]["int8attn"]["launches"].get(name, 0),
            max_abs_err=max([c["max_abs_err"] for c in mine]
                            + ([res_768_1chip["int8_attention"]["max_abs_err"]] if mode == "qk8" else [])),
            ms=head["ms"], ms_is="the kernel alone on the preamble's output, the mean of 4 readings in turns with "
            "the wrapper's and bf16 SDPA's", ms_turns=head["ms_turns"], wrapper_ms=head["wrapper_ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], library=head["library"],
            ptxas=[r for r in ptxas["int8_flash_attention"] if r["kernel"].startswith(f"int8_flash_fwd_kernel<{pv}")],
            cases=mine + ([res_768_1chip["int8_attention"]] if mode == "qk8" else []),
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
            launches_sp_processes=sp_proc_launches(mp_res, name),
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
    log("[768px] " + json.dumps(res_768))
    log("[768px_1chip] " + json.dumps({k: v for k, v in res_768_1chip.items() if k not in ("gemm", "int8_attention")}))
    log("[image] " + json.dumps(image_res))
    log("[stage1_i2v] " + json.dumps(i2v_train_res))
    log("[t2i2v_768px] " + json.dumps(t2i2v_768_res))
    log("[v2v] " + json.dumps(v2v_res))
    log("[ring_train] " + json.dumps(ring_train_res))
    log("[tp] " + json.dumps(tp_res))
    log("[fsdp] " + json.dumps(fsdp_res))
    log("[pp] " + json.dumps(pp_res))
    log("[multi_process] " + json.dumps(mp_res))
    log("[lora_sharded] " + json.dumps(lora_res))
    log("[sp_train] " + json.dumps(sp_train_res))
    log("[int8_tp] " + json.dumps(int8_tp_res))
    log("[vae_cp] " + json.dumps(vae_cp_res))
    log("[train] " + json.dumps(train_res))
    log("[int8] " + json.dumps(int8_res))
    log("[int8_fq] " + json.dumps(fq_res))
    log("[vae] " + json.dumps(vae_res))
    log("[dcae] " + json.dumps(dcae_res))
    log("[ckpt] " + json.dumps(ckpt_res))
    log("[vae_cli] " + json.dumps(cli_res))
    log("[loop] " + json.dumps({k: v for k, v in loop_res.items() if k != "verify"}))
    log("[hc] " + json.dumps(hc_res))
    log("[hc_train] " + json.dumps(hc_train_res))
    log("[tok] " + json.dumps(tok_res))
    log("[eval] " + json.dumps({k: v for k, v in eval_res.items() if k not in ("pooled", "suite", "pooled_twice")}))
    log(f"[time] total: {time.perf_counter() - start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
