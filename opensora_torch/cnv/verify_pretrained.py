"""A published checkpoint's gate (counterpart of
scripts/cnv/verify_pretrained.py): run it the moment the weights are on
disk.

    python -m opensora_torch.cnv.verify_pretrained mmdit Open_Sora_v2.safetensors [--src-rope split|interleaved]
    python -m opensora_torch.cnv.verify_pretrained vae   hunyuan_vae.safetensors
    python -m opensora_torch.cnv.verify_pretrained mmdit ckpt.safetensors --ref-npz reference_io.npz

Per kind it (1) reads the geometry from the file's keys and shapes (the
MMDiT: depths, width, heads, the projection layout, the optional heads;
the VAE: the default HunyuanVideo geometry, as the JAX tool builds it),
(2) loads the file strictly into that model (``utils.ckpt.load_checkpoint``
raises on a missing, unexpected or mis-shaped key), (3) runs a fixed-input
forward and prints its statistics, (4) for the MMDiT loads it into both
RoPE pairings and checks that their outputs agree within 1e-3, and (5)
with ``--ref-npz`` holding ``expected`` (outputs captured from another
implementation on the same inputs: :func:`mmdit_fixture_inputs`, the VAE's
:func:`vae_fixture_input`) asserts parity within 2e-3. The forward runs in
fp32 with plain attention (``attn_backend="xla"``, the VAE's mid-block
too), as the JAX tool runs it: those limits are fp32 limits, which a bf16
forward or a flash kernel's rounding would not meet. The report is the JAX tool's JSON. Runs on cuda
unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

ROPE_TOL = 1e-3  # the two RoPE pairings' outputs, max abs
REF_TOL = 2e-3  # --ref-npz, atol and rtol


def _stats(name: str, arr) -> dict:
    a = np.asarray(arr, np.float32)
    return {"tensor": name, "shape": list(a.shape), "mean": float(a.mean()), "std": float(a.std()),
            "absmax": float(np.abs(a).max()), "finite": bool(np.isfinite(a).all())}


def mmdit_fixture_inputs(in_ch: int, ctx: int, vec: int, cond: bool, guid: bool, t: int = 3, h: int = 8,
                         w: int = 12, lt: int = 8, seed: int = 0):
    """The MMDiT forward's deterministic inputs, numpy, ordered as the
    model's ``forward`` takes them (None where a head is absent): the
    arrays of the JAX tool's ``mmdit_fixture_inputs``, so that an
    ``expected`` captured on them holds for either."""
    from opensora_torch.utils.sampling import build_img_ids

    b, length = 1, t * (h // 2) * (w // 2)
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, length, in_ch)).astype(np.float32),
        build_img_ids(t, h, w, 2, b).numpy(),
        rng.normal(size=(b, lt, ctx)).astype(np.float32),
        np.zeros((b, lt, 3), np.float32),
        np.full((b,), 0.4, np.float32),
        rng.normal(size=(b, vec)).astype(np.float32),
        rng.normal(size=(b, length, in_ch + 4)).astype(np.float32) if cond else None,
        np.full((b,), 4.0, np.float32) if guid else None,
    )


def vae_fixture_input(seed: int = 0) -> np.ndarray:
    """The VAE forward's deterministic clip (1, 3, 5, 64, 64), the JAX
    tool's."""
    return (np.random.default_rng(seed).normal(size=(1, 3, 5, 64, 64)) * 0.5).astype(np.float32)


def mmdit_geometry(path: str) -> dict:
    """The MMDiT's configuration read from a checkpoint's keys and shapes."""
    from opensora_torch.utils.ckpt import StateDictReader

    with StateDictReader(path) as r:
        keys = r.keys()
        hidden, in_ch = r.shape("img_in.weight")
        head_dim = r.shape("double_blocks.0.img_attn.norm.query_norm.scale")[0]
        src_fused = "double_blocks.0.img_attn.qkv.weight" in r
        return dict(
            depth=1 + max(int(k.split(".")[1]) for k in keys if k.startswith("double_blocks.")),
            depth_single_blocks=1 + max(int(k.split(".")[1]) for k in keys if k.startswith("single_blocks.")),
            hidden_size=hidden, in_channels=in_ch, context_in_dim=r.shape("txt_in.weight")[1],
            vec_in_dim=r.shape("vector_in.in_layer.weight")[1],
            mlp_ratio=r.shape("double_blocks.0.img_mlp.0.weight")[0] / hidden, num_heads=hidden // head_dim,
            axes_dim=[16, 56, 56] if head_dim == 128 else [head_dim // 4, 3 * head_dim // 8, 3 * head_dim // 8],
            qkv_bias=f"double_blocks.0.img_attn.{'qkv' if src_fused else 'q_proj'}.bias" in r,
            guidance_embed="guidance_in.in_layer.weight" in r, cond_embed="cond_in.weight" in r,
            src_fused=src_fused, n_tensors=len(keys))


def verify_mmdit(path: str, ref_npz: Optional[str] = None, src_rope: str = "split", device=None) -> dict:
    """``src_rope``: the RoPE pairing the checkpoint was trained with:
    "split" for the published Open-Sora v2 weights, "interleaved" for
    original Flux files."""
    from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
    from opensora_torch.utils.ckpt import load_checkpoint
    from opensora_torch.utils.misc import resolve_device

    device = resolve_device(device)
    geo = mmdit_geometry(path)
    src_fused, n_tensors = geo.pop("src_fused"), geo.pop("n_tensors")
    report = {"kind": "mmdit", "depth": geo["depth"], "depth_single": geo["depth_single_blocks"],
              "hidden": geo["hidden_size"], "heads": geo["num_heads"], "cond_embed": geo["cond_embed"],
              "guidance_embed": geo["guidance_embed"], "n_tensors": n_tensors, "fused_qkv_src": src_fused,
              "src_rope_convention": src_rope}
    inputs = [None if a is None else torch.from_numpy(a).to(device)
              for a in mmdit_fixture_inputs(geo["in_channels"], geo["context_in_dim"], geo["vec_in_dim"],
                                            geo["cond_embed"], geo["guidance_embed"])]
    outs = {}
    for conv in ("interleaved", "split"):
        cfg = MMDiTConfig(**geo, fused_qkv=True, rope_convention=conv, ckpt_rope_convention=src_rope,
                          attn_backend="xla", dtype="fp32")
        model = load_checkpoint(MMDiTModel(cfg, device="meta", dtype=torch.float32), path, "mmdit", device).eval()
        with torch.inference_mode():
            outs[conv] = model(*inputs).float().cpu().numpy()
        del model
    report["fwd"] = _stats("mmdit_out", outs["split"])
    delta = float(np.abs(outs["split"] - outs["interleaved"]).max())
    report["rope_convention_max_delta"] = delta
    if not delta < ROPE_TOL:
        raise AssertionError(f"RoPE conventions disagree: {delta}")
    if ref_npz:
        np.testing.assert_allclose(outs["interleaved"], np.load(ref_npz)["expected"], atol=REF_TOL, rtol=REF_TOL)
        report["ref_parity"] = "PASS"
    return report


def verify_vae(path: str, ref_npz: Optional[str] = None, device=None, noise: Optional[np.ndarray] = None) -> dict:
    """The HunyuanVAE of the default geometry loaded from ``path``: the
    fixture clip encoded (the posterior's sample: ``noise``, else drawn from
    a generator seeded with 1) and decoded."""
    from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
    from opensora_torch.utils.ckpt import StateDictReader, load_checkpoint
    from opensora_torch.utils.misc import resolve_device

    device = resolve_device(device)
    vae = load_checkpoint(AutoencoderKLCausal3D(AutoEncoder3DConfig(dtype="fp32", attn_backend="xla"), device="meta",
                                                dtype=torch.float32), path, "hunyuan_vae", device).eval()
    with StateDictReader(path) as r:
        n_tensors = len(r.keys())
    x = torch.from_numpy(vae_fixture_input()).to(device)
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(1)
        z = vae.encode(x, generator=gen, noise=None if noise is None else torch.tensor(noise, device=device))
        y = vae.decode(z)
    z, y = z.float().cpu().numpy(), y.float().cpu().numpy()
    report = {"kind": "vae", "n_tensors": n_tensors, "latent": _stats("z", z), "recon": _stats("y", y),
              "recon_mse": float(np.mean((y - x.cpu().numpy()) ** 2))}
    if ref_npz:
        np.testing.assert_allclose(z, np.load(ref_npz)["expected"], atol=REF_TOL, rtol=REF_TOL)
        report["ref_parity"] = "PASS"
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    """Print the report and return it."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="python -m opensora_torch.cnv.verify_pretrained")
    p.add_argument("kind", choices=["mmdit", "vae"])
    p.add_argument("checkpoint")
    p.add_argument("--ref-npz", default=None,
                   help=".npz with 'expected' outputs captured on the same deterministic inputs (rng seed 0; see "
                        "mmdit_fixture_inputs)")
    p.add_argument("--src-rope", default="split", choices=("split", "interleaved"),
                   help="RoPE pairing the checkpoint was trained with (published Open-Sora v2 = split/liger)")
    p.add_argument("--device", default=None, help="default cuda")
    a = p.parse_args(argv)
    if a.kind == "mmdit":
        report = verify_mmdit(a.checkpoint, a.ref_npz, src_rope=a.src_rope, device=a.device)
    else:
        report = verify_vae(a.checkpoint, a.ref_npz, device=a.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
