"""The port's VAE training path against the JAX package's on the CPU, with
the same numpy inputs and seeded weights: the plain D = 512 flash-attention
backward, every loss function, the 3D discriminator, LPIPS (random weights,
and the published files' names), the full HunyuanVAE forward
(x_rec, posterior, z) given the same posterior noise, the fp32-parameter /
bf16-compute mode, and the VAE training CLI over small mp4 files, then
resumed. The whole train steps (and grad_checkpoint's) are in
tests/test_torch_vae_train_step.py, which takes this file's helpers.

Tolerances: 1e-5 of each gradient's scale for the attention backward (the
same fp32 sums in another order); 1e-5 relative for the losses; 1e-4 of
the output's scale for the discriminator, LPIPS and the VAE forward (fp32
convolutions summed in another order); 1e-4 for the train steps (losses
relative; gradients, parameters after AdamW and the EMA of each tensor's
own scale), as for the diffusion train step: its measure,
|err| / max(1, max|ref|), holds the gradients to 1e-4, and each gradient is
also held to 1e-3 of its own scale. The first step's gradients agree to
5e-5 of their own scale; in the second the parameters carry the first
AdamW update's fp32 rounding, and the gradients that are sums which nearly
cancel (the attention's query bias and its group-norm gain, 1e-4 of the
largest gradients) come within 2.6e-4. A gradient that vanishes
analytically (the key bias: softmax ignores a constant added to all of a
row's logits) is rounding noise on both sides: the scale is floored at
1e-5.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JVAEConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.models.vae2d import losses as jl
from opensora_tpu.models.vae2d.discriminator import NLayerDiscriminator3D as JDisc
from opensora_tpu.models.vae2d.lpips import LPIPS as JLPIPS
from opensora_tpu.models.vae2d.lpips import load_lpips_params
from opensora_tpu.ops import flash_attention as jfa

from opensora_torch.models.hunyuan_vae.model import AutoEncoder3DConfig, AutoencoderKLCausal3D
from opensora_torch.models.vae2d import losses as tl
from opensora_torch.models.vae2d.discriminator import NLayerDiscriminator3D
from opensora_torch.models.vae2d.lpips import LPIPS, load_lpips
from opensora_torch.ops import flash_attention as tfa
from opensora_torch.utils.logger import close_logger
from opensora_torch.utils.weights import (
    discriminator_state_dict,
    hunyuan_vae_state_dict,
    load_numpy_state_dict,
    lpips_state_dict,
)
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOL = 1e-4
GRAD_OWN_SCALE_TOL = 1e-3
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), latent_channels=4, norm_num_groups=4, layers_per_block=1)
DISC = dict(input_nc=3, ndf=8, n_layers=3)


def _rel(a, b, floor: float = 1e-30) -> float:
    """max |a - b| over max(max |b|, floor): each tensor held to its own
    scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


def _randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------------
# the D = 512 flash-attention backward
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,causal_block", [((1, 1, 40, 512), 12), ((1, 2, 37, 512), None)])
def test_flash_backward_d512_matches_jax_grad(shape, causal_block):
    """The plain backward at the VAE mid-block's head dim (and the Function
    over it) against jax.grad of the Pallas flash attention in interpret
    mode, with 16-row blocks so that 37 and 40 leave tails."""
    q, k, v, do = (_randn(shape, s) for s in range(4))

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal_block=causal_block, block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * do)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal_block=causal_block)
    grads = torch.autograd.grad(out, (tq, tk, tv), t(do))
    delta = (t(do) * out.detach()).sum(-1)
    plain = tfa.flash_attention_bwd_ref(t(q), t(k), t(v), t(do), lse, delta, None, causal_block)
    for name, g, p, r in zip(("dq", "dk", "dv"), grads, plain, ref):
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))
        assert _rel(p, r) <= 1e-5, (name, _rel(p, r))


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

LOGITS = (_randn((2, 1, 3, 4, 4), 10), _randn((2, 1, 3, 4, 4), 11))


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss", "wgan_gp_loss", "l1", "batch_mean",
                                  "lecam_reg", "adaptive_generator_weight", "generator_loss", "discriminator_loss"])
def test_loss_function_matches_jax(name):
    a, b = LOGITS
    if name == "l1":
        args = (a, b)
    elif name == "batch_mean":
        args = (a,)
    elif name == "lecam_reg":
        args = (a, b, a * 0.5, b * 0.3)
    elif name == "adaptive_generator_weight":
        args = (a, b * 1e-3, 0.05)
    else:
        args = (a, b)
    if name in ("generator_loss", "discriminator_loss"):
        kw = {"generator_loss": [dict(d_weight=0.7, gen_start=3)],
              "discriminator_loss": [dict(disc_start=3, disc_loss_type=k) for k in ("hinge", "vanilla", "wgan-gp")]}
        for extra in kw[name]:
            for step in (0, 2, 3, 5):
                want = getattr(jl, name)(jnp.asarray(a), *([] if name == "generator_loss" else [jnp.asarray(b)]),
                                         step, **extra)
                got = getattr(tl, name)(t(a), *([] if name == "generator_loss" else [t(b)]), step, **extra)
                for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
                    assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-7), (name, extra, step)
        return
    want = np.asarray(getattr(jl, name)(*map(jnp.asarray, args)))
    got = getattr(tl, name)(*map(t, args[:2] if name == "adaptive_generator_weight" else args),
                            *(args[2:] if name == "adaptive_generator_weight" else ())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


class _JPosterior:
    """Stands in for the JAX package's posterior: vae_loss reads only kl()."""

    def __init__(self, kl):
        self._kl = kl

    def kl(self):
        return self._kl


def test_vae_loss_matches_jax():
    """L1 + perceptual under a learned log-variance and the weighted KL, the
    perceptual term a stand-in function of both frame batches."""
    video, rec = _randn((2, 3, 3, 8, 8), 12), _randn((2, 3, 3, 8, 8), 13)
    kl = np.abs(_randn((2,), 14))

    def jperc(x, y):
        return jnp.mean((x - y) ** 2, axis=(1, 2, 3), keepdims=True)

    def tperc(x, y):
        return ((x - y) ** 2).mean(dim=(1, 2, 3), keepdim=True)

    for perc in (None, (jperc, tperc)):
        want = jl.vae_loss(jnp.asarray(video), jnp.asarray(rec), _JPosterior(jnp.asarray(kl)), jnp.asarray(0.3),
                           perceptual_loss_fn=perc and perc[0], perceptual_loss_weight=0.5, kl_loss_weight=1e-2)
        got = tl.vae_loss(t(video), t(rec), _JPosterior(t(kl)), torch.tensor(0.3),
                          perceptual_loss_fn=perc and perc[1], perceptual_loss_weight=0.5, kl_loss_weight=1e-2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-8), k


# ----------------------------------------------------------------------
# discriminator and LPIPS
# ----------------------------------------------------------------------


def _jax_disc(seed=3):
    jm = JDisc(**DISC, dtype="fp32")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 9, 32, 32)))
    return jm, randomize(to_numpy(shapes["params"]), seed, 0.1)


def _port_disc(params, dtype="fp32"):
    m = NLayerDiscriminator3D(**DISC, dtype=dtype, device="meta")
    load_numpy_state_dict(m, discriminator_state_dict(params))
    return m


def test_discriminator_matches_jax():
    """Patch logits in fp32 with the same weights; dropout is off by
    default (deterministic), as in the JAX step, and on only when asked."""
    jm, params = _jax_disc()
    x = _randn((2, 3, 9, 32, 32), 4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    disc = _port_disc(params)
    with torch.no_grad():
        got = disc(t(x)).numpy()
        dropped = disc(t(x), deterministic=False).numpy()
    assert got.shape == want.shape == (2, 1, 3, 4, 4)
    assert max_rel_err(got, want) <= TOL, max_rel_err(got, want)
    assert not np.allclose(dropped, got)
    assert set(disc.state_dict()) == set(discriminator_state_dict(params))


def _jax_lpips(seed=5):
    jm = JLPIPS()
    x = jnp.zeros((1, 3, 32, 32))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x)
    return jm, randomize(to_numpy(shapes["params"]), seed, 0.05)


def test_lpips_matches_jax_and_loads_the_published_names(tmp_path):
    """Random weights carried, and the same weights written as a torchvision
    VGG16 state dict and an LPIPS head file: the port loads them with
    load_state_dict, the JAX package with its converter, and both give the
    same distances."""
    jm, params = _jax_lpips()
    x, y = np.tanh(_randn((3, 3, 32, 32), 6)), np.tanh(_randn((3, 3, 32, 32), 7))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    lp = LPIPS(device="meta")
    load_numpy_state_dict(lp, lpips_state_dict(params))
    with torch.no_grad():
        got = lp(t(x), t(y)).numpy()
    assert got.shape == want.shape == (3, 1, 1, 1)
    assert max_rel_err(got, want) <= TOL, max_rel_err(got, want)

    sd = {k: v.clone() for k, v in lp.state_dict().items()}
    vgg = {k[len("vgg."):]: v for k, v in sd.items() if k.startswith("vgg.")}
    vgg["classifier.0.weight"] = torch.zeros(2, 2)  # a whole torchvision file: the classifier is not read
    heads = {k: v for k, v in sd.items() if k.startswith("lin")}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(heads, tmp_path / "lpips.pth")
    for head_file in (str(tmp_path / "lpips.pth"), None):
        loaded = load_lpips(str(tmp_path / "vgg16.pth"), head_file)
        assert not any(p.requires_grad for p in loaded.parameters())
        jvars = load_lpips_params(str(tmp_path / "vgg16.pth"), head_file)
        want = np.asarray(jm.apply(jvars, jnp.asarray(x), jnp.asarray(y)))
        with torch.no_grad():
            got = loaded(t(x), t(y)).numpy()
        assert max_rel_err(got, want) <= TOL, (head_file, max_rel_err(got, want))


# ----------------------------------------------------------------------
# HunyuanVAE full forward
# ----------------------------------------------------------------------


def _jax_vae():
    vae = JVAE(JVAEConfig(**TINY_VAE, dtype="fp32"))
    shapes = jax.eval_shape(vae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 9, 32, 32)))
    return vae, randomize(to_numpy(shapes["params"]), 0, 0.1)


def _port_vae(params, **kw):
    ae = AutoencoderKLCausal3D(AutoEncoder3DConfig(**TINY_VAE, dtype="fp32"), device="meta", dtype=torch.float32, **kw)
    load_numpy_state_dict(ae, hunyuan_vae_state_dict(params))
    return ae


def _jax_posterior_noise(vae, params, rng, mean_shape):
    """The noise the JAX VAE's ``encode`` draws for ``rngs={"gaussian":
    rng}`` (its first ``make_rng("gaussian")`` on the root scope), in the
    port's (B, C, T, H, W) layout."""
    key = vae.apply({"params": params}, rngs={"gaussian": rng}, method=lambda m: m.make_rng("gaussian"))
    noise = jax.random.normal(key, mean_shape, jnp.float32)
    return t(np.moveaxis(np.asarray(noise), -1, 1))


def test_hunyuan_vae_forward_matches_jax():
    """(x_rec, posterior, z) of the training forward, given the JAX draw's
    noise: the reconstruction, the latents, the posterior's moments, KL and
    NLL; and the mode without sampling."""
    vae, params = _jax_vae()
    x = _randn((1, 3, 9, 32, 32), 2)
    rng = jax.random.PRNGKey(7)
    scale = JVAEConfig().scale_factor

    def fwd(p, v, r):
        x_rec, post, z = vae.apply({"params": p}, v, rngs={"gaussian": r})
        sample = jnp.transpose(z, (0, 2, 3, 4, 1)) / scale
        return x_rec, post.mean, post.logvar, post.kl(), post.nll(sample, dims=(1, 2, 3, 4)), z

    x_rec, mean, logvar, kl, nll, z = jax.jit(fwd)(params, jnp.asarray(x), rng)
    noise = _jax_posterior_noise(vae, params, rng, mean.shape)
    ae = _port_vae(params)
    with torch.no_grad():
        t_rec, t_post, tz = ae(t(x), noise=noise)
        mode_rec, _, mode_z = ae(t(x), sample_posterior=False)
    cl = lambda a: np.moveaxis(np.asarray(a), -1, 1)  # noqa: E731
    for got, want in ((t_rec, x_rec), (tz, z), (t_post.mean, cl(mean)), (t_post.logvar, cl(logvar)),
                      (t_post.kl(), kl), (t_post.nll(tz / scale, dims=(1, 2, 3, 4)), nll)):
        assert got.shape == want.shape and max_rel_err(got.numpy(), want) <= TOL, max_rel_err(got.numpy(), want)
    rec_mode, _, z_mode = vae.apply({"params": params}, jnp.asarray(x), sample_posterior=False)
    assert max_rel_err(mode_rec.numpy(), rec_mode) <= TOL and max_rel_err(mode_z.numpy(), z_mode) <= TOL


def test_fp32_master_weights_compute_as_their_bf16_cast():
    """The training mode (fp32 parameters, bf16 compute) gives exactly the
    numbers of the inference build (bf16 parameters) on the same rounded
    weights, and its gradients land on the fp32 parameters."""
    _, params = _jax_vae()
    master = _port_vae(params, compute_dtype=torch.bfloat16)
    served = AutoencoderKLCausal3D(AutoEncoder3DConfig(**TINY_VAE), device="meta", dtype=torch.bfloat16)
    served.load_state_dict({k: v.to(torch.bfloat16) for k, v in master.state_dict().items()}, assign=True)
    x = t(_randn((1, 3, 5, 16, 16), 3))
    noise = t(_randn((1, 4, 2, 2, 2), 4))
    a = master(x, noise=noise)[0]
    with torch.no_grad():
        b = served(x, noise=noise)[0]
    assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a.detach(), b)
    a.float().square().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in master.parameters())


# ----------------------------------------------------------------------
# the VAE training CLI
# ----------------------------------------------------------------------


def _write_videos(root, n=4, frames=12, size=64):
    import cv2

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = os.path.join(root, f"v{i}.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (size, size))
        base = rng.integers(0, 255, (size, size, 3), np.uint8)
        for k in range(frames):
            w.write(np.roll(base, k * 3, axis=1))
        w.release()
        rows.append(f"{path},demo video {i},{size},{size},{frames},8.0")
    csv = os.path.join(root, "meta.csv")
    with open(csv, "w") as f:
        f.write("path,text,height,width,num_frames,fps\n" + "\n".join(rows) + "\n")
    return csv


@pytest.mark.parametrize("model", ["dc_ae", "hunyuan_vae"])
def test_train_vae_cli_two_steps_then_resume(tmp_path, model):
    """video_dc_ae_disc.py at a tiny width over 4 mp4 files, 2 per batch:
    two steps with the discriminator from step 0, a checkpoint, then one more
    epoch resumed from it. The HunyuanVAE takes a 9-frame bucket (4k + 1)."""
    from opensora_torch import train_vae

    csv = _write_videos(str(tmp_path / "videos"))
    out = str(tmp_path / "out")
    cfg = tmp_path / "cfg.py"
    if model == "dc_ae":
        overrides = ("model = dict(type='dc_ae', width_list=(8, 16, 16, 16, 32, 32), latent_channels=8, dtype='fp32',\n"
                     "             encoder_depth_list=(1, 1, 1, 1, 1, 1), decoder_depth_list=(1, 1, 1, 1, 1, 1))\n"
                     "bucket_config = {'64px': {8: (1.0, 2)}}\n")
    else:
        overrides = ("model = dict(type='hunyuan_vae', block_out_channels=(8, 16, 16, 16), latent_channels=4,\n"
                     "             norm_num_groups=4, layers_per_block=1, dtype='fp32')\n"
                     "bucket_config = {'64px': {9: (1.0, 2)}}\n")
    disc = "discriminator = dict(type='N_Layer_discriminator_3D', ndf=8, n_layers=3, dtype='fp32')\n"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', 'vae', 'train', 'video_dc_ae_disc.py')!r}]\n"
                   + overrides + disc)
    common = [str(cfg), "--device", "cpu", "--outputs", out, "--dataset.data_path", csv, "--log_every", "1",
              "--lr", "1e-3"]
    try:
        trainer = train_vae.main(common + ["--exp_name", "a", "--epochs", "1"])
    finally:
        close_logger()
    with open(os.path.join(out, "a", "log.txt")) as f:
        log = f.read()
    losses = [float(x) for x in re.findall(r" loss (-?\d+\.\d+|nan)", log)]
    assert len(losses) == 2 and np.isfinite(losses).all(), log
    assert trainer.state.step == 2 and trainer.state.disc_optimizer.count == 2
    assert trainer.ae.config.__class__.__name__ == ("DCAEConfig" if model == "dc_ae" else "AutoEncoder3DConfig")
    assert all(p.dtype == torch.float32 for p in trainer.ae.parameters())
    ckpt = os.path.join(out, "a", "epoch0-global_step2")
    assert os.path.exists(os.path.join(ckpt, "state.pt"))

    try:
        resumed = train_vae.main(common + ["--exp_name", "b", "--epochs", "2", "--load", ckpt])
    finally:
        close_logger()
    with open(os.path.join(out, "b", "log.txt")) as f:
        log_b = f.read()
    assert "resumed at epoch 1 global_step 2" in log_b and "epoch 1 step 4 " in log_b
    assert resumed.state.step == 4 and resumed.state.optimizer.count == 4
    assert resumed.state.disc_optimizer.count == 4
    for n, p in trainer.state.params.items():
        assert not torch.equal(p, resumed.state.params[n]), n  # trained on from the checkpoint
    # The hinge loss gives the last conv's bias the gradient -1 + 1 = 0 while
    # every real logit is below 1 and every fake one above -1, as with these
    # small random networks: whether AdamW then moves it is decided by the
    # rounding of the two means (it depends on the CPU thread count).
    last_bias = f"convs.{len(resumed.disc.convs) - 1}.bias"
    assert last_bias in trainer.state.disc_params
    for n, p in trainer.state.disc_params.items():
        if n != last_bias:
            assert not torch.equal(p, resumed.state.disc_params[n]), n


def test_train_vae_mixed_strategy_truncates_as_the_jax_script():
    """Image-only batches with image_prob, else a random 1 + 4k-frame cut,
    drawn from default_rng(seed) in the JAX script's order."""
    from opensora_torch.train_vae import VAETrainer

    class _Cfg(dict):
        def get(self, k, d=None):
            return super().get(k, d)

    trainer = VAETrainer.__new__(VAETrainer)
    trainer.cfg = _Cfg(mixed_strategy={"image_prob": 0.3, "random_truncate": True})
    trainer.ae = type("AE", (), {"config": type("C", (), {"time_compression_ratio": 4})()})()
    trainer.host_rng = np.random.default_rng(42)
    got = [trainer.truncate(np.zeros((1, 3, 17, 2, 2))).shape[2] for _ in range(20)]
    rng = np.random.default_rng(42)
    want = []
    for _ in range(20):
        want.append(1 if rng.random() < 0.3 else int(rng.choice([1, 5, 9, 13, 17])))
    assert got == want and set(got) - {1} and 1 in got
