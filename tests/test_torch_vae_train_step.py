"""The port's VAE train step against the JAX package's on the CPU, with
the same numpy inputs and seeded weights (the helpers and tolerances of
tests/test_torch_vae_train.py, whose docstring states them): two whole
VAE train steps (a tiny HunyuanVAE with its mid-block attention, the
discriminator past disc_start, LPIPS on, AdamW, EMA), and
``grad_checkpoint`` taking the same step for both AEs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.training import vae as jvae
from opensora_tpu.utils import optimizer as jopt
from opensora_tpu.utils.train import update_ema as jupdate_ema

from opensora_torch.models.vae2d.discriminator import NLayerDiscriminator3D
from opensora_torch.models.vae2d.lpips import LPIPS
from opensora_torch.training import vae as tvae
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils.weights import (
    discriminator_state_dict,
    hunyuan_vae_state_dict,
    load_numpy_state_dict,
    lpips_state_dict,
)
from test_torch_vae_train import (
    DISC,
    GRAD_OWN_SCALE_TOL,
    TINY_VAE,
    TOL,
    _jax_disc,
    _jax_lpips,
    _jax_posterior_noise,
    _jax_vae,
    _port_disc,
    _port_vae,
    _randn,
    _rel,
)
from torch_parity_utils import max_rel_err, t, to_numpy


# ----------------------------------------------------------------------
# two VAE train steps
# ----------------------------------------------------------------------


@pytest.mark.parametrize("starts", [0, 1])
def test_vae_train_steps_match_jax(starts):
    """Two steps of the port's make_vae_train_step against the JAX
    package's, from the same weights (loss_logvar 0.1), video and posterior
    noise: every metric, the AE and discriminator gradients, their
    parameters after AdamW, and the EMA. gen_start = disc_start = ``starts``:
    from step 0 the adversarial terms are on in both steps; from 1, off in
    the first (weight 0) and on in the second."""
    vae, vparams = _jax_vae()
    jdisc, dparams = _jax_disc()
    jlp, lparams = _jax_lpips()
    lpips_fn = lambda a, b: jlp.apply({"params": lparams}, a, b)  # noqa: E731
    video = np.tanh(_randn((1, 3, 9, 32, 32), 8))
    opt_kw = dict(lr=1e-3, weight_decay=0.01, eps=1e-2)
    step_kw = dict(perceptual_loss_fn=lpips_fn, kl_loss_weight=1e-2, gen_start=starts, disc_start=starts,
                   disc_weight=0.5, ema_decay=0.9)
    rng = jax.random.PRNGKey(9)

    # the JAX step with SGD(1) for both optimizers exposes the gradients;
    # the JAX package's AdamW and EMA then take them
    sgd = optax.sgd(1.0)
    jstep = jax.jit(jvae.make_vae_train_step(vae, sgd, jdisc, sgd, **step_kw))
    tx, dtx = jopt.create_optimizer(**opt_kw), jopt.create_optimizer(**opt_kw)
    jp = dict(jax.tree.map(jnp.asarray, vparams), loss_logvar=jnp.asarray(0.1, jnp.float32))
    jd = jax.tree.map(jnp.asarray, dparams)
    opt, dopt, jema = tx.init(jp), dtx.init(jd), jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    want = []
    for s in range(2):
        state = jvae.VAETrainState(step=jnp.asarray(s, jnp.int32), params=jp, opt_state=sgd.init(jp),
                                   disc_params=jd, disc_opt_state=sgd.init(jd))
        new, metrics = jstep(state, {"video": jnp.asarray(video)}, rng)
        g = jax.tree.map(lambda a, b: a - b, jp, new.params)
        dg = jax.tree.map(lambda a, b: a - b, jd, new.disc_params)
        # the posterior noise of this step: the JAX step folds the step in
        mean_shape = vae.apply({"params": vparams}, jnp.asarray(video), return_posterior=True,
                               method=JVAE.encode, rngs={"gaussian": rng})[1].mean.shape
        noise = _jax_posterior_noise(vae, vparams, jax.random.fold_in(rng, s), mean_shape)
        upd, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, upd)
        dupd, dopt = dtx.update(dg, dopt, jd)
        jd = optax.apply_updates(jd, dupd)
        jema = jupdate_ema(jema, jp, 0.9)
        want.append(dict(metrics=metrics, g=g, dg=dg, params=jp, disc=jd, ema=jema, noise=noise))

    ae = _port_vae(vparams)
    disc = _port_disc(dparams)
    lp = LPIPS(device="meta")
    load_numpy_state_dict(lp, lpips_state_dict(lparams))
    lp.requires_grad_(False)
    params = tvae.ae_parameters(ae, torch.nn.Parameter(torch.tensor(0.1)))
    state = tvae.VAETrainState.create(params, topt.create_optimizer(params.values(), **opt_kw), disc,
                                      topt.create_optimizer(disc.parameters(), **opt_kw), ema=True)
    step = tvae.make_vae_train_step(ae, disc, **dict(step_kw, perceptual_loss_fn=lp))
    grads = {}
    for prefix, named in (("", state.params), ("disc.", state.disc_params)):
        for n, p in named.items():
            p.register_hook(lambda g, n=prefix + n: grads.__setitem__(n, g.detach().clone()))

    def ae_tree(tree):
        out = hunyuan_vae_state_dict({k: v for k, v in to_numpy(tree).items() if k != "loss_logvar"})
        out["loss_logvar"] = np.asarray(tree["loss_logvar"])
        return out

    for s, w in enumerate(want):
        grads.clear()
        metrics = step(state, {"video": t(video)}, noise=w["noise"])
        for k, v in w["metrics"].items():
            assert float(metrics[k]) == pytest.approx(float(v), rel=TOL, abs=1e-7), (s, k)
        want_g = {**ae_tree(w["g"]), **{f"disc.{k}": v for k, v in discriminator_state_dict(to_numpy(w["dg"])).items()}}
        assert sorted(grads) == sorted(want_g)
        for n, g in grads.items():
            assert max_rel_err(g.numpy(), want_g[n]) <= TOL, (s, n)
            assert _rel(g.numpy(), want_g[n], 1e-5) <= GRAD_OWN_SCALE_TOL, (s, n, _rel(g.numpy(), want_g[n], 1e-5))
        for got, ref in ((state.params, ae_tree(w["params"])), (state.ema, ae_tree(w["ema"])),
                         (state.disc_params, discriminator_state_dict(to_numpy(w["disc"])))):
            for n, p in got.items():
                assert _rel(p.detach().numpy(), ref[n]) <= TOL, (s, n)
    assert state.step == 2 and state.optimizer.count == 2 and state.disc_optimizer.count == 2


@pytest.mark.parametrize("model", ["hunyuan_vae", "dc_ae"])
def test_grad_checkpoint_takes_the_same_step(model):
    """grad_checkpoint recomputes the AE's encoder and decoder in the
    backward (the mid-block attention runs twice) and takes the same step:
    equal metrics and parameters. The discriminator is never recomputed."""
    from opensora_torch.models.hunyuan_vae.blocks import CausalAttention
    from opensora_torch.utils.ckpt import init_ae

    cfg = dict(type=model, dtype="fp32", **(TINY_VAE if model == "hunyuan_vae" else dict(
        width_list=(8, 16, 16, 16, 32, 32), encoder_depth_list=(1,) * 6, decoder_depth_list=(1,) * 6,
        latent_channels=8)))
    video = t(np.tanh(_randn((1, 3, 9 if model == "hunyuan_vae" else 8, 32, 32), 9)))
    runs = []
    for grad_checkpoint in (False, True):
        ae = init_ae(cfg, "cpu", 0)
        disc = NLayerDiscriminator3D(**DISC, dtype="fp32")
        torch.manual_seed(1)
        disc.load_state_dict({k: torch.randn_like(v) * 0.1 for k, v in disc.state_dict().items()})
        calls = []
        for m in list(ae.modules()) + list(disc.modules()):
            if isinstance(m, (CausalAttention, NLayerDiscriminator3D)):
                m.register_forward_hook(lambda mod, *_: calls.append(type(mod).__name__))
        params = tvae.ae_parameters(ae, torch.nn.Parameter(torch.tensor(0.1)))
        state = tvae.VAETrainState.create(params, topt.create_optimizer(params.values(), lr=1e-3), disc,
                                          topt.create_optimizer(disc.parameters(), lr=1e-3))
        step = tvae.make_vae_train_step(ae, disc, gen_start=0, disc_start=0, grad_checkpoint=grad_checkpoint)
        metrics = step(state, {"video": video}, torch.Generator().manual_seed(3))
        runs.append((metrics, {n: p.detach().clone() for n, p in state.params.items()}, calls))
    (m0, p0, c0), (m1, p1, c1) = runs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    # the discriminator: generator logits, the adaptive weight's head, real and fake
    assert c0.count("NLayerDiscriminator3D") == c1.count("NLayerDiscriminator3D") == 4
    n_attn = 2 if model == "hunyuan_vae" else 0
    assert c0.count("CausalAttention") == n_attn and c1.count("CausalAttention") == 2 * n_attn
