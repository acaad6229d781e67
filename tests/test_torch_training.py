"""The port's training path against the JAX package's on the CPU, with the
same numpy inputs, seeded weights and, for a train step, the same
``jax.random`` draws fed through the port's seam: the flash-attention
backward (plain and through the autograd Function), LoRA init and merge,
the optimizer chain, the visual condition of training, and whole train
steps (LoRA, and full finetuning with EMA) in fp32.

Tolerances: 1e-5 relative for the attention backward (the same fp32 sums
in another order); 1e-5 for the optimizer over five updates of
lr = 0.1 (fp32 rounding of Adam's normalized steps, taken in another
order); 1e-4 relative for a train step (fp32 sums through a small model,
forward and backward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.ops import flash_attention as jfa
from opensora_tpu.training import diffusion as jdiff
from opensora_tpu.training import lora as jlora
from opensora_tpu.utils import optimizer as jopt
from opensora_tpu.utils import train as jtrain
from opensora_tpu.utils.sampling import get_res_lin_function as jres_lin
from opensora_tpu.utils.sampling import time_shift as jtime_shift

from opensora_torch.models.mmdit.model import MMDiTConfig, MMDiTModel
from opensora_torch.ops import flash_attention as tfa
from opensora_torch.training import diffusion as tdiff
from opensora_torch.training import lora as tlora
from opensora_torch.utils import optimizer as topt
from opensora_torch.utils import train as ttrain
from opensora_torch.utils.sampling import build_img_ids
from opensora_torch.utils.weights import load_numpy_state_dict, lora_state_dict, mmdit_state_dict
from torch_parity_utils import max_rel_err, randomize, t, to_numpy

STEP_TOL = 1e-4
GEOM = dict(in_channels=16, vec_in_dim=32, context_in_dim=64, hidden_size=64, mlp_ratio=2.0,
            num_heads=2, depth=1, depth_single_blocks=1, axes_dim=[8, 12, 12], qkv_bias=True,
            guidance_embed=False, cond_embed=True)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ----------------------------------------------------------------------
# flash-attention backward
# ----------------------------------------------------------------------

# (B, H, L, D), causal_block: L = 40 and 37 leave tails in 16-row blocks
BWD_CASES = [((1, 2, 40, 16), None), ((2, 1, 37, 16), None), ((1, 2, 40, 16), 8), ((1, 1, 37, 16), 12)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape,causal_block", BWD_CASES)
def test_flash_backward_matches_jax_grad(shape, causal_block):
    """The plain backward (and the Function over it) against jax.grad of
    the Pallas flash attention run in interpret mode with 16-row blocks."""
    q, k, v, do = _qkv(shape, 0)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal_block=causal_block, block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * do)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal_block=causal_block)
    grads = torch.autograd.grad(out, (tq, tk, tv), t(do))
    delta = (t(do) * out.detach()).sum(-1)
    plain = tfa.partial_flash_backward(t(q), t(k), t(v), t(do), lse, delta, causal_block=causal_block)
    for name, g, p, r in zip(("dq", "dk", "dv"), grads, plain, ref):
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))
        assert _rel(p, r) <= 1e-5, (name, _rel(p, r))


def test_partial_flash_backward_matches_jax():
    """The ring building block with an external LSE and delta."""
    q, k, v, do = _qkv((1, 2, 40, 16), 1)
    rng = np.random.default_rng(2)
    lse = rng.uniform(2.0, 4.0, (1, 2, 40)).astype(np.float32)
    delta = rng.standard_normal((1, 2, 40)).astype(np.float32)
    ref = jfa.partial_flash_backward(*map(jnp.asarray, (q, k, v, do, lse, delta)),
                                     block_q=16, block_k=16, causal_block=8, interpret=True)
    got = tfa.partial_flash_backward(*map(t, (q, k, v, do, lse, delta)), causal_block=8)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-5


# ----------------------------------------------------------------------
# LoRA
# ----------------------------------------------------------------------


def _jax_model(seed=1, **kw):
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32", **kw))
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(1, 12, 16), z(1, 12, 3), z(1, 8, 64),
                            z(1, 8, 3), z(1), z(1, 32), z(1, 12, 20), None)
    return jm, randomize(to_numpy(shapes["params"]), seed, scale=0.1)


def _port_model(params, lora=None, lora_scale=1.0, **kw):
    tm = MMDiTModel(MMDiTConfig(**GEOM, dtype="fp32", **kw), device="meta", dtype=torch.float32)
    load_numpy_state_dict(tm, mmdit_state_dict(params))
    if lora is not None:
        rank = next(iter(jax.tree.leaves(lora))).shape[-1]
        tlora.apply_lora(tm, rank=rank, scale=lora_scale)
        factors = {k: torch.from_numpy(v) for k, v in lora_state_dict(lora).items()}
        missing, unexpected = tm.load_state_dict(factors, strict=False)
        assert not unexpected and not [m for m in missing if "lora_" in m]
    return tm


def test_lora_init_targets_and_merge_match_jax():
    """The port's targets are the JAX package's, with factors of the same
    shapes (A ~ N(0, 1) / r, B = 0), and the per-linear merge equals the
    JAX tree merge on the same nonzero factors."""
    jm, params = _jax_model()
    rank = 4
    jtree = jlora.init_lora_params(params, jax.random.PRNGKey(0), rank=rank)
    tm = _port_model(params)
    factors = tlora.apply_lora(tm, rank=rank, scale=2.0, generator=torch.Generator().manual_seed(0))
    expect = lora_state_dict(to_numpy(jtree))
    assert sorted(factors) == sorted(expect)
    assert tlora.count_lora_params(tm) == jlora.count_lora_params(jtree)
    for name, p in factors.items():
        assert tuple(p.shape) == expect[name].shape, name
        if name.endswith("lora_B"):
            assert not p.any()
    a = torch.cat([p.flatten() for n, p in factors.items() if n.endswith("lora_A")])
    assert abs(a.std().item() * rank - 1.0) < 0.05 and abs(a.mean().item()) < 0.01

    rng = np.random.default_rng(3)
    lora = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1, to_numpy(jtree))
    merged = mmdit_state_dict(to_numpy(jlora.merge_lora(params, lora, 2.0)))
    tm = _port_model(params, lora, lora_scale=2.0)
    for name, mod in tm.named_modules():
        if isinstance(mod, tlora.LoRALinear):
            w = mod.merged_weight().detach().numpy()
            np.testing.assert_allclose(w, merged[f"{name}.weight"], rtol=1e-6, atol=1e-6, err_msg=name)


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------


def test_optimizer_matches_optax_chain():
    """clip_by_global_norm -> adamw with a linear warmup and weight decay,
    under MultiSteps(2), over 10 gradient calls (5 updates): the params
    after every call equal optax's."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal((3,)).astype(np.float32)}
    kw = dict(lr=0.1, weight_decay=0.05, eps=1e-8, warmup_steps=3, grad_clip=0.5, accumulation_steps=2)
    tx = jopt.create_optimizer(**kw)
    jp, jstate = jax.tree.map(jnp.asarray, p0), None
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
    opt = topt.create_optimizer(tp.values(), **kw)
    clipped = 0
    for i in range(10):
        g = {k: (rng.standard_normal(v.shape) * (0.1 if i < 4 else 1.0)).astype(np.float32) for k, v in p0.items()}
        upd, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k])
        clipped += float(topt.global_norm([t(x) for x in g.values()])) >= 0.5
        opt.step()
        opt.zero_grad()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-5)
    assert opt.count == 5 and clipped >= 4


def test_schedules_match_optax():
    lin = jopt.linear_warmup_schedule(1e-3, 10)
    cos = jopt.cosine_annealing_warmup_schedule(1e-3, 10, 100)
    tlin = topt.linear_warmup_schedule(1e-3, 10)
    tcos = topt.cosine_annealing_warmup_schedule(1e-3, 10, 100)
    # optax evaluates in fp32: within 1e-6 of the peak lr
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert tlin(count) == pytest.approx(float(lin(count)), rel=0, abs=1e-9)
        assert tcos(count) == pytest.approx(float(cos(count)), rel=0, abs=1e-9)


# ----------------------------------------------------------------------
# visual condition
# ----------------------------------------------------------------------


def test_build_visual_condition_matches_jax():
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((6, 4, 9, 8, 8)).astype(np.float32)
    latent = rng.standard_normal((6, 4, 11, 4, 4)).astype(np.float32)
    conds = ["t2v", "i2v_head", "i2v_tail", "i2v_loop", "v2v_head", "v2v_tail_easy"]
    enc = lambda xi: xi[..., ::2, ::2] * 2.0  # noqa: E731  (same in jnp and torch)
    jm, jc = jtrain.build_visual_condition(jnp.asarray(x0), conds, enc, jnp.asarray(latent), 4)
    tm, tc = ttrain.build_visual_condition(t(x0), conds, enc, t(latent), 4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ttrain.single_frame_encodes(conds) == 4


def test_choose_mask_conditions_and_masked_loss_match_jax():
    cfg = dict(t2v=0.4, i2v_head=0.2, i2v_loop=0.2, v2v_head=0.1, v2v_head_easy=0.1)
    for latent_t in (1, 9, 17, 33):
        got = ttrain.choose_mask_conditions(cfg, 7, latent_t, 4, np.random.default_rng(latent_t))
        assert got == jtrain.choose_mask_conditions(cfg, 7, latent_t, 4, np.random.default_rng(latent_t))
    rng = np.random.default_rng(5)
    pred, tgt = (rng.standard_normal((2, 3 * 2 * 2, 8)).astype(np.float32) for _ in range(2))
    masks = np.zeros((2, 1, 3, 4, 4), np.float32)
    masks[0, :, 0] = 1
    masks[1, :, -1] = 1
    ref = jtrain.get_batch_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(masks), (3, 4, 4))
    got = ttrain.get_batch_loss(t(pred), t(tgt), t(masks), (3, 4, 4))
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


# ----------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------


def _batch(seed=6, B=2, T=3, H=4, W=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    L = T * (H // 2) * (W // 2)
    masks = np.zeros((B, 1, T, H, W), np.float32)
    masks[0, :, 0] = 1  # i2v_head on sample 0, t2v on sample 1
    cond = np.concatenate([masks, masks * f(B, 4, T, H, W)], axis=1)
    cond = cond.reshape(B, 5, T, H // 2, 2, W // 2, 2).transpose(0, 2, 3, 5, 1, 4, 6).reshape(B, L, 20)
    shift = tdiff.compute_shift_alpha(H, W, T)
    return dict(
        x0=f(B, L, 16), img_ids=build_img_ids(T, H, W, bs=B).numpy(), txt=f(B, 8, 64),
        txt_ids=np.zeros((B, 8, 3), np.float32), y_vec=f(B, 32), cond=cond, masks=masks,
        shift_alpha=np.full((B,), shift, np.float32),
        null_txt=np.broadcast_to(f(1, 8, 64), (B, 8, 64)).copy(), null_vec=np.broadcast_to(f(1, 32), (B, 32)).copy(),
    )


def _jax_draws(batch, rng, step, prob):
    """The draws of the JAX package's loss_fn (training/diffusion.py)."""
    rng = jax.random.fold_in(rng, step)
    r_t, r_noise, r_txt, r_vec = jax.random.split(rng, 4)
    b = batch["x0"].shape[0]
    tt = jtime_shift(jnp.asarray(batch["shift_alpha"]), jax.nn.sigmoid(jax.random.normal(r_t, (b,), jnp.float32)))
    x1 = jax.random.normal(r_noise, batch["x0"].shape, jnp.float32)
    return dict(t=t(tt), x1=t(x1), drop_txt=t(jax.random.uniform(r_txt, (b,)) < prob),
                drop_vec=t(jax.random.uniform(r_vec, (b,)) < prob))


@pytest.mark.parametrize("lora,remat_policy", [(True, "full"), (False, "dots")])
def test_train_step_matches_jax(lora, remat_policy):
    """One train step from the same weights, batch and draws: the loss, the
    trained parameters' gradients and their global norm, the parameters
    after clip + AdamW, and (without LoRA) the EMA."""
    kw = dict(remat=True, remat_policy=remat_policy)
    jm, params = _jax_model(seed=7, **kw)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    prob, scale, rng = 0.5, 2.0, jax.random.PRNGKey(11)
    # eps well above the gradients' rounding: Adam's first step is
    # lr * g / (|g| + eps), which for |g| near eps turns a 1e-7 difference
    # in g into a visible one in the parameter
    opt_kw = dict(lr=1e-2, weight_decay=0.1, eps=1e-2, warmup_steps=0, grad_clip=0.05)
    step_kw = dict(ema_decay=0.9, text_dropout_prob=prob, use_masked_loss=True, lora_scale=scale)
    if lora:
        jtree = jlora.init_lora_params(params, jax.random.PRNGKey(0), rank=4)
        r = np.random.default_rng(8)
        train = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(np.float32) * 0.1, to_numpy(jtree))
        extra = (params,)
    else:
        train, extra = params, ()

    # the JAX step with SGD(1) exposes the gradients (params - new params);
    # the JAX package's optimizer chain and EMA then take those gradients
    state = jdiff.TrainState.create(jax.tree.map(jnp.asarray, train), optax.sgd(1.0), ema=False)
    step = jax.jit(jdiff.make_train_step(jm, optax.sgd(1.0), **step_kw))
    sgd_state, metrics = step(state, jbatch, rng, *extra)
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), train, to_numpy(sgd_state.params))
    tx = jopt.create_optimizer(**opt_kw)

    @jax.jit
    def adam_and_ema(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        new = optax.apply_updates(p, upd)
        return new, jtrain.update_ema(p, new, 0.9)

    jparams, jema = adam_and_ema(jgrads, train)

    tm = _port_model(params, train if lora else None, lora_scale=scale, **kw)
    opt = topt.create_optimizer([p for p in tm.parameters() if p.requires_grad], **opt_kw)
    state = tdiff.TrainState.create(tm, opt, ema=not lora)
    step = tdiff.make_train_step(tm, ema_decay=0.9, text_dropout_prob=prob, use_masked_loss=True)
    draws = _jax_draws(batch, rng, 0, prob)
    assert draws["drop_txt"].any() != draws["drop_txt"].all() or draws["drop_vec"].any()
    grads = {}
    for n, p in state.params.items():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().clone()))
    tmetrics = step(state, {k: t(v) for k, v in batch.items()}, draws=draws)

    assert float(tmetrics["loss"]) == pytest.approx(float(metrics["loss"]), rel=STEP_TOL)
    assert float(tmetrics["grad_norm"]) == pytest.approx(float(metrics["grad_norm"]), rel=STEP_TOL)
    convert = lora_state_dict if lora else mmdit_state_dict
    want_grads, want_params = convert(jgrads), convert(to_numpy(jparams))
    assert sorted(grads) == sorted(want_grads)
    for n, g in grads.items():
        assert max_rel_err(g.numpy(), want_grads[n]) <= STEP_TOL, n
    for n, p in state.params.items():
        assert max_rel_err(p.detach().numpy(), want_params[n]) <= STEP_TOL, n
    if not lora:
        want_ema = mmdit_state_dict(to_numpy(jema))
        for n, e in state.ema.items():
            assert max_rel_err(e.numpy(), want_ema[n]) <= STEP_TOL, n
    assert state.step == 1


def test_sample_timesteps_matches_jax_shift():
    """The port's logit-normal draw, shifted as the JAX package shifts it."""
    gen = torch.Generator().manual_seed(0)
    got = ttrain.sample_timesteps(4, 192, 336, 33, generator=gen)
    n = torch.randn(4, generator=torch.Generator().manual_seed(0))
    alpha = jres_lin()((192 // 16) * (336 // 16) * 4 / 4.0) * np.sqrt(33)
    want = jtime_shift(alpha, jax.nn.sigmoid(jnp.asarray(n.numpy())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_remat_offload_raises_naming_its_roadmap_item():
    """"offload" is ported now (its parity with "full" is in
    test_torch_full_finetune.py): it builds, and the policy that still
    raises is an unknown one, naming the policies there are."""
    MMDiTModel(MMDiTConfig(**GEOM, remat=True, remat_policy="offload"), device="meta")
    with pytest.raises(ValueError, match="'dots', 'full', 'offload'"):
        MMDiTModel(MMDiTConfig(**GEOM, remat=True, remat_policy="save_nothing"), device="meta")
