"""The port's rectified-flow eval loss (``opensora_torch/eval/rf_loss.py``)
against the JAX package's (``opensora_tpu/eval/rf_loss.py``) on the CPU: a
tiny MMDiT with the same seeded weights, the same packed latents x0 and the
JAX draw of the noise handed to the port.

Tolerance: 1e-5 relative for every loss (fp32 forward passes through a
1 + 1-block model, sums in another order; the train step's forward is held
to 1e-4 with its backward on top).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensora_tpu.eval.rf_loss import rf_eval_loss as jrf_eval_loss

from opensora_torch.eval.rf_loss import rf_eval_loss
from test_torch_training import _batch, _jax_model, _port_model
from torch_parity_utils import t

TOL = 1e-5


def _inputs(seed=6):
    batch = _batch(seed=seed)
    kwargs = {k: batch[k] for k in ("img_ids", "txt", "txt_ids", "y_vec", "cond")}
    return batch["x0"], kwargs


@pytest.mark.parametrize("timesteps", [(0.1, 0.25, 0.5, 0.75, 0.9), (0.05, 0.6)])
def test_rf_eval_loss_matches_jax(timesteps):
    """Every ``eval_loss_t{t}`` and ``eval_loss_mean`` over the same x0 and
    noise, at the default grid and at another."""
    jm, params = _jax_model(seed=3)
    tm = _port_model(params).eval()
    x0, kwargs = _inputs()
    rng = jax.random.PRNGKey(8)
    ref = jrf_eval_loss(lambda **kw: jm.apply({"params": params}, **kw), jnp.asarray(x0),
                        {k: jnp.asarray(v) for k, v in kwargs.items()}, rng, timesteps=timesteps)
    noise = t(jax.random.normal(rng, x0.shape, jnp.float32))
    out = rf_eval_loss(tm, t(x0), {k: t(v) for k, v in kwargs.items()}, timesteps=timesteps, noise=noise)
    assert sorted(out) == sorted(ref) == sorted([f"eval_loss_t{tv}" for tv in timesteps] + ["eval_loss_mean"])
    for k, v in ref.items():
        assert out[k].dtype == torch.float32 and out[k].shape == ()
        assert float(out[k]) == pytest.approx(float(v), rel=TOL), k


def test_rf_eval_loss_draws_its_noise_once_from_the_generator():
    """Without ``noise`` one draw from the generator serves every t: the
    same seed repeats the losses, they equal those of that draw handed in,
    and the mean is the mean of the grid's losses."""
    _, params = _jax_model(seed=4)
    tm = _port_model(params).eval()
    x0, kwargs = _inputs(seed=9)
    x0, kwargs = t(x0), {k: t(v) for k, v in kwargs.items()}
    a = rf_eval_loss(tm, x0, kwargs, torch.Generator().manual_seed(2))
    b = rf_eval_loss(tm, x0, kwargs, torch.Generator().manual_seed(2))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(2))
    c = rf_eval_loss(tm, x0, kwargs, noise=noise)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
    grid = [v for k, v in a.items() if k != "eval_loss_mean"]
    assert len(grid) == 5 and float(a["eval_loss_mean"]) == pytest.approx(float(sum(grid)) / 5, rel=1e-6)
    # the grid's points differ
    assert float(a["eval_loss_t0.9"]) != float(a["eval_loss_t0.1"])
    assert np.isfinite([float(v) for v in a.values()]).all()
