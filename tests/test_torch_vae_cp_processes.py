"""HunyuanVAE context parallelism with the sp ranks on other devices and in
other processes (opensora_torch/parallel/vae_sharding.py): the port's
``make_sharded_vae_fn`` against the JAX package's on its 8 virtual CPU
devices, at tests/test_torch_vae_cp.py's config (channels 8, x of (2, 3, 5,
64, 64)), with the same weights (``utils/weights.hunyuan_vae_state_dict``),
input and posterior noise, in three settings:

- one process whose 4 sp ranks lie on distinct device keys
  (``torch.device("cpu", i)``), each run by its own replica of the VAE;
- 2 gloo processes at sp 2, one rank a process;
- 2 gloo processes at sp 4, two ranks a process;

and over (data 2, sp 1) with one data coordinate a process, whose rows
reach the other process.

The plain encode and decode are held to JAX's sharded passes on a (data 1,
sp) mesh, and the tiled passes (a spatially tiled decode, a temporally
tiled encode) to the port's unsharded tiled passes. Tolerance: 1e-4 of the
output's scale (``max_rel_err``), fp32, tests/test_torch_vae_cp.py's.
Known-wrong: a strip at a boundary between devices or processes takes its
own edge rows, replicated, for its neighbour's: it must miss the limit by
over 10 times (tests/test_torch_vae_cp.py's factor). The traffic across the
processes (halo rows sent, group-norm sums all-reduced, heights gathered)
is exact against arithmetic over the unsharded pass's layer shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.hunyuan_vae.model import AutoEncoder3DConfig as JConfig
from opensora_tpu.models.hunyuan_vae.model import AutoencoderKLCausal3D as JVAE
from opensora_tpu.parallel.mesh import MeshConfig as JMeshConfig
from opensora_tpu.parallel.mesh import create_mesh as j_create_mesh
from opensora_tpu.parallel.vae_sharding import make_sharded_vae_fn as j_make_sharded_vae_fn

from opensora_torch.models.hunyuan_vae.blocks import CausalAttention, CausalConv3d, GroupNorm
from opensora_torch.parallel import vae_sharding
from opensora_torch.parallel.mesh import MeshConfig, create_mesh
from opensora_torch.parallel.vae_sharding import HeightStrips, make_sharded_vae_fn
from opensora_torch.utils.weights import hunyuan_vae_state_dict
from test_torch_vae_cp import CFG, TOL, _port_vae, _video
from torch_multi_process_workers import Processes, run_calls
from torch_parity_utils import max_rel_err, one_torch_thread, randomize, t, to_numpy

SPS = (2, 4)  # sp over the 2 processes: one rank a process, two
# the tiled passes' config keys: the spatial decode of a latent of 16 rows
# in tiles of 8, 8 and 4 rows (each splits over sp 4), the temporal encode
TILED = dict(decode=dict(use_spatial_tiling=True, sample_size=64), encode=dict(use_temporal_tiling=True,
                                                                               sample_tsize=4))
ZT_SHAPE = (2, 4, 2, 16, 8)
WRONG_FACTOR = 10
KEYS = [torch.device("cpu", i) for i in range(4)]

_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


HALO = HeightStrips.halo


def _own_edges(self, xs, top, bottom):
    """Known-wrong (one process): every strip takes its own edge rows,
    replicated, for its neighbours' (strips on other device keys too)."""
    return [HALO(vae_sharding.ONE_STRIP, [x], top, bottom)[0] for x in xs]


def _expected_traffic(vae, run, process: int, n_processes: int = 2) -> dict:
    """``VAE_REMOTE`` of one process for one pass, by arithmetic over the
    unsharded pass's layer inputs (``run(vae)``): per causal conv of
    kernel height k and stride s on (B, C, T, H, W), a process above
    another sends it its last strip's k // 2 bottom rows, a process below
    another its first strip's k - s - k // 2 top rows; per group norm two
    fp32 all-reduces of (B, groups); per mid-block attention, and per
    output (the quant_conv's moments of each sample, the decoder's video),
    one all-gather of this process's strips."""
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
    with torch.no_grad():
        run(vae)
    for h in hooks:
        h.remove()
    out = dict.fromkeys(vae_sharding.VAE_REMOTE, 0)
    for (b, c, tt, _, w), k, s, e in convs:
        for rows, sends in ((k // 2, process < n_processes - 1), (k - s - k // 2, process > 0)):
            if rows and sends:
                out["halo_sends"] += 1
                out["halo_bytes"] += b * c * tt * rows * w * e
    out["moment_all_reduces"] = 2 * len(norms)
    out["moment_bytes"] = sum(2 * b * g * 4 for b, g in norms)
    out["gathers"] = len(gathers)
    out["gather_bytes"] = sum(n // n_processes for n in gathers)
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX's weights and sharded passes; the 2-process runs started once
    for both sp sizes; the port's unsharded passes meanwhile."""
    jvae = JVAE(JConfig(**CFG, dtype="fp32"))
    shapes = jax.eval_shape(jvae.init, {"params": jax.random.PRNGKey(0), "gaussian": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 3, 5, 64, 64)))
    params = randomize(to_numpy(shapes["params"]), 4, 0.1)
    x = _video(64, seed=5)
    rng = jax.random.PRNGKey(3)
    sd = {k: torch.from_numpy(v.copy()) for k, v in hunyuan_vae_state_dict(params).items()}
    ref = {}
    for sp in SPS:
        jmesh = j_create_mesh(JMeshConfig(dp_size=1, sp_size=sp, tp_size=1), jax.devices()[:sp])
        j_enc = j_make_sharded_vae_fn(jvae, {"params": params}, jmesh, method=lambda m, v: m.encode(v, rng=rng),
                                      rngs_name=None)
        z = np.asarray(j_enc(jnp.asarray(x)))
        j_dec = j_make_sharded_vae_fn(jvae, {"params": params}, jmesh, method=JVAE.decode, rngs_name=None)
        ref[sp] = dict(encode=z, decode=np.asarray(j_dec(jnp.asarray(z))))
    b, c, lt, lh, lw = ref[SPS[0]]["encode"].shape
    # the JAX posterior draws its noise channels-last: (B, T, H, W, C)
    noise = np.moveaxis(np.asarray(jax.random.normal(rng, (b, lt, lh, lw, c), jnp.float32)), -1, 1)
    z = ref[SPS[0]]["encode"]
    zt = np.random.default_rng(6).standard_normal(ZT_SHAPE).astype(np.float32)
    calls = [("vae_cp_passes", (sd, CFG, sp, x, noise, z, zt, TILED), {}) for sp in SPS]
    calls.append(("vae_rows_over_processes", (sd, CFG, x, noise, z), {}))
    procs = Processes(run_calls, calls, world=2)
    local = {}
    with torch.no_grad():
        for name, kw in TILED.items():
            vae = _port_vae(params, **kw)
            local["tiled_" + name] = vae.decode(t(zt)) if name == "decode" else vae.encode(t(x), noise=t(noise))
        local["decode"] = _port_vae(params).decode(t(z))
    results = procs.results()
    return dict(params=params, x=x, noise=noise, z=z, zt=zt, ref=ref, local=local,
                got={sp: [r[i] for r in results] for i, sp in enumerate(SPS)}, rows=[r[len(SPS)] for r in results])


def _held(name, got, runs, sp) -> float:
    want = runs["ref"][sp][name] if name in ("encode", "decode") else runs["local"][name].numpy()
    return max_rel_err(got.numpy(), want)


def test_ranks_on_distinct_device_keys_in_one_process(runs):
    """One process, (data 1, sp 4) over cpu:0 .. cpu:3: each rank away from
    the VAE's own device key runs on a replica of the VAE made for it;
    encode, decode and the tiled passes within the limit; the strips' halo
    between device keys left out misses it."""
    mesh = create_mesh(MeshConfig(1, 4, 1), KEYS)
    params, x, noise, z, zt = (t(runs[k]) if k != "params" else runs[k] for k in ("params", "x", "noise", "z", "zt"))
    vae = _port_vae(params)
    sharding = vae_sharding.HeightSharding(vae, mesh)
    assert len(sharding.replicas) == 3
    assert all(cp.twins[0] is None and all(tw is not None for tw in cp.twins[1:]) for cp in sharding.groups.values())
    with torch.no_grad():
        got = dict(encode=make_sharded_vae_fn(vae, mesh, "encode")(x, noise=noise),
                   decode=make_sharded_vae_fn(vae, mesh, "decode")(z))
        for name, kw in TILED.items():
            fn = make_sharded_vae_fn(_port_vae(params, **kw), mesh, name)
            got["tiled_" + name] = fn(zt) if name == "decode" else fn(x, noise=noise)
    for name, y in got.items():
        assert _held(name, y, runs, 4) <= TOL, name
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(HeightStrips, "halo", _own_edges)
        wrong = make_sharded_vae_fn(vae, mesh, "encode")(x, noise=noise)
    assert max_rel_err(wrong.numpy(), runs["ref"][4]["encode"]) > WRONG_FACTOR * TOL


def test_replicas_take_the_vae_s_current_weights(runs):
    """A replica made when the sharded function was built follows the VAE's
    weights at each call."""
    mesh = create_mesh(MeshConfig(1, 2, 1), KEYS[:2])
    vae = _port_vae(runs["params"])
    fn = make_sharded_vae_fn(vae, mesh, "decode")
    z = t(runs["z"])
    with torch.no_grad():
        vae.decoder.conv_out.conv.bias.add_(0.5)
        assert max_rel_err(fn(z).numpy(), vae.decode(z).numpy()) <= TOL


@pytest.mark.parametrize("sp", SPS)
def test_sp_group_across_two_processes_matches_jax(runs, sp):
    """(data 1, sp) with the sp ranks split over 2 gloo processes: on both
    processes, the whole encode and decode within the limit of JAX's
    sharded passes, and the tiled passes of the port's unsharded ones."""
    for r in runs["got"][sp]:
        assert f"in 2 processes" in r["mesh"] and f"'sp': {sp}" in r["mesh"]
        for name in ("encode", "decode", "tiled_decode", "tiled_encode"):
            assert _held(name, r["out"][name], runs, sp) <= TOL, (sp, name)


@pytest.mark.parametrize("sp", SPS)
def test_cross_process_halo_left_out_fails(runs, sp):
    """Known-wrong: the halo rows not exchanged across the process
    boundary (each process's end strips replicate their own edge rows):
    over 10 times the limit, with no halo sent."""
    for r in runs["got"][sp]:
        assert max_rel_err(r["out"]["halo_left_out"].numpy(), runs["ref"][sp]["encode"]) > WRONG_FACTOR * TOL
        assert r["counts"]["halo_left_out"]["halo_sends"] == 0


@pytest.mark.parametrize("sp", SPS)
def test_traffic_across_processes_is_exact(runs, sp):
    """Per process and pass, the halo messages, the group-norm all-reduces
    and the height all-gathers, with their bytes, equal the arithmetic over
    the unsharded pass's layers."""
    params, x, noise, z, zt = (t(runs[k]) if k != "params" else runs[k] for k in ("params", "x", "noise", "z", "zt"))
    passes = dict(encode=({}, lambda v: v.encode(x, noise=noise)), decode=({}, lambda v: v.decode(z)),
                  tiled_decode=(TILED["decode"], lambda v: v.decode(zt)),
                  tiled_encode=(TILED["encode"], lambda v: v.encode(x, noise=noise)))
    for p, r in enumerate(runs["got"][sp]):
        for name, (kw, run) in passes.items():
            want = _expected_traffic(_port_vae(params, **kw), run, p)
            assert r["counts"][name] == want, (sp, p, name, r["counts"][name], want)


def test_data_rows_across_processes_reach_every_process(runs):
    """(data 2, sp 1), one data coordinate a process: each process encodes
    and decodes its own rows and receives the other's, so both return the
    whole result, equal to JAX's sharded encode and the unsharded decode."""
    for r in runs["rows"]:
        assert "in 2 processes" in r["mesh"] and "'data': 2" in r["mesh"]
        assert max_rel_err(r["encode"].numpy(), runs["ref"][SPS[0]]["encode"]) <= TOL
        assert max_rel_err(r["decode"].numpy(), runs["local"]["decode"].numpy()) <= TOL
