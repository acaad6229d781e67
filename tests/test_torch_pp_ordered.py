"""Pipeline stages across processes on the ordered transport
(``parallel/comm.post_pipeline_messages``, ``parallel/pipeline.py``): every
pipeline message under one tag, posted by both processes of a pair in one
order derived from the schedule, so that gloo pairs them as nccl would, by
posting order alone; the backward run slot by slot in reverse tick order
(``pipeline.PipelineTape``).

Geometry: tests/test_torch_pp.py's (depth 4 + 8, hidden 64, 4 heads, 8 rows
of 32 + 8 tokens) in 4 microbatches, over (pp 2) on 2 gloo processes and
(pp 2, tp 2) on 4, one stage (and tp rank) a process. The processes start
once per world size, running tests/torch_multi_process_workers.py's
functions while this process computes the references.

Tolerances: the forward against JAX's ``make_pp_forward`` on the same mesh
within atol 1e-4 (tests/test_torch_pp.py's); one step from a generator
against the port's same mesh in one process, the loss and norm within
``PORT_TOL`` (1e-6, relative) and each parameter's change within
``PORT_UPDATE_TOL`` (1e-5, relative L2) (tests/test_torch_multi_process.py's
limits). The known-wrong control -- process 0 running its microbatches'
backwards in forward order, its messages the same in size and place -- must
miss them by more than 100 times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensora_tpu.models.mmdit.model import MMDiTConfig as JConfig
from opensora_tpu.models.mmdit.model import MMDiTModel as JModel
from opensora_tpu.training import pp as jpp

from opensora_torch.utils.weights import mmdit_state_dict
from test_torch_multi_process import PORT_TOL, PORT_UPDATE_TOL, _changes
from test_torch_pp import GEOM, N_MICRO, OPT
from test_torch_pp import _batch as pp_batch
from test_torch_pp import _model_inputs
from torch_multi_process_workers import Processes, pp_step, run_calls
from torch_parity_utils import one_torch_thread, randomize, to_numpy

# (pp, data, tp) and the world of processes, one stage (and tp rank) each
MESHES = [((2, 1, 1), 2), ((2, 1, 2), 4)]
SEED = 9  # the step's generator
FWD_ATOL = 1e-4
WRONG_FACTOR = 100

_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _name(sizes) -> str:
    return "x".join(map(str, sizes))


@pytest.fixture(scope="module")
def runs():
    """The forward, the step and its known-wrong control in one start of 2
    processes and one of 4; the nccl-backend build on the 2; JAX's forward
    and the one-process steps computed meanwhile."""
    jm = JModel(JConfig(**GEOM, attn_backend="xla", dtype="fp32", param_dtype="fp32"))
    batch = pp_batch(seed=4)
    b, n_img = batch["x0"].shape[:2]
    n_txt = batch["txt"].shape[1]
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z(b, n_img, 8), z(b, n_img, 3), z(b, n_txt, 24),
                            z(b, n_txt, 3), z(b), z(b, 16))
    params = randomize(to_numpy(shapes["params"]), 6, scale=0.1)
    sd = {k: torch.from_numpy(v.copy()) for k, v in mmdit_state_dict(params).items()}
    inputs = _model_inputs(batch, np.linspace(0.15, 0.85, b).astype(np.float32))

    procs, names = {}, {}
    for sizes, world in MESHES:
        step = (sd, GEOM, OPT, sizes, N_MICRO, batch, SEED)
        calls = [("pp_forward", (sd, GEOM, sizes, N_MICRO, inputs), {}), ("pp_step", step, {}),
                 ("pp_step", step, dict(variant="pp_microbatches_forward"))]
        names[world] = ["forward", "step", "wrong_order"]
        if world == 2:
            calls.append(("pp_under_nccl", (sd, GEOM, N_MICRO, inputs), {}))
            names[world].append("nccl")
        procs[world] = Processes(run_calls, calls, world=world)

    ref, jax_fwd = {}, {}
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    for sizes, _ in MESHES:
        ref[sizes] = pp_step(sd, GEOM, OPT, sizes, N_MICRO, batch, SEED)
        pp, data, tp = sizes
        fwd = jpp.make_pp_forward(jm, jpp.create_pp_mesh(pp=pp, data=data, tp=tp), n_micro=N_MICRO)
        jax_fwd[sizes] = np.asarray(jax.jit(lambda p: fwd(p, **jb))(jax.tree.map(jnp.asarray, params)))
    got = {}
    for sizes, world in MESHES:
        results = procs[world].results()
        got[sizes] = {n: [r[i] for r in results] for i, n in enumerate(names[world])}
    return dict(got=got, ref=ref, jax_fwd=jax_fwd, start={n: v.numpy() for n, v in sd.items()}, batch=batch)


def _vs_one_process(out, ref, start) -> dict:
    """The worst relative distance of the loss and norm (over every
    process) and of any parameter's change (process 0's gathered state)
    from the one-process step."""
    metric = max(abs(r["metrics"][0][k] - ref["metrics"][0][k]) / abs(ref["metrics"][0][k])
                 for r in out for k in ("loss", "grad_norm"))
    got = {n: p.numpy() for n, p in out[0]["state"]["params"].items()}
    want = {n: p.numpy() for n, p in ref["state"]["params"].items()}
    assert sorted(got) == sorted(want)
    return dict(metric=metric, change=max(_changes(got, want, start).values()))


def _expected_sends(batch, stage: int) -> dict:
    """A process's pipeline messages per step (tests/test_torch_tp_pp_processes
    .py's count at N_MICRO microbatches): per microbatch, stage 0 sends the
    double stack's (img, txt, vec, pe) and the single stack's (x, vec, pe)
    and the gradients of the double stack's output (img, txt, vec); the last
    stage the double stack's output (img, txt, vec, pe) and the gradients
    of its inputs ((img, txt, vec), (x, vec)). fp32; pe is RoPE's cos and
    sin, each (mb, L, D / 2)."""
    b, n_img, _ = batch["x0"].shape
    n_txt, h = batch["txt"].shape[1], GEOM["hidden_size"]
    mb = b // N_MICRO
    img, txt, vec, x = (mb * n * h * 4 for n in (n_img, n_txt, 1, n_img + n_txt))
    pe = 2 * mb * (n_img + n_txt) * sum(GEOM["axes_dim"]) // 2 * 4
    per = [(img + txt + vec + pe) + (x + vec + pe) + (img + txt + vec),
           (img + txt + vec + pe) + (img + txt + vec) + (x + vec)][stage]
    return dict(sends=3 * N_MICRO, bytes=N_MICRO * per)


@pytest.mark.parametrize("sizes", [m for m, _ in MESHES], ids=_name)
def test_forward_matches_jax(runs, sizes):
    """The GPipe forward on fixed timesteps, one stage a process: the last
    stage's processes against JAX's ``make_pp_forward`` on the same mesh
    (atol 1e-4); the others return None."""
    out = runs["got"][sizes]["forward"]
    half = len(out) // 2
    assert all(y is None for y in out[:half])
    for y in out[half:]:
        np.testing.assert_allclose(y.numpy(), runs["jax_fwd"][sizes], atol=FWD_ATOL)


@pytest.mark.parametrize("sizes", [m for m, _ in MESHES], ids=_name)
def test_step_matches_one_process(runs, sizes):
    """One step from a generator (AdamW, EMA), one stage a process, against
    the same mesh in one process: the loss and norm on every process
    within PORT_TOL, each parameter's change within PORT_UPDATE_TOL; every
    process posted the messages of its stage."""
    out = runs["got"][sizes]["step"]
    assert f"in {len(out)} processes" in out[0]["mesh"] and all(r["state"] is None for r in out[1:])
    d = _vs_one_process(out, runs["ref"][sizes], runs["start"])
    assert d["metric"] <= PORT_TOL and d["change"] <= PORT_UPDATE_TOL, d
    half = len(out) // 2
    for p, r in enumerate(out):
        assert r["pp_remote"] == _expected_sends(runs["batch"], int(p >= half)), (p, r["pp_remote"])


@pytest.mark.parametrize("sizes", [m for m, _ in MESHES], ids=_name)
def test_each_pair_posts_one_sequence(runs, sizes):
    """Per pair of processes, the messages one posted and received, in
    posting order, mirror the other's element by element: each send of one
    is the other's receive at the same place, of the same size. Each
    process talks only to its own stage peer (the same tp rank of the other
    stage)."""
    out = runs["got"][sizes]["step"]
    half = len(out) // 2
    flip = {"send": "recv", "recv": "send"}
    for p, r in enumerate(out):
        q = (p + half) % len(out)
        assert sorted(r["pp_log"]) == [q], (p, sorted(r["pp_log"]))
        mine, theirs = r["pp_log"][q], out[q]["pp_log"][p]
        assert [(flip[d], n) for d, n in mine] == theirs, (p, q)
        sent = [n for d, n in mine if d == "send"]
        assert len(sent) == r["pp_remote"]["sends"] and sum(sent) == r["pp_remote"]["bytes"]


@pytest.mark.parametrize("sizes", [m for m, _ in MESHES], ids=_name)
def test_microbatches_backward_in_forward_order_fails(runs, sizes):
    """Known-wrong: process 0 runs its microbatches' backwards in forward
    order (the slots' messages keep their sizes and places, so gloo under
    one tag pairs them as before, with the gradients of other
    microbatches): more than 100 times outside the limits."""
    out = runs["got"][sizes]["wrong_order"]
    d = _vs_one_process(out, runs["ref"][sizes], runs["start"])
    assert d["metric"] > WRONG_FACTOR * PORT_TOL or d["change"] > WRONG_FACTOR * PORT_UPDATE_TOL, d
    assert [r["pp_log"] for r in out] == [r["pp_log"] for r in runs["got"][sizes]["step"]]


def test_pipeline_across_processes_builds_and_runs_under_nccl(runs):
    """With the backend taken for nccl (buffers where the tensors lie, no
    host staging), ``make_pp_forward`` builds both where the pipeline spans
    the processes (pp 2, data 1) and where each holds whole pipelines (pp
    2, data 2), and the forward equals JAX's on each process's rows."""
    want = runs["jax_fwd"][(2, 1, 1)]
    for p, r in enumerate(runs["got"][(2, 1, 1)]["nccl"]):
        spanning, whole = r[(2, 1, 1)], r[(2, 2, 1)]
        assert spanning["spans"] and not whole["spans"]
        if p == 0:
            assert spanning["out"] is None
        else:
            np.testing.assert_allclose(spanning["out"].numpy(), want, atol=FWD_ATOL)
        rows = len(want) // 2
        np.testing.assert_allclose(whole["out"].numpy(), want[p * rows:(p + 1) * rows], atol=FWD_ATOL)
