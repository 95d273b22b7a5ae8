"""GPipe (``repro_torch.parallel.pipeline``) against the reference's
``repro.parallel.pipeline`` on the same numpy inputs.

One module-scoped spawn (``runs``): JAX's ``pipeline_apply`` on a 4-fake-
device ``pipe`` mesh (a subprocess), then four gloo ranks (a file
rendezvous) running the port's on a ``(4,)`` ``pipe`` mesh, and a reduced
SmolLM-135M stack pipelined in 2 stages on a ``(2, 2)`` ``('data',
'pipe')`` mesh. The reference's case (``tests/test_distributed_multidev.py::
test_pipeline_parallel_matches_sequential``): 4 stages of ``tanh(x @ w)``,
``w`` [16, 16], ``x`` [8, 16], in 1, 4 and 8 micro-batches. The outputs
and the gradients of ``sum(out ** 2)`` with respect to each stage's ``w``
(each rank's row) are held within 1e-5 of JAX's (and of ``jax.grad``
through the sequential stack).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES, B, D = 4, 8, 16
MICRO = (1, 4, 8)
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((STAGES, D, D)) * 0.4).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return ws, x


JAX_SIDE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.utils.compat import set_mesh
from repro.parallel.pipeline import pipeline_apply, stack_stage_params

ws, x = np.load(sys.argv[1])["ws"], np.load(sys.argv[1])["x"]
mesh = make_mesh((4,), ("pipe",))
stacked = stack_stage_params([{{"w": jnp.asarray(w)}} for w in ws])
out = {{}}

def stage_fn(p, micro):
    return jnp.tanh(micro @ p["w"])

def seq(st, x):
    for i in range(st["w"].shape[0]):
        x = jnp.tanh(x @ st["w"][i])
    return x

with set_mesh(mesh):
    for m in {MICRO}:
        f = lambda st: pipeline_apply(mesh, stage_fn, st, jnp.asarray(x), n_microbatches=m)
        out[f"out{{m}}"] = np.asarray(f(stacked))
        out[f"grad{{m}}"] = np.asarray(jax.grad(lambda st: jnp.sum(f(st) ** 2))(stacked)["w"])
out["seq_out"] = np.asarray(seq(stacked, jnp.asarray(x)))
out["seq_grad"] = np.asarray(jax.grad(lambda st: jnp.sum(seq(st, jnp.asarray(x)) ** 2))(
    stacked)["w"])
np.savez(sys.argv[2], **out)
"""

PORT_SIDE = """
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rendezvous, in_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                              sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{{rendezvous}}", rank=rank,
                        world_size=world)
from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import StackCtx, build_model
from repro_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from repro_torch.testdata import pipelined_forward

inp = np.load(in_path)
ws, x = torch.from_numpy(inp["ws"]), torch.from_numpy(inp["x"])
mesh = make_mesh((world,), ("pipe",))
out = {{}}
for m in {MICRO}:
    stacked = stack_stage_params([{{"w": w}} for w in ws])
    row = {{"w": stacked["w"][rank:rank + 1].clone().requires_grad_(True)}}
    got = pipeline_apply(mesh, lambda p, mb: torch.tanh(mb @ p["w"]), row, x,
                         n_microbatches=m)
    (got ** 2).sum().backward()
    out[f"out{{m}}"] = got.detach().numpy()
    out[f"grad{{m}}"] = row["w"].grad[0].numpy()

# a reduced SmolLM-135M stack in 2 stages, on each data row of a (2, 2) mesh
cfg = configs.get_reduced("smollm-135m")
model = build_model(cfg)
params = model.init(torch.Generator().manual_seed(0), 16, "cpu")
ctx = StackCtx(cfg=cfg, remat="none")
toks = torch.from_numpy(inp["tokens"])
grid = make_mesh((2, 2), ("data", "pipe"))
with torch.no_grad():
    out["lm_whole"] = model.forward(params, {{"tokens": toks}}, ctx)[0].numpy()
    out["lm_piped"] = pipelined_forward(grid, params, {{"tokens": toks}}, cfg, ctx, 2).numpy()
np.savez(out_path, **out)
import gc
gc.collect()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs and gradients, [each rank's])."""
    tmp = tmp_path_factory.mktemp("pipeline")
    ws, x = _inputs()
    tokens = np.random.default_rng(1).integers(0, 512, (4, 16)).astype(np.int64)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, ws=ws, x=x, tokens=tokens)
    src = os.path.join(REPO, "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={STAGES}")
    jax_out = tmp / "jax.npz"
    jp = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE.format(MICRO=MICRO)),
                           str(inputs), str(jax_out)], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    code = textwrap.dedent(PORT_SIDE.format(MICRO=MICRO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(STAGES),
                               str(tmp / "rdv"), str(inputs), str(tmp / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(STAGES)]
    for p in [jp] + procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in [jp] + procs:
                q.kill()
            pytest.fail("worker timed out")
        assert p.returncode == 0, err[-4000:]
    return np.load(jax_out), [np.load(tmp / f"rank{r}.npz") for r in range(STAGES)]


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_apply_matches_the_references_outputs(m, runs):
    """Every rank gets the whole [B, D] output, within 1e-5 of JAX's
    ``pipeline_apply`` and of the sequential stack."""
    ref, ranks = runs
    np.testing.assert_allclose(ref[f"out{m}"], ref["seq_out"], atol=TOL, rtol=0)
    for got in ranks:
        np.testing.assert_allclose(got[f"out{m}"], ref[f"out{m}"], atol=TOL, rtol=0)


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_gradients_match_jax_grad(m, runs):
    """Autograd through the handoffs gives each stage's gradient (rank s's
    row of the stacked ``w``) within 1e-5 of ``jax.grad`` through the
    reference's ``pipeline_apply`` and through the sequential stack."""
    ref, ranks = runs
    np.testing.assert_allclose(ref[f"grad{m}"], ref["seq_grad"], atol=TOL, rtol=0)
    for s, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"grad{m}"], ref[f"grad{m}"][s], atol=TOL, rtol=0)


def test_reduced_smollm_stack_in_two_stages_matches_its_forward(runs):
    """A reduced SmolLM-135M (4 layers) cut into 2 stages of 2 layers on each
    data row of a (2, 2) mesh: the logits within 1e-5 of the largest
    |logit| of the unpipelined forward on every rank."""
    for got in runs[1]:
        want = got["lm_whole"]
        err = np.abs(got["lm_piped"] - want).max()
        assert err <= TOL * np.abs(want).max(), err


def test_batch_that_does_not_split_into_micro_batches_raises():
    """``b % m != 0`` raises, as the reference's assert does."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import pipeline_apply

    mesh = make_mesh((1,), ("pipe",), "cpu")
    with pytest.raises(ValueError, match="micro-batches"):
        pipeline_apply(mesh, lambda p, x: x, {"w": torch.zeros(1, 2)}, torch.zeros(8, 2),
                       n_microbatches=3)


@pytest.mark.parametrize("m", [1, 8])
def test_one_stage_is_the_stage_function(m):
    """A pipe axis of one rank: the output is ``stage_fn`` on each
    micro-batch, bit for bit, the row taken from a stack of one."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import pipeline_apply, stack_stage_params

    ws, x = _inputs()
    mesh = make_mesh((1,), ("pipe",), "cpu")
    stacked = stack_stage_params([{"w": torch.from_numpy(ws[0])}])
    assert stacked["w"].shape == (1, D, D)
    got = pipeline_apply(mesh, lambda p, mb: torch.tanh(mb @ p["w"]), stacked,
                         torch.from_numpy(x), n_microbatches=m)
    want = torch.cat([torch.tanh(mb @ torch.from_numpy(ws[0]))
                      for mb in torch.from_numpy(x).chunk(m)])
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_make_mesh_takes_a_pipe_axis_and_refuses_unknown_names():
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "pipe"), "cpu")
    assert mesh.mesh_dim_names == ("data", "pipe")
    with pytest.raises(ValueError, match="distinct names"):
        make_mesh((1,), ("stage",), "cpu")
