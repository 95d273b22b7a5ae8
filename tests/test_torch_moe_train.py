"""Continual training of the MoE and hybrid stacks (Mixtral-8x7B,
Phi-3.5-MoE, Jamba-v0.1; reduced, over vocab 128) on the port against the
JAX package on the CPU.

  * gradients of the loss (the CE plus 0.01 x the load-balance aux) against
    ``jax.grad``, each parameter's within 1e-4 of its largest entry
    (+1e-7), after checking that both packages chose the same experts at
    every MoE layer (``moved_pairs == 0``): top-k routing is discontinuous,
    and a near-tie chosen otherwise would move a token's gradient by O(1);
  * ``ContinualTrainer`` with rehearsal off (nothing drawn) started from the
    reference's weights against the JAX carry backend, step by step: every
    per-step loss within 1e-5, as ``tests/test_torch_token_scenarios.py``
    holds the dense LM;
  * the train CLI on each arch;
  * two gloo ranks on a 2x1 mesh (Mixtral) against JAX's
    ``build_train_step`` on a 2-device CPU mesh, 3 sync steps fed the JAX
    issue's rows: the loss within 1e-5 relative, the parameters after 2
    steps within 1e-4 of their largest entry (``tests/test_torch_mesh.py``'s
    bounds). Sync, because the reference's first pipelined step pads each
    data shard with r invalid pending rows where the port's pads it with
    min(peers, r): masked out of the CE either way, but routed, so they
    move an MoE layer's aux and capacity at that one step. Each rank routes
    its own tokens, as each data shard of the reference does, whose aux is
    the mean over the shards; the port's ranks sum their losses, so each
    adds its aux over the group's size (``parallel.global_share``). Summed
    whole, the aux would be counted twice: 0.01 x aux (about 2e-2) off a
    loss near 4.9, 4.4e-3 relative.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JM
from repro.configs import get_reduced as jax_reduced
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ScenarioConfig as JScenario
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro.scenario import ContinualTrainer as JTrainer
from repro.scenario import TokenClassIncremental as JTokenScenario
from repro_torch import configs
from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig, TrainConfig
from repro_torch.convert import lm_named_from_tree, lm_params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.models import StackCtx, build_model
from repro_torch.scenario import ContinualTrainer
from repro_torch.testdata import moved_pairs, routing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
V, S, B = 128, 16, 8
# two MoE layers each; Jamba's reduced unit (4 layers: attention at 1, MoE at
# 1 and 3, SSM mixers elsewhere) once
LAYERS = {"mixtral-8x7b": 2, "phi3.5-moe-42b-a6.6b": 2, "jamba-v0.1-52b": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch):
    over = dict(vocab_size=V, num_layers=LAYERS[arch])
    return (dataclasses.replace(jax_reduced(arch), **over),
            dataclasses.replace(configs.get_reduced(arch), **over))


def _close(got, want, rtol, what=""):
    """Within ``rtol`` of the largest reference value (+1e-7)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + 1e-7, (what, err, scale)


def _jax_routing(jmodel, jparams, jbatch, jcfg, monkeypatch):
    """The experts the reference's forward chooses at each MoE layer (its
    stack unrolled, so that the wrapped ``route`` sees arrays)."""
    calls, route = [], JM.route

    def recording(params, x, cfg):
        gates, experts, aux = route(params, x, cfg)
        calls.append((torch.from_numpy(np.array(gates)), torch.from_numpy(np.array(experts))))
        return gates, experts, aux

    monkeypatch.setattr(JM, "route", recording)
    jmodel.forward(jparams, jbatch, JaxCtx(cfg=jcfg, remat="none", scan_layers=False))
    monkeypatch.setattr(JM, "route", route)
    return calls


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_gradients_match_jax_grad_on_the_same_routing(arch, monkeypatch):
    jcfg, cfg = _cfgs(arch)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=S)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_routing = _jax_routing(jmodel, jparams, jbatch, jcfg, monkeypatch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, JaxCtx(cfg=jcfg, remat="none")), has_aux=True)(jparams)
    with routing() as calls:
        loss, metrics = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   StackCtx(cfg=cfg))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    assert len(calls) == len(want_routing) == n_moe == 2
    assert moved_pairs(calls, want_routing) == 0
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(jmetrics["aux"]), rtol=1e-5)
    assert float(metrics["aux"].detach()) > 0
    want = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        assert float(np.abs(want[name]).max()) > 0, name
        _close(p.grad.numpy(), want[name], 1e-4, name)


def _runs(arch, mode="off"):
    """The reference's ``_token_run`` (tests/test_scenario.py) in both
    packages with ``arch``'s reduced stack: vocab 128, seq 16, batch 8,
    AdamW f32, 2 tasks x 6 steps."""
    jcfg, cfg = _cfgs(arch)
    rcfg = dict(num_buckets=2, slots_per_bucket=4, num_representatives=3, num_candidates=6,
                mode=mode, label_field="labels", task_field="task")
    train = dict(optimizer="adamw", peak_lr=1e-3, warmup_steps=5, linear_scaling=False,
                 compute_dtype="float32")
    sc = dict(name="class_incremental", modality="tokens", strategy="rehearsal", num_tasks=2,
              epochs_per_task=1, steps_per_epoch=6, batch_size=B, vocab_size=V, seq_len=S,
              auto_defaults=False)
    jrun = JRun(model=jcfg, shape=JShape("parity", S, B, "train"), train=JTrain(**train),
                rehearsal=JRehearsal(**rcfg), scenario=JScenario(**sc))
    run = RunConfig(model=cfg, train=TrainConfig(**train), rehearsal=RehearsalConfig(**rcfg),
                    scenario=ScenarioConfig(**sc))
    return jrun, run


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_trainer_without_replay_matches_the_jax_carry_backend(arch):
    """Rehearsal off draws nothing: from the reference's initial weights the
    port's trainer follows the JAX carry backend through the MoE loss, its
    gradients and AdamW, every per-step loss within 1e-5; task 0 trains."""
    jrun, run = _runs(arch)
    jtrainer = JTrainer(jrun, JTokenScenario(jrun.scenario))
    want = jtrainer.fit()
    trainer = ContinualTrainer(run, device="cpu")

    def jax_init(seed):
        jparams = jtrainer.init_params_fn(jax.random.PRNGKey(seed))
        return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), run.model,
                                  device="cpu")

    trainer.init_params_fn = jax_init
    got = trainer.fit()
    assert len(got.losses) == len(want.history) == 12
    np.testing.assert_allclose(got.losses, [h["loss"] for h in want.history], rtol=0,
                               atol=1e-5)
    assert got.losses[5] < got.losses[0]
    assert np.isfinite(got.accuracy_matrix).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_trains_the_arch_on_the_cpu(arch, caplog):
    import logging

    with caplog.at_level(logging.INFO, logger="repro_torch"):
        res = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--tasks", "2",
                              "--steps-per-task", "2", "--seq-len", "16",
                              "--global-batch", "4"])
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    assert res.history[-1]["buffer_fill"] > 0
    assert f"arch={arch}-reduced" in caplog.text and "eval after task 1 on task 0" in caplog.text


# ---------------------------------------------------------------------------
# two gloo ranks against JAX's build_train_step on a 2-device CPU mesh
# ---------------------------------------------------------------------------

MESH_ARCH, STEPS, N = "mixtral-8x7b", 3, 2

JAX_SIDE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.buffer import state as jstate
from repro.configs import get_reduced
from repro.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig, ShapeConfig,
                                TrainConfig)
from repro.data import TaskTokenStream, TokenStreamConfig
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.scenario.trainer import materialize_state
from repro.utils.compat import set_mesh
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_named_from_tree

ARCH, LAYERS, V, S, B, N, STEPS = {ARCH!r}, {LAYERS}, {V}, {S}, {B}, {N}, {STEPS}
cfg = dataclasses.replace(get_reduced(ARCH), vocab_size=V, num_layers=LAYERS)
tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH), vocab_size=V, num_layers=LAYERS)
stream = TaskTokenStream(TokenStreamConfig(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
mesh = make_mesh((N, 1), ("data", "model"))
out, bw = {{}}, B // N

def named(tree):
    return lm_named_from_tree(jax.tree_util.tree_map(np.asarray, tree), tcfg)

run = RunConfig(model=cfg, shape=ShapeConfig("parity", S, B, "train"),
                train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                  linear_scaling=False, compute_dtype="float32"),
                rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4,
                                          num_representatives=3, num_candidates=6,
                                          mode="sync", label_field="labels"),
                scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                        strategy="rehearsal", num_tasks=2, batch_size=B,
                                        vocab_size=V, seq_len=S, auto_defaults=False))
with set_mesh(mesh):
    built = build_train_step(run, mesh, exchange="full", buffer_budget_bytes=None, donate=False)
    key = jax.random.PRNGKey(0)
    params, opt, buf, reps, valid = materialize_state(built, run, mesh, key)
    out.update({{f"params0/{{k}}": v for k, v in named(params).items()}})
    issue_key = key
    for s in range(STEPS):
        batch = stream.batch(int(s >= 2), B, s)
        plans = []
        for w in range(N):
            buf_w = jax.tree_util.tree_map(lambda x: x[w], buf)
            k_up, k_samp = jax.random.split(jax.random.fold_in(issue_key, w))
            flat, _, _, _, counts, seen = jstate.local_update_rows(
                buf_w, jnp.asarray(batch["task"][w * bw:(w + 1) * bw]), k_up, 6)
            k_draw, k_pick = jax.random.split(k_samp)
            samp, sv = jstate.local_sample_rows(buf_w._replace(counts=counts), k_draw, N)
            plans.append((flat, counts, seen, samp, sv, k_pick))
        for w, (flat, counts, seen, samp, sv, k_pick) in enumerate(plans):
            recv_valid = jnp.stack([plans[j][4][w] for j in range(N)])
            scores = jax.random.uniform(k_pick, (N,)) + jnp.where(recv_valid, 0.0, 1e3)
            take = jnp.argsort(scores)[:3]
            for name, a in (("flat", flat), ("counts", counts), ("seen", seen),
                            ("samp", samp), ("sv", sv), ("take", take)):
                out[f"s{{s}}/w{{w}}/rows/{{name}}"] = np.asarray(a)
        out.update({{f"s{{s}}/batch/{{k}}": v for k, v in batch.items()}})
        params, opt, buf, reps, valid, m = built.fn(
            params, opt, buf, reps, valid, {{k: jnp.asarray(v) for k, v in batch.items()}},
            issue_key)
        issue_key = jax.random.fold_in(key, s)
        for k in ("loss", "rep_checksum", "buffer_fill"):
            out[f"s{{s}}/{{k}}"] = np.asarray(m[k])
        if s < 2:
            out.update({{f"params{{s + 1}}/{{k}}": v for k, v in named(params).items()}})
np.savez(sys.argv[1], **out)
"""

PORT_SIDE = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rendezvous, ref_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{{rendezvous}}", rank=rank,
                        world_size=world)
from repro_torch import configs
from repro_torch.buffer.state import UpdateSampleRows
from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig, TrainConfig
from repro_torch.convert import load_named
from repro_torch.core.distributed import ExchangeRows
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step, shard_host_batch
from repro_torch.scenario import TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state

ARCH, LAYERS, V, S, B, STEPS = {ARCH!r}, {LAYERS}, {V}, {S}, {B}, {STEPS}
ref = np.load(ref_path)
cfg = dataclasses.replace(configs.get_reduced(ARCH), vocab_size=V, num_layers=LAYERS)
mesh = make_mesh((world, 1), ("data", "model"))
run = RunConfig(
    model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                 linear_scaling=False, compute_dtype="float32"),
    rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                              num_candidates=6, mode="sync", label_field="labels"),
    scenario=ScenarioConfig(name="class_incremental", modality="tokens", strategy="rehearsal",
                            num_tasks=2, batch_size=B, vocab_size=V, seq_len=S,
                            auto_defaults=False))
built = build_train_step(run, mesh, scenario=TokenClassIncremental(run.scenario),
                         exchange="full", buffer_budget_bytes=None, device="cpu")
params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
load_named(params, {{k[len("params0/"):]: ref[k] for k in ref.files if k.startswith("params0/")}})
out = {{}}
for s in range(STEPS):
    p = f"s{{s}}/w{{rank}}/rows/"
    rows = ExchangeRows(
        UpdateSampleRows(*(torch.from_numpy(np.array(ref[p + n]))
                           for n in ("flat", "counts", "seen", "samp", "sv"))),
        torch.from_numpy(np.array(ref[p + "take"])).long())
    batch = shard_host_batch({{k: ref[f"s{{s}}/batch/{{k}}"] for k in ("tokens", "labels", "task")}},
                             mesh)
    params, opt, buf, reps, valid, m = built.fn(params, opt, buf, reps, valid, batch, 0, rows=rows)
    out.update({{f"s{{s}}/{{k}}": float(m[k]) for k in ("loss", "rep_checksum", "buffer_fill")}})
    if s < 2:
        out.update({{f"params{{s + 1}}/{{k}}": v.detach().numpy().copy()
                    for k, v in params.named_parameters()}})
np.savez(out_path, **out)
del built, params, opt, buf, reps, valid
import gc
gc.collect()
dist.destroy_process_group()
"""


def _run_all(procs, timeout=600):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("worker timed out")
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def test_two_ranks_match_the_jax_pjit_route_with_the_aux_as_a_mean(tmp_path):
    fmt = dict(ARCH=MESH_ARCH, LAYERS=LAYERS[MESH_ARCH], V=V, S=S, B=B, N=N, STEPS=STEPS)
    ref_path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
    _run_all([subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE.format(**fmt)),
                                ref_path], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    code = textwrap.dedent(PORT_SIDE.format(**fmt))
    rendezvous = str(tmp_path / "rendezvous")
    _run_all([subprocess.Popen([sys.executable, "-c", code, str(r), str(N), rendezvous, ref_path,
                                str(tmp_path / f"rank{r}.npz")], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(N)])
    ref = np.load(ref_path)
    ranks = [np.load(str(tmp_path / f"rank{r}.npz")) for r in range(N)]
    for s in range(STEPS):
        want = float(ref[f"s{s}/loss"])
        for got in ranks:  # every rank reports the global loss
            assert abs(float(got[f"s{s}/loss"]) - want) <= 1e-5 * abs(want), (s, got[f"s{s}/loss"])
            for k in ("rep_checksum", "buffer_fill"):
                assert float(got[f"s{s}/{k}"]) == float(ref[f"s{s}/{k}"]), (s, k)
    assert float(ref[f"s{STEPS - 1}/rep_checksum"]) > 0  # the last steps replayed
    names = [f.split("/", 1)[1] for f in ref.files if f.startswith("params2/")]
    assert any(".moe.router" in n for n in names)
    for name in names:
        _close(ranks[0][f"params2/{name}"], ref[f"params2/{name}"], 1e-4, name)
        np.testing.assert_array_equal(ranks[0][f"params2/{name}"], ranks[1][f"params2/{name}"])
