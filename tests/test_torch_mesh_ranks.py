"""The mesh backend across gloo ranks on the CPU: four ranks as pod 2 x
data 2, and two ranks for the loss's global token mean and for a restart.

Four ranks run, in one launch, the port of
  * ``test_distributed_multidev.py::test_pod_local_exchange_stays_in_pod``
    and ``::test_global_exchange_unbiased_sources``;
  * ``test_exchange_bias.py::test_global_exchange_restores_replay_diversity``;
  * ``test_paper_invariants.py::test_previous_task_buckets_frozen`` and
    ``::test_c_controls_current_task_renewal_rate``, on each rank's buffer
    updated by the mesh step's ``make_sharded_update``;
  * ``ContinualTrainer(mesh=pod 2 x data 2)`` on the small ResNet, full and
    pod_local: every rank ends with the same parameters and metrics.
Two ranks then hold a step where one rank's representatives are all
invalid against the reference's global token mean (the JAX model's loss on
the global augmented batch, within 1e-5 relative), restore a rank's
checkpoint and replay it bit for bit, and run the ``ResilientLoop`` with
rank 0 alone failing (before a step, after one, and with rank 1's newest
checkpoint lost): both ranks agree on the restart and end on the clean
run's state bit for bit. The train CLI runs ``--resilience`` on them too.

Each launch meets through a file in the test's ``tmp_path``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro_torch.runtime import multiproc

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

FOUR = r"""
import json
import torch
from repro_torch.runtime import multiproc
rank, world = multiproc.init_from_env()
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.buffer.state import ItemSpec, init_buffer
from repro_torch.configs.base import RehearsalConfig
from repro_torch.core.distributed import make_sharded_update
from repro_torch.launch.mesh import make_mesh

mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
DP = ("pod", "data")
out = {"rank": rank}

def const(shape, value, dtype=torch.int32):
    return torch.full(shape, value, dtype=dtype)

# pod_local: worker w holds tokens == w; pod of worker w = w // 2
rcfg = RehearsalConfig(num_buckets=1, slots_per_bucket=8, num_representatives=2,
                       num_candidates=8)
spec = {"tokens": ItemSpec((2,), torch.int32), "labels": ItemSpec((2,), torch.int32),
        "task": ItemSpec((), torch.int32)}
items = {"tokens": const((2, 2), rank), "labels": const((2, 2), 0), "task": const((2,), 0)}
buf = init_buffer(spec, 1, 8, device="cpu")
upd = make_sharded_update(mesh, DP, rcfg, "pod_local", device="cpu")
for step in range(10):
    buf, reps, valid = upd(buf, items, items["task"], step)
out["pod_local_sources"] = sorted(set(reps["tokens"][:, 0].tolist()))
out["pod_local_valid"] = bool(valid.all())

# full: every worker's kept representatives span several source workers
rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=8, num_representatives=3,
                       num_candidates=8)
spec = {"tokens": ItemSpec((4,), torch.int32), "labels": ItemSpec((4,), torch.int32),
        "task": ItemSpec((), torch.int32)}
items = {"tokens": const((2, 4), rank), "labels": const((2, 4), 1), "task": const((2,), 0)}
buf = init_buffer(spec, 2, 8, device="cpu")
upd = make_sharded_update(mesh, DP, rcfg, "full", device="cpu")
for step in range(6):
    buf, reps, valid = upd(buf, items, items["task"], step)
sources, all_valid = set(), True
for step in range(20):
    # a throwaway copy: the draws must not advance the buffer
    copy = buf._replace(data={k: v.clone() for k, v in buf.data.items()},
                        counts=buf.counts.clone(), seen=buf.seen.clone())
    _, reps, valid = upd(copy, items, items["task"], 100 + step)
    all_valid &= bool(valid.all())
    sources |= set(reps["tokens"][:, 0].tolist())
out["full_sources"], out["full_valid"] = sorted(sources), all_valid

# exchange bias: worker w ingests only class w
rcfg = RehearsalConfig(num_buckets=1, slots_per_bucket=16, num_representatives=6,
                       num_candidates=8)
spec = {"x": ItemSpec((4,), torch.float32), "labels": ItemSpec((), torch.int32),
        "task": ItemSpec((), torch.int32)}
items = {"x": torch.ones(2, 4), "labels": const((2,), rank), "task": const((2,), 0)}
coverage = {}
for exchange in ("local", "full"):
    buf = init_buffer(spec, 1, 16, device="cpu")
    upd = make_sharded_update(mesh, DP, rcfg, exchange, device="cpu")
    seen = set()
    for step in range(30):
        buf, reps, valid = upd(buf, items, items["task"], step)
        if step >= 5:
            seen |= set(reps["labels"][valid].tolist())
    coverage[exchange] = len(seen)
out["coverage"] = coverage

# paper invariants on this rank's buffer, through the mesh step's update
def frozen_case(c, seed):
    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=8, num_representatives=2,
                           num_candidates=c)
    spec = {"x": ItemSpec((4,), torch.float32), "labels": ItemSpec((4,), torch.int32),
            "task": ItemSpec((), torch.int32)}
    upd = make_sharded_update(mesh, DP, rcfg, "full", device="cpu")
    buf, b = init_buffer(spec, 2, 8, device="cpu"), 16
    for s in range(4):
        it = {"x": torch.full((b, 4), 100.0 + s), "labels": const((b, 4), 0),
              "task": const((b,), 0)}
        buf, _, _ = upd(buf, it, it["task"], seed + s)
    frozen, count = buf.data["x"][0].clone(), int(buf.counts[0])
    for s in range(10):
        it = {"x": torch.full((b, 4), 200.0 + s), "labels": const((b, 4), 1),
              "task": const((b,), 1)}
        buf, _, _ = upd(buf, it, it["task"], seed + 100 + s)
    return (torch.equal(buf.data["x"][0], frozen) and int(buf.counts[0]) == count
            and int(buf.counts[1]) > 0)

out["frozen"] = [frozen_case(c, seed) for c, seed in ((1, 0), (4, 7), (16, 123), (9, 2**20))]
renewal = {}
for c in (2, 16):
    rcfg = RehearsalConfig(num_buckets=1, slots_per_bucket=16, num_representatives=2,
                           num_candidates=c)
    spec = {"x": ItemSpec((4,), torch.float32), "labels": ItemSpec((4,), torch.int32),
            "task": ItemSpec((), torch.int32)}
    upd = make_sharded_update(mesh, DP, rcfg, "full", device="cpu")
    buf, b = init_buffer(spec, 1, 16, device="cpu"), 32
    for s in range(8):
        it = {"x": torch.ones(b, 4), "labels": const((b, 4), 0), "task": const((b,), 0)}
        buf, _, _ = upd(buf, it, it["task"], s)
    it = {"x": torch.full((b, 4), 2.0), "labels": const((b, 4), 0), "task": const((b,), 0)}
    buf, _, _ = upd(buf, it, it["task"], 99)
    renewal[c] = float((buf.data["x"][0, :, 0] == 2.0).float().mean())
out["renewal"] = renewal

# the trainer on the pod x data mesh: the small ResNet, 1 task x 3 steps
from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import RunConfig, ScenarioConfig, TrainConfig
from repro_torch.scenario import ContinualTrainer

cfg = resnet50_cl.CNNConfig("t", "resnet18", num_classes=8, width=4, stage_blocks=(1, 1),
                            bottleneck=False, image_size=8)
run = RunConfig(model=cfg, train=TrainConfig(peak_lr=0.1, warmup_steps=1),
                rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4,
                                          num_representatives=3, num_candidates=4,
                                          mode="async"),
                scenario=ScenarioConfig(num_tasks=2, classes_per_task=4, image_size=8,
                                        batch_size=8, steps_per_epoch=3))
out["trainer"] = {}
for exchange in ("full", "pod_local"):
    trainer = ContinualTrainer(run, device="cpu", mesh=mesh, exchange=exchange)
    res = trainer.fit(num_tasks=1)
    flat = torch.cat([p.detach().reshape(-1) for p in trainer.final_state[0].parameters()])
    gathered = [torch.zeros_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    out["trainer"][exchange] = {
        "losses": res.losses, "history": res.history,
        "params_equal": all(torch.equal(g, gathered[0]) for g in gathered),
        "pending_rows": int(trainer.final_state[4].shape[0]),
        "acc": res.accuracy_matrix.tolist()}
    del trainer
print(json.dumps(out))
del upd, buf, items
import gc
gc.collect()
dist.barrier()
dist.destroy_process_group()
"""


def _launch(src, n, tmp_path, extra_env=None):
    env = dict({"OMP_NUM_THREADS": "1"}, **(extra_env or {}))
    outs = multiproc.launch_workers(src, n, timeout=300, pythonpath=SRC, extra_env=env,
                                    rendezvous_dir=str(tmp_path))
    for o in outs:
        assert o.returncode == 0, o.stderr[-4000:]
    return [json.loads(o.stdout.strip().splitlines()[-1]) for o in outs]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _launch(FOUR, 4, tmp_path_factory.mktemp("four_ranks"))


def test_pod_local_exchange_stays_in_pod(four_ranks):
    for r in four_ranks:
        pod = {0: {0, 1}, 1: {0, 1}, 2: {2, 3}, 3: {2, 3}}[r["rank"]]
        assert set(r["pod_local_sources"]) <= pod and r["pod_local_valid"], r


def test_global_exchange_unbiased_sources(four_ranks):
    """Every worker's kept representatives come from at least 3 of the 4
    workers across 20 draws (global diversity, paper §IV-C)."""
    for r in four_ranks:
        assert r["full_valid"] and len(r["full_sources"]) >= 3, r["full_sources"]


def test_global_exchange_restores_replay_diversity(four_ranks):
    """Worker w ingests only class w: the local exchange replays its own
    class alone, the full exchange (nearly) every class."""
    for r in four_ranks:
        assert r["coverage"]["local"] == 1 and r["coverage"]["full"] >= 3, r["coverage"]


def test_previous_task_buckets_frozen(four_ranks):
    """§VI-C: once training moves to task 1, the task-0 bucket of every
    rank never changes, for several (c, seed)."""
    for r in four_ranks:
        assert all(r["frozen"]), r["frozen"]


def test_c_controls_current_task_renewal_rate(four_ranks):
    for r in four_ranks:
        assert r["renewal"]["16"] > r["renewal"]["2"] + 0.2, r["renewal"]


@pytest.mark.parametrize("exchange", ["full", "pod_local"])
def test_trainer_on_pod_by_data_keeps_the_ranks_equal(four_ranks, exchange):
    """``ContinualTrainer(mesh=pod 2 x data 2)``: the same parameters,
    losses and fingerprints on every rank; the pending slot holds one row
    per peer of the exchange (4 for full, 2 within a pod) below r = 3."""
    runs = [r["trainer"][exchange] for r in four_ranks]
    for run in runs:
        assert run["params_equal"] and np.isfinite(run["losses"]).all()
        assert run["losses"] == runs[0]["losses"] and run["history"] == runs[0]["history"]
        assert run["pending_rows"] == (3 if exchange == "full" else 2)
    assert runs[0]["history"][-1]["buffer_fill"] == 4 * 4  # each rank's task-0 bucket full
    assert runs[0]["history"][-1]["rep_checksum"] > 0


TWO = r"""
import json, os, sys
import numpy as np
import torch
from repro_torch.runtime import multiproc
rank, world = multiproc.init_from_env()
torch.set_num_threads(1)
import dataclasses
import torch.distributed as dist
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import snapshot
from repro_torch.configs.base import (RehearsalConfig, ResilienceConfig, RunConfig,
                                      ScenarioConfig, TrainConfig)
from repro_torch.convert import load_named
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step, shard_host_batch
from repro_torch.rng import fold_in
from repro_torch.scenario import ContinualTrainer, TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state

tmp = os.environ["MESH_TMP"]
ref = np.load(os.path.join(tmp, "init.npz"))
V, S, B = 128, 16, 8
cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
run = RunConfig(model=cfg,
                train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                  linear_scaling=False, compute_dtype="float32"),
                rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4,
                                          num_representatives=2, num_candidates=6,
                                          mode="async", label_field="labels"),
                scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                        num_tasks=2, steps_per_epoch=4, batch_size=B,
                                        vocab_size=V, seq_len=S, auto_defaults=False))
mesh = make_mesh((world, 1), ("data", "model"))
out = {"rank": rank}

# one pipelined step consuming a pending slot that is valid on rank 0 only
built = build_train_step(run, mesh, exchange="local", buffer_budget_bytes=None, device="cpu")
params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
load_named(params, {k: ref[k] for k in ref.files if not k.startswith("_")})
reps = {k: torch.from_numpy(ref[f"_reps/{k}"][rank]) for k in ("tokens", "labels", "task")}
valid = torch.from_numpy(ref["_valid"][rank])
batch = shard_host_batch({k: ref[f"_batch/{k}"] for k in ("tokens", "labels", "task")}, mesh)
*_, m = built.fn(params, opt, buf, reps, valid, batch, 0)
out["loss"] = float(m["loss"])

# a checkpointed run of 4 steps, restored at step 2 and replayed
ckpt = os.path.join(tmp, "ckpt")
trainer = ContinualTrainer(run, device="cpu", mesh=mesh, exchange="full", ckpt_dir=ckpt,
                           ckpt_every=2)
res = trainer.fit(num_tasks=1)
state, meta = trainer.restore_mesh_state(step=2)
step = trainer.mesh_step()
for s in range(int(meta["global_step"]), 4):
    batch = shard_host_batch(trainer.scenario.batch(0, B, s), mesh)
    state, _ = step(state, batch, fold_in(run.scenario.seed, s))
got, want = snapshot(state)[0], snapshot(trainer.final_state)[0]
out["restored_equal"] = set(got) == set(want) and all(
    np.array_equal(got[k], want[k]) for k in want)
out["steps"] = CheckpointManager(trainer._rank_dir()).list_steps()
out["pending_rows"] = int(trainer.final_state[4].shape[0])

# resilient runs, restart checkpoints every 2 steps, so that task 1 starts on
# one (step 4): clean; rank 0 alone failing before step 5; rank 0's step 5
# raising after its collectives; rank 0 failing before step 7 while rank 1's
# step-6 checkpoint is lost (its newest lags, so both restore step 4)
import shutil
import time
from repro_torch import obs
from repro_torch.runtime import InjectedFailure

res_cfg = ResilienceConfig(checkpoint_every=2, max_restarts=2)


def resilient(name, fail_at=None, after_step=False, lose=None):
    box, fired = {}, []

    def hook(s):
        if lose is not None and rank == 1 and s == fail_at and not fired:
            fired.append(s)  # rank 1 goes on, its newest checkpoint lost once written
            path = os.path.join(box["t"]._rank_dir(), "resilient", f"step_{lose:010d}")
            deadline = time.monotonic() + 60
            while not os.path.exists(path) and time.monotonic() < deadline:
                time.sleep(0.01)
            shutil.rmtree(path)
        if rank == 0 and s == fail_at and not after_step and not fired:
            fired.append(s)
            raise InjectedFailure(f"rank 0 before step {s}")

    trainer = ContinualTrainer(run, device="cpu", mesh=mesh, exchange="full",
                               ckpt_dir=os.path.join(tmp, name), resilience=res_cfg,
                               overrides={"failure_hook": hook})
    box["t"] = trainer
    if after_step:
        make = trainer.mesh_step

        def mesh_step():
            inner, calls = make(), []

            def step(state, batch, key):
                out = inner(state, batch, key)
                calls.append(1)
                if rank == 0 and len(calls) == fail_at + 1:
                    raise InjectedFailure(f"rank 0 after step {fail_at}")
                return out

            step._sanitizer = inner._sanitizer
            return step

        trainer.mesh_step = mesh_step
    _, bus = obs.configure(None)
    try:
        r = trainer.fit()
    finally:
        obs.shutdown()
    got = snapshot(trainer.final_state)[0]
    return r, got, [e["step"] for e in bus.of_kind("restart")]


clean, clean_state, _ = resilient("res_clean")
out["resilient"] = {}
for name, kw in (("before", dict(fail_at=5)), ("after", dict(fail_at=5, after_step=True)),
                 ("lagging", dict(fail_at=7, lose=6))):
    r, got, restored = resilient("res_" + name, **kw)
    out["resilient"][name] = {
        "restarts": r.restarts, "restored": restored,
        "history_equal": r.history == clean.history, "losses_equal": r.losses == clean.losses,
        "acc_equal": r.accuracy_matrix.tolist() == clean.accuracy_matrix.tolist(),
        "state_equal": set(got) == set(clean_state) and all(
            np.array_equal(got[k], clean_state[k]) for k in clean_state)}
out["resilient_history_len"] = len(clean.history)

# the train CLI with --resilience on the 2 ranks
from repro_torch.launch import train as train_cli
cli = train_cli.main(["--arch", "smollm-135m", "--reduced", "--tasks", "1", "--steps-per-task",
                      "2", "--seq-len", "16", "--global-batch", "4", "--device", "cpu",
                      "--mesh", "2x1", "--ckpt-dir", os.path.join(tmp, "cli"), "--resilience",
                      "--resilience-checkpoint-every", "1"])
out["cli"] = {"losses": cli.losses, "restarts": cli.restarts,
              "steps": CheckpointManager(os.path.join(tmp, "cli", f"rank_{rank}",
                                                      "resilient")).list_steps()}
print(json.dumps(out))
del trainer, built, step, state, params, opt, buf
import gc
gc.collect()
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX model's loss on a global augmented batch (the reference), and
    the ``TWO`` launch's report of each rank."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jreduced
    from repro.core import distributed as jdist
    from repro.models import StackCtx as JaxCtx
    from repro.models import build_model as jbuild
    from repro_torch import configs
    from repro_torch.convert import lm_named_from_tree

    tmp_path = tmp_path_factory.mktemp("two_ranks")
    V, S, B, r = 128, 16, 8, 2
    jcfg = dataclasses.replace(jreduced("smollm-135m"), vocab_size=V, num_layers=2)
    tcfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=S)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32),
             "task": np.zeros((B,), np.int32)}
    batch["labels"][4:, 6:] = -1  # rank 1's rows hold fewer valid positions too
    reps = {"tokens": rng.integers(0, V, (2, r, S)).astype(np.int32),
            "labels": rng.integers(0, V, (2, r, S)).astype(np.int32),
            "task": np.zeros((2, r), np.int32)}
    valid = np.array([[True, True], [False, False]])
    arrays = dict(lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jparams), tcfg))
    arrays.update({f"_batch/{k}": v for k, v in batch.items()})
    arrays.update({f"_reps/{k}": v for k, v in reps.items()})
    arrays["_valid"] = valid
    np.savez(str(tmp_path / "init.npz"), **arrays)
    res = _launch(TWO, 2, tmp_path, {"MESH_TMP": str(tmp_path)})

    ctx = JaxCtx(cfg=jcfg, compute_dtype=jnp.float32, remat="none")
    aug = jdist.augment_global({k: jnp.asarray(v) for k, v in batch.items()},
                               {k: jnp.asarray(v) for k, v in reps.items()},
                               jnp.asarray(valid), 2, "labels")
    want = float(jmodel.loss(jparams, aug, ctx)[0])
    halves = [float(jmodel.loss(jparams, {k: v[w * (4 + r):(w + 1) * (4 + r)]
                                          for k, v in aug.items()}, ctx)[0]) for w in range(2)]
    return want, sum(halves) / 2, res


def test_two_ranks_take_the_global_token_mean_and_restart_bit_for_bit(two_ranks):
    """Rank 0 consumes 2 valid representatives, rank 1 none: the step's loss
    (every rank's) is the reference's loss on the global augmented batch
    (the sum of every valid token's NLL over the global count), not the
    mean of the two ranks' means. Then a 2-rank run checkpointed every 2
    steps: each rank's step-2 checkpoint, restored and replayed, ends on
    its step-4 state bit for bit."""
    want, mean_of_means, res = two_ranks
    assert abs(mean_of_means - want) > 1e-3  # the two reductions differ here
    for rr in res:
        assert abs(rr["loss"] - want) <= 1e-5 * abs(want), (rr["loss"], want, mean_of_means)
        assert rr["restored_equal"] and rr["steps"] == [2, 4] and rr["pending_rows"] == 2
    assert res[0]["loss"] == res[1]["loss"]


@pytest.mark.parametrize("case", ["before", "after", "lagging"])
def test_two_ranks_agree_on_every_restart(two_ranks, case):
    """``ContinualTrainer(mesh=2x1, resilience=...)`` with restart
    checkpoints every 2 steps, 2 tasks of 4 (task 1 starts on a checkpoint
    step: Queue 3 F2). Rank 0 alone fails, before step 5 (its hook), after
    step 5 (its step raises once its collectives are done), or before step 7
    while rank 1's step-6 checkpoint is lost. Both ranks restart once,
    restore the same step (the newest both hold: 4 in the lagging case),
    and end equal to the clean run bit for bit: history, losses, accuracy
    matrix, and every array of the state (parameters, optimizer, buffer,
    pending slot, issue key)."""
    want = {"before": 4, "after": 4, "lagging": 4}[case]
    for rr in two_ranks[2]:
        got = rr["resilient"][case]
        assert got["restarts"] == 1 and got["restored"] == [want], got
        assert got["history_equal"] and got["losses_equal"] and got["acc_equal"], got
        assert got["state_equal"], got
        assert rr["resilient_history_len"] == 8  # every step of both tasks, none twice


def test_train_cli_runs_resilient_on_two_ranks(two_ranks):
    """``launch.train --mesh 2x1 --resilience`` on two gloo ranks: the same
    losses on both, and each rank's restart checkpoints under its own
    directory."""
    a, b = (rr["cli"] for rr in two_ranks[2])
    assert a["losses"] == b["losses"] and len(a["losses"]) == 2
    assert np.isfinite(a["losses"]).all() and a["restarts"] == b["restarts"] == 0
    assert a["steps"] == b["steps"] == [0, 1, 2]
