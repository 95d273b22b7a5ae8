"""Agreed restarts on a model axis: ``ContinualTrainer(mesh=DxM,
resilience=...)`` on 1 x 2 and 2 x 2 gloo meshes (one module-scoped spawn,
both groups at once, each meeting through a file in the test's temporary
directory).

Every rank's ``ResilientLoop`` decides over every rank of the mesh (the data
ranks and the model ranks of each row), each rank restoring its own shards
from ``ckpt_dir/rank_<dp>_<model>/resilient``. One model rank fails, before
a step (its hook) or after a step's collectives (its step raises), and
every rank restarts once from the same step and ends bit for bit with the
run that did not fail: history, losses, accuracy matrix and every array of
the state (shards, optimizer, buffer, pending slot). Deterministic on the
CPU.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 2), (2, 2))
# (name, global rank that fails, step, after the step's collectives)
FAILURES = {(1, 2): (("before", 1, 5, False), ("after", 1, 5, True)),
            (2, 2): (("before", 3, 5, False), ("after", 2, 6, True))}

SIDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rendezvous, tmp, d, m = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                      sys.argv[4], int(sys.argv[5]), int(sys.argv[6]))
failures = json.loads(sys.argv[7])
dist.init_process_group("gloo", init_method=f"file://{{rendezvous}}", rank=rank,
                        world_size=world)
import dataclasses
from repro_torch import configs, obs
from repro_torch.checkpoint.manager import snapshot
from repro_torch.configs.base import (RehearsalConfig, ResilienceConfig, RunConfig,
                                      ScenarioConfig, StrategyConfig, TrainConfig)
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import InjectedFailure
from repro_torch.scenario import ContinualTrainer

cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=64, num_layers=2)
run = RunConfig(
    model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                 linear_scaling=False, compute_dtype="float32"),
    rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                              num_candidates=6, mode="async", label_field="labels"),
    strategy=StrategyConfig(),
    scenario=ScenarioConfig(name="class_incremental", modality="tokens", strategy="rehearsal",
                            num_tasks=2, epochs_per_task=1, steps_per_epoch=4, batch_size=4,
                            vocab_size=64, seq_len=16, auto_defaults=False))
mesh = make_mesh((d, m), ("data", "model"))
res_cfg = ResilienceConfig(checkpoint_every=2, max_restarts=2)


def resilient(name, fail_rank=-1, fail_at=-1, after_step=False):
    fired = []

    def hook(s):
        if rank == fail_rank and s == fail_at and not after_step and not fired:
            fired.append(s)
            raise InjectedFailure(f"rank {{rank}} before step {{s}}")

    trainer = ContinualTrainer(run, device="cpu", mesh=mesh, ckpt_dir=os.path.join(tmp, name),
                               resilience=res_cfg, overrides={{"failure_hook": hook}})
    if after_step:
        make = trainer.mesh_step

        def mesh_step():
            inner, calls = make(), []

            def step(state, batch, key):
                out = inner(state, batch, key)
                calls.append(1)
                if rank == fail_rank and len(calls) == fail_at + 1:
                    raise InjectedFailure(f"rank {{rank}} after step {{fail_at}}")
                return out

            step._sanitizer = inner._sanitizer
            return step

        trainer.mesh_step = mesh_step
    _, bus = obs.configure(None)
    try:
        r = trainer.fit()
    finally:
        obs.shutdown()
    return r, snapshot(trainer.final_state)[0], [e["step"] for e in bus.of_kind("restart")], \\
        trainer._rank_dir()


clean, clean_state, _, rank_dir = resilient("clean")
out = {{"rank_dir": os.path.relpath(rank_dir, tmp), "history_len": len(clean.history),
        "losses": clean.losses, "cases": {{}}}}
for name, fail_rank, fail_at, after in failures:
    r, got, restored, _ = resilient(name, fail_rank, fail_at, after)
    out["cases"][name] = {{
        "restarts": r.restarts, "restored": restored,
        "history_equal": r.history == clean.history, "losses_equal": r.losses == clean.losses,
        "acc_equal": r.accuracy_matrix.tolist() == clean.accuracy_matrix.tolist(),
        "state_equal": set(got) == set(clean_state) and all(
            np.array_equal(got[k], clean_state[k]) for k in clean_state)}}
with open(os.path.join(tmp, f"out_{{rank}}.json"), "w") as f:
    json.dump(out, f)
import gc
gc.collect()
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """Every mesh's ranks at once; ``{(d, m): [each rank's report]}``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    code = textwrap.dedent(SIDE.format())
    procs, dirs = [], {}
    for d, m in MESHES:
        tmp = tmp_path_factory.mktemp(f"restarts_{d}x{m}")
        dirs[(d, m)] = tmp
        procs += [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(d * m), str(tmp / "rdv"), str(tmp),
             str(d), str(m), json.dumps(FAILURES[(d, m)])], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(d * m)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("worker timed out")
        assert p.returncode == 0, err[-4000:]
    return {dm: [json.loads((dirs[dm] / f"out_{r}.json").read_text())
                 for r in range(dm[0] * dm[1])] for dm in MESHES}


@pytest.mark.parametrize("case", ["before", "after"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
def test_a_model_rank_fails_and_every_rank_restarts_bit_for_bit(meshes, mesh, case):
    """One model rank fails (1 x 2: model rank 1; 2 x 2: data rank 1's model
    rank 1 before step 5, data rank 1's model rank 0 after step 6's
    collectives). Every rank of the mesh restarts once, from the same step
    (the newest restart checkpoint: 4, or 6 when the step that raises is
    6), and ends equal to the run without the failure, bit for bit."""
    for r, rep in enumerate(meshes[mesh]):
        got = rep["cases"][case]
        want = {"before": 4, "after": 4 if mesh == (1, 2) else 6}[case]
        assert got["restarts"] == 1 and got["restored"] == [want], (r, got)
        assert got["history_equal"] and got["losses_equal"] and got["acc_equal"], (r, got)
        assert got["state_equal"], (r, got)
        assert rep["history_len"] == 8


@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
def test_each_rank_keeps_its_own_shards_and_the_row_agrees(meshes, mesh):
    """Each rank checkpoints under ``rank_<dp>_<model>``; the ranks of a mesh
    report the same global losses, finite."""
    d, m = mesh
    reps = meshes[mesh]
    assert [rep["rank_dir"] for rep in reps] == [f"clean/rank_{r // m}_{r % m}"
                                                 for r in range(d * m)]
    assert all(rep["losses"] == reps[0]["losses"] for rep in reps)
    assert np.isfinite(reps[0]["losses"]).all() and len(reps[0]["losses"]) == 8
