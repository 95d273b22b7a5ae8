"""Real multi-process groups (``repro_torch.runtime.multiproc``): two gloo
ranks on one host, one of them killed mid-run, both ranks' checkpoints
pooled onto one rank, training resumed (the reference's
``tests/test_multiproc.py`` flat case, on the port).

The ranks meet through a file in the test's ``tmp_path``; the kill is a
real ``os._exit``, in a tail with no collectives, so that it cannot hang
the survivor.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.runtime import multiproc

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

SETUP = r"""
import numpy as np
import torch
from repro_torch.buffer.state import ItemSpec
from repro_torch.configs.base import RehearsalConfig
from repro_torch.strategy import init_carry, make_cl_step

torch.set_num_threads(1)
RCFG = RehearsalConfig(num_buckets=2, slots_per_bucket=8, num_representatives=4,
                       num_candidates=4, mode="async", policy="fifo", label_field="label")
SPEC = {"x": ItemSpec((3,), torch.float32), "label": ItemSpec((), torch.int32),
        "task": ItemSpec((), torch.int32)}


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))


def loss_fn(model, batch):
    return torch.mean((batch["x"] @ model.w - batch["label"].float()) ** 2), {}


@torch.no_grad()
def opt_update(grads, opt, params):
    for k, p in params.items():
        p.sub_(0.05 * grads[k])
    return params, opt, {}


def fresh():
    return init_carry(Linear(), None, SPEC, RCFG, label_field="label", seed=0, device="cpu")


def step_fn():
    return make_cl_step(loss_fn, opt_update, RCFG, label_field="label", task_field="task",
                        exchange="local", device="cpu")


def batch(seed, s):
    r = np.random.default_rng(seed)
    return {"x": r.normal(size=(4, 3)).astype(np.float32),
            "label": r.integers(0, 4, size=(4,)).astype(np.int32),
            "task": np.full((4,), s % 2, np.int32)}
"""

# Each rank: join the group, prove it is real (an all-reduce every step),
# train its own rehearsal carry for 10 lockstep steps, checkpoint to
# ckpt_root/rank{pid}, then go on WITHOUT collectives; rank 1 dies uncleanly
# at step 11 (os._exit skips atexit and flushes: the survivor must not rely
# on the victim saying goodbye). The survivor leaves with os._exit too: its
# group has a dead peer, and its state is on disk.
WORKER = r"""
import os
from repro_torch.runtime import multiproc
pid, nprocs = multiproc.init_from_env()
import torch.distributed as dist
from repro_torch.checkpoint import CheckpointManager
""" + SETUP + r"""
carry, step = fresh(), step_fn()
for s in range(10):
    carry, m = step(carry, batch(1000 * (pid + 1) + s, s), s)
    total = torch.full((1,), float(pid + 1))
    dist.all_reduce(total)  # every rank contributes
assert float(total) == sum(range(1, nprocs + 1)), float(total)
print(f"PSUM {float(total)}", flush=True)
ckpt = CheckpointManager(os.path.join(os.environ["TEST_CKPT_ROOT"], f"rank{pid}"),
                         async_save=False)
ckpt.save(10, carry, {"cursor": 10, "rank": pid})
print(f"FILL {int(carry.buffer.counts.sum())}", flush=True)
for s in range(10, 13):  # collective-free tail: a death here cannot hang a peer
    carry, m = step(carry, batch(1000 * (pid + 1) + s, s), s)
    if pid == 1 and s == 11:
        os._exit(1)  # unclean death: no goodbye, no flush, no atexit
print("SURVIVED", flush=True)
os._exit(0)
"""


def test_distributed_available_says_why():
    ok, reason = multiproc.distributed_available()
    assert isinstance(ok, bool) and reason


def test_worker_env_carries_the_topology(tmp_path):
    env = multiproc.worker_env(3, 2, str(tmp_path / "rv"), base_env={"A": "1"})
    assert env == {"A": "1", multiproc.ENV_RENDEZVOUS: str(tmp_path / "rv"),
                   multiproc.ENV_NPROCS: "3", multiproc.ENV_PID: "2"}


def test_a_worker_past_its_timeout_is_reported_as_minus_9(tmp_path):
    res = multiproc.launch_workers("import time; time.sleep(30)", 1, timeout=1.0,
                                   rendezvous_dir=str(tmp_path))
    assert [r.returncode for r in res] == [-9]


def test_two_gloo_ranks_kill_one_and_resume_pooled(tmp_path):
    ok, reason = multiproc.distributed_available()
    if not ok:
        pytest.skip(f"no gloo group here: {reason}")
    results = multiproc.launch_workers(
        WORKER, 2, timeout=120.0, pythonpath=SRC, rendezvous_dir=str(tmp_path),
        extra_env={"TEST_CKPT_ROOT": str(tmp_path / "ckpt"), "OMP_NUM_THREADS": "1"})
    r0, r1 = results
    assert r0.returncode == 0, (r0.stdout, r0.stderr)
    assert r1.returncode == 1, (r1.stdout, r1.stderr)  # the killed rank
    assert "PSUM 3.0" in r0.stdout and "PSUM 3.0" in r1.stdout  # 1 + 2: both joined
    assert "SURVIVED" in r0.stdout and "SURVIVED" not in r1.stdout

    # resume on one rank: pool both ranks' buffers
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import reshard_carry

    env = {}
    exec(SETUP, env)  # the workers' model, step and batches, in this process
    shards, fills = [], []
    for rank in range(2):
        state, meta = CheckpointManager(str(tmp_path / "ckpt" / f"rank{rank}")).restore(
            env["fresh"]())
        assert meta["cursor"] == 10 and meta["rank"] == rank
        assert state.pipe.key == 9  # the last step's key, restored
        shards.append(state)
        fills.append(int(state.buffer.counts.sum()))
    assert fills == [int(r.stdout.split("FILL ")[1].split()[0]) for r in (r0, r1)]
    (resumed,) = reshard_carry(shards, 1, policy="fifo")
    # every stored representative survives the 2 -> 1 pooling, up to capacity
    assert int(resumed.buffer.counts.sum()) == min(sum(fills), 2 * 8)
    assert resumed.buffer.counts.shape == (2,)
    step = env["step_fn"]()
    for s in range(13, 15):
        resumed, m = step(resumed, env["batch"](7 + s, s), s)
    assert np.isfinite(float(m["loss"])) and float(m["buffer_fill"]) > 0
    assert torch.isfinite(resumed.params.w).all()
