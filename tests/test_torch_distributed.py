"""The port's exchange and data-parallel step across two gloo processes.

Each test starts two worker processes that rendezvous on a free localhost
port bound for this run (tests run in parallel, so no fixed port), run the
scenario and print a JSON result line.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import json, sys
import torch
import torch.distributed as dist
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
"""

EXCHANGE = """
from repro_torch.core.distributed import _exchange
# worker w sends payload w*100 + j to peer j
sent = (torch.arange(world) + 100 * rank).float()
recv, rvalid = _exchange({"x": sent}, torch.ones(world, dtype=torch.bool),
                         dist.group.WORLD)
print(json.dumps({"rank": rank, "sent": sent.tolist(), "recv": recv["x"].tolist(),
                  "valid": rvalid.tolist()}))
"""

STEP = """
from repro_torch.buffer.state import ItemSpec
from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import RehearsalConfig, TrainConfig
from repro_torch.data import ClassIncrementalImages, ImageStreamConfig
from repro_torch.models import cross_entropy, init_cnn, apply_cnn
from repro_torch.optim import make_optimizer
from repro_torch.strategy import init_carry, make_cl_step

cfg = resnet50_cl.CNNConfig("t", "resnet18", num_classes=8, width=4,
                            stage_blocks=(1, 1), bottleneck=False, image_size=8)
rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                       num_candidates=4, mode="async", label_field="label", **TIERING)
init, update = make_optimizer(TrainConfig(peak_lr=0.1, warmup_steps=1), n_workers=world)

def loss_fn(model, batch):
    logits = apply_cnn(model, batch["images"])
    return cross_entropy(logits[:, None, :], batch["label"][:, None]), {}

model = init_cnn(torch.Generator().manual_seed(0), cfg, device="cpu")
spec = {"images": ItemSpec((8, 8, 3), torch.float32), "label": ItemSpec((), torch.int32),
        "task": ItemSpec((), torch.int32)}
carry = init_carry(model, init(dict(model.named_parameters())), spec, rcfg,
                   label_field="label", seed=3, device="cpu")
step = make_cl_step(loss_fn, update, rcfg, group=dist.group.WORLD, exchange="full",
                    label_field="label", device="cpu")
stream = ClassIncrementalImages(ImageStreamConfig(num_tasks=2, classes_per_task=4,
                                                  image_size=8))
losses, pending_rows = [], []
for s in range(4):
    carry, m = step(carry, stream.batch(0, 6, 10 * s + rank), s)
    losses.append(float(m["loss"]))
    pending_rows.append(int(carry.pipe.valid.shape[0]))
flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
gathered = [torch.zeros_like(flat) for _ in range(world)]
dist.all_gather(gathered, flat)
print(json.dumps({"rank": rank, "losses": losses, "pending_rows": pending_rows,
                  "params_equal": all(torch.equal(g, gathered[0]) for g in gathered),
                  "fill": float(m["buffer_fill"]), "valid": carry.pipe.valid.tolist(),
                  "cold": int(getattr(carry.buffer, "cold", carry.buffer).counts.sum())}))
"""
FLAT = "TIERING = {}\n"
TIERED = ("TIERING = dict(tiering='host', hot_slots=2, cold_slots=4, demote_stage=4, "
          "fused_kernels=True)\n")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(body: str):
    # both ranks leave their collectives before either tears gloo down
    code = textwrap.dedent(PRELUDE) + textwrap.dedent(body) + \
        "\ndist.barrier()\ndist.destroy_process_group()\n"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(WORLD), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(WORLD)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("gloo workers timed out")
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    return sorted(results, key=lambda r: r["rank"])


def test_exchange_is_permutation():
    """§IV-C conservation: across the all_to_all, the multiset of sent
    candidates equals the multiset of received ones, and peer i's item for
    worker w arrives in slot i."""
    res = _run(EXCHANGE)
    sent = sorted(x for r in res for x in r["sent"])
    recv = sorted(x for r in res for x in r["recv"])
    assert sent == recv
    for r in res:
        assert r["recv"] == [100.0 * i + r["rank"] for i in range(WORLD)]
        assert all(r["valid"])


def test_data_parallel_step_keeps_replicas_equal():
    """Two ranks, full exchange, pipelined: gradients are mean-reduced so the
    replicas stay bit-identical; with fewer peers than representatives
    (2 < r = 3) the pending slot holds one row per peer, as the reference's
    ``argsort(scores)[:r]`` does."""
    res = _run(FLAT + STEP)
    for r in res:
        assert r["params_equal"]
        assert r["pending_rows"] == [WORLD] * 4
        assert all(x == x and abs(x) < 1e6 for x in r["losses"])  # finite
        assert r["fill"] > 0 and all(r["valid"])
    assert res[0]["losses"] == res[1]["losses"]  # loss is mean-reduced too


def test_tiered_data_parallel_step_keeps_replicas_equal():
    """The same two-rank pipelined step with the tiered store (fused
    kernels): demotions reach each rank's cold tier, the exchange carries
    the decoded records, and the replicas stay bit-identical."""
    res = _run(TIERED + STEP)
    for r in res:
        assert r["params_equal"]
        assert r["pending_rows"] == [WORLD] * 4
        assert all(x == x and abs(x) < 1e6 for x in r["losses"])
        assert r["fill"] > 2 * 2 and r["cold"] > 0 and all(r["valid"])
    assert res[0]["losses"] == res[1]["losses"]
