"""The port's exchange and data-parallel step across two gloo processes.

Each test starts two worker processes that rendezvous through a file in the
test's own ``tmp_path`` (``init_method="file://..."``: no port is chosen
before the workers start, so no parallel test can take it in between), run
the scenario and print a JSON result line.
"""
import json
import os
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
rank, world, rendezvous = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
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


# Both ranks leave their collectives before either tears gloo down. Then the
# body's objects go (the step's closures hold the process group), so that
# ``destroy_process_group`` frees the group there and not the interpreter's
# teardown, where freeing it aborted a worker now and then ("terminate
# called without an active exception") after it had printed its result.
TEARDOWN = """
dist.barrier()
for _name in [n for n in globals() if not n.startswith("__") and n != "dist"]:
    del globals()[_name]
import gc
gc.collect()
dist.destroy_process_group()
"""


def _run(body: str, tmp_path):
    """Run ``body`` on WORLD gloo ranks that meet through a file store in
    ``tmp_path``; return their result lines by rank."""
    code = textwrap.dedent(PRELUDE) + textwrap.dedent(body) + TEARDOWN
    rendezvous = str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(WORLD), rendezvous],
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


def test_exchange_is_permutation(tmp_path):
    """§IV-C conservation: across the all_to_all, the multiset of sent
    candidates equals the multiset of received ones, and peer i's item for
    worker w arrives in slot i."""
    res = _run(EXCHANGE, tmp_path)
    sent = sorted(x for r in res for x in r["sent"])
    recv = sorted(x for r in res for x in r["recv"])
    assert sent == recv
    for r in res:
        assert r["recv"] == [100.0 * i + r["rank"] for i in range(WORLD)]
        assert all(r["valid"])


def test_data_parallel_step_keeps_replicas_equal(tmp_path):
    """Two ranks, full exchange, pipelined: gradients are mean-reduced so the
    replicas stay bit-identical; with fewer peers than representatives
    (2 < r = 3) the pending slot holds one row per peer, as the reference's
    ``argsort(scores)[:r]`` does."""
    res = _run(FLAT + STEP, tmp_path)
    for r in res:
        assert r["params_equal"]
        assert r["pending_rows"] == [WORLD] * 4
        assert all(x == x and abs(x) < 1e6 for x in r["losses"])  # finite
        assert r["fill"] > 0 and all(r["valid"])
    assert res[0]["losses"] == res[1]["losses"]  # loss is mean-reduced too


def test_tiered_data_parallel_step_keeps_replicas_equal(tmp_path):
    """The same two-rank pipelined step with the tiered store (fused
    kernels): demotions reach each rank's cold tier, the exchange carries
    the decoded records, and the replicas stay bit-identical."""
    res = _run(TIERED + STEP, tmp_path)
    for r in res:
        assert r["params_equal"]
        assert r["pending_rows"] == [WORLD] * 4
        assert all(x == x and abs(x) < 1e6 for x in r["losses"])
        assert r["fill"] > 2 * 2 and r["cold"] > 0 and all(r["valid"])
    assert res[0]["losses"] == res[1]["losses"]


# ---------------------------------------------------------------------------
# int8 gradient compression, policy aux and tap strategies across two ranks
# ---------------------------------------------------------------------------

COMPRESS = """
import numpy as np
from repro_torch.optim import compressed_psum
shapes = {"w": (5, 7), "b": (7,), "s": ()}
rng = np.random.default_rng(100 + rank)
grads = {k: torch.from_numpy(np.asarray(rng.normal(size=s) * 10.0 ** rng.integers(-3, 3),
                                         np.float32)) for k, s in shapes.items()}
ef = {k: torch.from_numpy(np.asarray(rng.normal(size=s) * 1e-3, np.float32))
      for k, s in shapes.items()}
out = []
for it in range(3):  # the new error feedback feeds the next round, as in training
    means, ef = compressed_psum(grads, dist.group.WORLD, ef, world)
    out.append({k: [means[k].reshape(-1).tolist(), ef[k].reshape(-1).tolist()]
                for k in shapes})
print(json.dumps({"rank": rank, "out": out}))
"""


def test_compressed_psum_matches_jax_bit_for_bit(tmp_path):
    """Two gloo ranks against the reference's ``compressed_psum`` under
    ``jax.jit(jax.vmap(..., axis_name))`` (jitted, as the reference's step
    runs it) on the same gradients and error feedback, three rounds: the
    means and the new error feedback bit for bit on both ranks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.optim.grad_compress import compressed_psum as jcompressed_psum

    res = _run(COMPRESS, tmp_path)
    shapes = {"w": (5, 7), "b": (7,), "s": ()}
    grads, ef = [], []
    for rank in range(WORLD):
        rng = np.random.default_rng(100 + rank)
        grads.append({k: np.asarray(rng.normal(size=s) * 10.0 ** rng.integers(-3, 3),
                                    np.float32) for k, s in shapes.items()})
        ef.append({k: np.asarray(rng.normal(size=s) * 1e-3, np.float32)
                   for k, s in shapes.items()})
    g = {k: jnp.stack([grads[r][k] for r in range(WORLD)]) for k in shapes}
    e = {k: jnp.stack([ef[r][k] for r in range(WORLD)]) for k in shapes}
    fn = jax.jit(jax.vmap(lambda g_, e_: jcompressed_psum(g_, "dp", e_, WORLD), axis_name="dp"))
    for it in range(3):
        means, e = fn(g, e)
        for r in res:
            for k in shapes:
                got_mean, got_ef = (np.asarray(x, np.float32) for x in r["out"][it][k])
                np.testing.assert_array_equal(got_mean.view(np.uint32),
                                              np.asarray(means[k][r["rank"]]).reshape(-1)
                                              .view(np.uint32), err_msg=f"{k} mean {it}")
                np.testing.assert_array_equal(got_ef.view(np.uint32),
                                              np.asarray(e[k][r["rank"]]).reshape(-1)
                                              .view(np.uint32), err_msg=f"{k} ef {it}")
    assert res[0]["out"][2]["w"][0] == res[1]["out"][2]["w"][0]  # replicas agree


STRATEGY_STEP = """
from repro_torch.buffer.state import ItemSpec
from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import RehearsalConfig, StrategyConfig, TrainConfig
from repro_torch.data import ClassIncrementalImages, ImageStreamConfig
from repro_torch.models import cross_entropy, init_cnn, apply_cnn, cnn_outputs
from repro_torch.optim import init_error_feedback, make_optimizer
from repro_torch.strategy import get_strategy, init_carry, make_cl_step

cfg = resnet50_cl.CNNConfig("t", "resnet18", num_classes=8, width=4,
                            stage_blocks=(1, 1), bottleneck=False, image_size=8)
rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                       num_candidates=4, mode="async", label_field="label", policy=POLICY)
train = TrainConfig(peak_lr=0.1, warmup_steps=1, grad_compress=COMPRESS)
init, update = make_optimizer(train, n_workers=world)

def loss_fn(model, batch):
    logits = apply_cnn(model, batch["images"])
    return cross_entropy(logits[:, None, :], batch["label"][:, None]), {}

def forward_outputs(model, batch):
    return cnn_outputs(model, batch["images"])

model = init_cnn(torch.Generator().manual_seed(0), cfg, device="cpu")
params = dict(model.named_parameters())
spec = {"images": ItemSpec((8, 8, 3), torch.float32), "label": ItemSpec((), torch.int32),
        "task": ItemSpec((), torch.int32)}
strat = get_strategy(STRATEGY)
aux_spec = strat.record_fields(spec, {"logits": ItemSpec((8,), torch.float32),
                                      "embed": ItemSpec((8,), torch.float32)}, StrategyConfig())
ef = init_error_feedback(params) if COMPRESS == "int8" else None
carry = init_carry(model, init(params), dict(spec, **aux_spec), rcfg, ef=ef,
                   label_field="label", seed=3, device="cpu")
step = make_cl_step(loss_fn, update, rcfg, strategy=strat, group=dist.group.WORLD,
                    exchange="full", label_field="label", compress=train.grad_compress,
                    strategy_cfg=StrategyConfig(), forward_outputs=forward_outputs,
                    aux_spec=aux_spec, device="cpu")
stream = ClassIncrementalImages(ImageStreamConfig(num_tasks=2, classes_per_task=4,
                                                  image_size=8))
losses = []
for s in range(4):
    carry, m = step(carry, stream.batch(0, 6, 10 * s + rank), s)
    losses.append(float(m["loss"]))
flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
gathered = [torch.zeros_like(flat) for _ in range(world)]
dist.all_gather(gathered, flat)
aux = carry.buffer.aux
print(json.dumps({
    "rank": rank, "losses": losses, "fill": float(m["buffer_fill"]),
    "params_equal": all(torch.equal(g, gathered[0]) for g in gathered),
    "aux": {k: [list(v.shape), str(v.dtype), v.reshape(-1).tolist()] for k, v in aux.items()}
           if aux != () else None,
    "counts": carry.buffer.counts.tolist(),
    "ef_abs": (None if carry.ef is None
               else float(sum(e.abs().sum() for e in carry.ef.values()))),
    "reps": sorted(carry.pipe.reps), "valid": carry.pipe.valid.tolist(),
    "stored": {k: float(carry.buffer.data[k].abs().sum()) for k in aux_spec}}))
"""


def _strategy_run(strategy, policy, compress, tmp_path):
    return _run(f"STRATEGY, POLICY, COMPRESS = {strategy!r}, {policy!r}, {compress!r}\n"
                + STRATEGY_STEP, tmp_path)


def test_int8_compressed_step_keeps_replicas_equal(tmp_path):
    """``TrainConfig.grad_compress='int8'`` on two ranks: every rank gets the
    same int8-reduced mean, so the replicas stay bit-identical, and the
    error feedback carries a residual."""
    res = _strategy_run("rehearsal", "reservoir", "int8", tmp_path)
    for r in res:
        assert r["params_equal"] and r["ef_abs"] > 0
        assert all(x == x and abs(x) < 1e6 for x in r["losses"])
    assert res[0]["losses"] == res[1]["losses"]


@pytest.mark.parametrize("policy", ["fifo", "grasp"])
def test_policies_preserve_aux_through_distributed_carry(policy, tmp_path):
    """Each rank's buffer keeps its policy's aux through the data-parallel
    step (shapes and dtypes of ``init_aux``, values of its own buffer): FIFO's
    cursor equals the counts of a bucket that is still filling and stays on
    the ring; GRASP holds a finite distance for every filled slot."""
    res = _strategy_run("rehearsal", policy, "none", tmp_path)
    for r in res:
        assert r["params_equal"] and r["aux"] is not None
        if policy == "fifo":
            shape, dtype, cursor = r["aux"]["cursor"]
            assert shape == [2] and dtype == "torch.int32" and set(r["aux"]) == {"cursor"}
            assert all(0 <= c < 4 for c in cursor)
            assert all(c == n for c, n in zip(cursor, r["counts"]) if n < 4)
        else:
            assert {k: v[:2] for k, v in r["aux"].items()} == {
                "proto": [[2, 192], "torch.float32"], "proto_n": [[2], "torch.float32"],
                "dist": [[2, 4], "torch.float32"]}
            filled = sum(d < 1e29 for d in r["aux"]["dist"][2])
            assert filled == sum(r["counts"]) > 0


@pytest.mark.parametrize("strategy,policy", [("der_pp", "reservoir"), ("grasp_embed", "grasp")])
def test_tap_strategy_data_parallel_step(strategy, policy, tmp_path):
    """A tap strategy on two ranks with the full exchange: the extra fields
    (logits; the embedding) ride the all_to_all as record leaves, the
    replicas stay bit-identical, and the stored fields are filled."""
    res = _strategy_run(strategy, policy, "none", tmp_path)
    extra = "logits" if strategy == "der_pp" else "embed"
    for r in res:
        assert r["params_equal"] and extra in r["reps"] and all(r["valid"])
        assert r["stored"][extra] > 0 and r["fill"] > 0
    assert res[0]["losses"] == res[1]["losses"]
