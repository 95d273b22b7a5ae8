"""The port's ``CheckpointManager`` on the CPU: the full carry round-trips
(policy aux, the tiered stage, tap fields, ``OptState.step``, the pending
slot's key, bf16 leaves), a snapshot never aliases live tensors, an
unreadable newest checkpoint is skipped, and the same save / corrupt /
restore script gives the reference manager's steps.

Everything is held exactly: a checkpoint moves bytes.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import snapshot
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      StrategyConfig, TrainConfig)
from repro_torch.rng import fold_in
from repro_torch.scenario import ContinualTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: intra-op threads gain nothing while several test
    processes share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The reference's chaos sizes (tests/test_fault_tolerance.py), plus grasp.
KINDS = {
    "flat_fifo": dict(policy="fifo"),
    "tiered_fifo": dict(policy="fifo", tiering="host", hot_slots=3, cold_slots=9),
    "flat_grasp": dict(policy="grasp"),
    "der_pp": {},
}


def _run(kind, strategy=None, top_k=0, steps=8):
    rcfg = dict(num_buckets=4, slots_per_bucket=6, num_representatives=3, num_candidates=6,
                mode="async", label_field="label", **KINDS.get(kind, {}))
    return RunConfig(
        train=TrainConfig(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False),
        rehearsal=RehearsalConfig(**rcfg),
        strategy=StrategyConfig(alpha=0.3, beta=0.3, top_k=top_k),
        scenario=ScenarioConfig(strategy=strategy or ("der_pp" if kind == "der_pp"
                                                      else "rehearsal"),
                                num_tasks=2, epochs_per_task=1, steps_per_epoch=steps,
                                batch_size=8, image_size=8, classes_per_task=4,
                                auto_defaults=False))


def _advance(tr, carry, start, end, root=5):
    metrics = []
    for s in range(start, end):
        batch = tr._source(int(s >= 4))(s)
        carry, m = tr._step_fn(carry, batch, fold_in(root, s))
        metrics.append({k: float(v) for k, v in m.items()})
    return carry, metrics


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_full_carry_round_trips_and_continues_bit_for_bit(kind, tmp_path):
    """Stop at step 6, restore into a fresh carry, continue to 10: every leaf
    and every metric equal the uninterrupted run's. The restored policy aux,
    tiered stage and tap fields are the saved ones, not the template's."""
    tr = ContinualTrainer(_run(kind), device="cpu")
    ref, ref_metrics = _advance(tr, tr._init(tr.seed), 0, 10)
    half, _ = _advance(tr, tr._init(tr.seed), 0, 6)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(6, half, {"cursor": 6})
    saved, _ = snapshot(half)
    keys = set(saved)
    if kind.endswith("fifo"):
        assert any(k.endswith("aux/cursor") for k in keys)
    if kind == "flat_grasp":
        assert {"buffer/aux/dist", "buffer/aux/proto", "buffer/aux/proto_n"} <= keys
    if kind.startswith("tiered"):
        assert {"buffer/stage_valid", "buffer/stage_labels"} <= keys
        assert any(k.startswith("buffer/cold/data/images/") for k in keys)
    if kind == "der_pp":
        assert {f"buffer/data/{f}" for f in tr.aux_spec} <= keys and tr.aux_spec
    template = tr._init(tr.seed)
    assert template.opt.step == 0 and half.opt.step == 6
    restored, meta = mgr.restore(template)
    assert meta["cursor"] == 6 and meta["step"] == 6
    assert restored.params is template.params  # the model is restored in place
    assert restored.opt.step == 6 and restored.pipe.key == half.pipe.key != template.pipe.key
    _same_arrays(snapshot(restored)[0], saved)
    resumed, metrics = _advance(tr, restored, 6, 10)
    assert metrics == ref_metrics[6:]
    _same_arrays(snapshot(resumed)[0], snapshot(ref)[0])


def test_der_checkpoint_restore_then_continue(tmp_path):
    """The reference's DER case (``tests/test_der.py``): stored top-4 logits
    survive the round trip; stop at 8, restore, continue to 14 == the
    uninterrupted run, the model and the logit leaves bit-equal."""
    tr = ContinualTrainer(_run("der_top4", strategy="der", top_k=4, steps=14), device="cpu")
    assert set(tr.aux_spec) == {"logit_vals", "logit_idx"}
    ref, _ = _advance(tr, tr._init(tr.seed), 0, 14)
    half, _ = _advance(tr, tr._init(tr.seed), 0, 8)
    assert float(half.buffer.data["logit_vals"].abs().sum()) > 0
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(8, half, {"cursor": 8})
    restored, meta = mgr.restore(half)
    resumed, _ = _advance(tr, restored, int(meta["cursor"]), 14)
    for (name, a), b in zip(ref.params.named_parameters(), resumed.params.parameters()):
        assert torch.equal(a, b), name
    for f in ("logit_vals", "logit_idx"):
        assert torch.equal(ref.buffer.data[f], resumed.buffer.data[f])


def test_bf16_leaves_round_trip_through_their_16_bit_view(tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(5, 3).to(torch.bfloat16)
    state = {"model": model, "x": torch.randn(7, generator=gen).to(torch.bfloat16),
             "f32": torch.randn(3, generator=gen), "step": 11}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    with open(tmp_path / "step_0000000001" / "meta.json") as f:
        assert json.load(f)["dtypes"] == {"model/weight": "bfloat16", "model/bias": "bfloat16",
                                          "x": "bfloat16"}
    with np.load(tmp_path / "step_0000000001" / "state.npz") as z:
        assert z["x"].dtype == np.int16 and z["f32"].dtype == np.float32
    template = {"model": torch.nn.Linear(5, 3).to(torch.bfloat16),
                "x": torch.zeros(7, dtype=torch.bfloat16), "f32": torch.zeros(3), "step": 0}
    got, _ = mgr.restore(template)
    assert got["step"] == 11 and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], state["x"]) and torch.equal(got["f32"], state["f32"])
    assert torch.equal(got["model"].weight, model.weight)
    assert torch.equal(got["model"].bias, model.bias)


def test_mutating_tensors_after_save_returns_leaves_the_checkpoint_intact(tmp_path):
    """The steps write the carry in place, and ``.numpy()`` of a CPU tensor
    shares its memory: ``save`` must copy every leaf before it returns, not
    in the writer thread."""
    gen = torch.Generator().manual_seed(1)
    big = torch.randn(4_000_000, generator=gen)
    model = torch.nn.Linear(64, 64)
    state = {"big": big, "model": model, "small": torch.arange(5)}
    want = {"big": big.clone(), "small": state["small"].clone(),
            "w": model.weight.detach().clone()}
    mgr = CheckpointManager(str(tmp_path))  # async: the writer runs on
    mgr.save(1, state)
    big.add_(1.0)
    state["small"].mul_(0)
    with torch.no_grad():
        model.weight.zero_()
    mgr.wait()
    template = {"big": torch.zeros_like(big), "model": torch.nn.Linear(64, 64),
                "small": torch.zeros(5, dtype=torch.long)}
    got, _ = mgr.restore(template)
    assert torch.equal(got["big"], want["big"]) and torch.equal(got["small"], want["small"])
    assert torch.equal(got["model"].weight, want["w"])


def test_truncated_newest_checkpoint_is_skipped_and_an_explicit_step_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for s in (1, 2):
        mgr.save(s, {"w": torch.full((64,), float(s))}, {"cursor": s})
    path = tmp_path / "step_0000000002" / "state.npz"
    path.write_bytes(path.read_bytes()[:40])  # a rank killed mid-write
    template = {"w": torch.zeros(64)}
    got, meta = mgr.restore(template)
    assert meta["cursor"] == 1 and torch.equal(got["w"], torch.ones(64))
    with pytest.raises(Exception):
        mgr.restore({"w": torch.zeros(64)}, step=2)


def test_strict_restore_refuses_a_missing_leaf_and_lenient_keeps_the_template(tmp_path,
                                                                               caplog):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"a": torch.ones(2)})
    template = {"a": torch.zeros(2), "aux": {"cursor": torch.full((2,), 7)}}
    with pytest.raises(KeyError, match="aux/cursor"):
        mgr.restore(template)
    assert torch.equal(template["a"], torch.zeros(2))  # refused before any copy
    with caplog.at_level("WARNING", logger="repro_torch.checkpoint"):
        got, _ = mgr.restore(template, strict=False)
    assert torch.equal(got["a"], torch.ones(2))
    assert torch.equal(got["aux"]["cursor"], torch.full((2,), 7))
    assert "predates 1 state leaf" in caplog.text


def test_a_shape_mismatch_is_refused_before_any_copy(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.ones(2), "b": torch.ones(3)})
    template = {"a": torch.zeros(2), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(template, step=1)
    assert torch.equal(template["a"], torch.zeros(2))


def _script(mgr, root, make):
    """Save steps 1..5 (keep 3), then break them as a crash would: truncate
    step 5's state.npz, delete step 4's, leave a stray .tmp of step 6."""
    out = {}
    for s in range(1, 6):
        mgr.save(s, make(s), {"cursor": s})
    mgr.wait()
    out["saved"] = mgr.list_steps()
    npz = os.path.join(root, "step_0000000005", "state.npz")
    with open(npz, "rb") as f:
        head = f.read(30)
    with open(npz, "wb") as f:
        f.write(head)
    os.remove(os.path.join(root, "step_0000000004", "state.npz"))
    os.makedirs(os.path.join(root, "step_0000000006.tmp"))
    out["listed"] = mgr.list_steps()
    out["latest"] = mgr.latest_step()
    _, meta = mgr.restore(make(0))
    out["restored"] = (meta["step"], meta["cursor"])
    try:
        mgr.restore(make(0), step=5)
    except Exception as e:  # noqa: BLE001 -- the exception's class is compared
        out["explicit"] = type(e).__name__
    return out


def test_save_corrupt_restore_script_matches_the_reference_manager(tmp_path):
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _script(JCheckpointManager(jroot, keep=3), jroot,
                   lambda s: {"w": jnp.full((8,), float(s)), "n": s})
    got = _script(CheckpointManager(troot, keep=3), troot,
                  lambda s: {"w": torch.full((8,), float(s)), "n": s})
    assert got == want
    assert want["listed"] == [3, 5] and want["restored"] == (3, 3)


def test_the_checkpoint_is_numpys_npz_both_ways(tmp_path):
    """``state.npz`` is the file ``np.savez`` writes and ``np.load`` reads
    (the reference manager's format): 0-d, empty, bool and strided leaves
    included; and the port restores a file ``np.savez`` wrote."""
    state = {"scalar": torch.tensor(3.5), "empty": torch.zeros(0, 3, dtype=torch.int8),
             "mask": torch.tensor([True, False, True]),
             "strided": torch.arange(12.0).reshape(3, 4).t(), "step": 4}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    with np.load(tmp_path / "step_0000000001" / "state.npz") as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(state) and got["step"] == 4 and got["scalar"].shape == ()
    for k in ("scalar", "empty", "mask", "strided"):
        assert got[k].dtype == state[k].numpy().dtype
        np.testing.assert_array_equal(got[k], state[k].numpy())
    np.savez(tmp_path / "step_0000000001" / "state.npz",
             **{k: (v + 1 if k == "strided" else v) for k, v in got.items()})
    template = {"scalar": torch.zeros(()), "empty": torch.zeros(0, 3, dtype=torch.int8),
                "mask": torch.zeros(3, dtype=torch.bool), "strided": torch.zeros(4, 3),
                "step": 0}
    back, _ = mgr.restore(template)
    assert float(back["scalar"]) == 3.5 and back["step"] == 4
    assert back["mask"].tolist() == [True, False, True]
    assert torch.equal(back["strided"], state["strided"] + 1)


def test_adamw_moments_and_step_round_trip_on_the_lm_trainer(tmp_path):
    """The LM trainer's carry (the train CLI's run, reduced): AdamW's first
    and second moments and its step, which drives the LR schedule, come back
    from the checkpoint, and the continued run equals the uninterrupted one
    bit for bit."""
    from repro_torch.launch import train as train_cli
    from repro_torch.scenario import TokenClassIncremental

    run = train_cli.build_run(train_cli.parse_args(
        ["--reduced", "--tasks", "2", "--steps-per-task", "4", "--seq-len", "16",
         "--global-batch", "2"]))
    tr = ContinualTrainer(run, TokenClassIncremental(run.scenario), device="cpu")
    ref, ref_metrics = _advance(tr, tr._init(tr.seed), 0, 6)
    half, _ = _advance(tr, tr._init(tr.seed), 0, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, half, {"cursor": 3})
    saved, _ = snapshot(half)
    assert any(k.startswith("opt/nu/") for k in saved) and int(saved["opt/step"]) == 3
    restored, _ = mgr.restore(tr._init(tr.seed))
    assert restored.opt.step == 3
    for k, v in half.opt.nu.items():
        assert torch.equal(restored.opt.nu[k], v) and torch.equal(restored.opt.mu[k],
                                                                   half.opt.mu[k])
    resumed, metrics = _advance(tr, restored, 3, 6)
    assert metrics == ref_metrics[3:]
    _same_arrays(snapshot(resumed)[0], snapshot(ref)[0])
