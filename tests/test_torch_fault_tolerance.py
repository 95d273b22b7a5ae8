"""The port's resilient runtime on the CPU: ``ResilientLoop`` and
``StragglerPolicy`` against the reference's on the same toy step and
failure schedule, ``make_stale_step`` against the reference's through the
``rows`` seam, and the trainer's chaos parity: a failure injected mid-task
replays to the clean run bit for bit (flat, tiered and der_pp, at the sizes
of the reference's ``tests/test_fault_tolerance.py``), and the chaotic
run's fingerprints equal the JAX trainer's with its rows fed through the
seam.

Tolerances: histories, restarts, backoff sleeps, decisions, fingerprints and
everything within the port exactly; losses and parameters against JAX at
rtol 1e-4 of the largest value (f32 convolutions in another order), as the
step parity tests hold them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.buffer import resolve_policy as jresolve_policy
from repro.buffer import state as jstate
from repro.buffer import tiered as jtiered
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import resnet50_cl as jcfgs
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import ResilienceConfig as JResilience
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ScenarioConfig as JScenario
from repro.configs.base import StrategyConfig as JStrategy
from repro.configs.base import TrainConfig as JTrain
from repro.runtime import InjectedFailure as JInjectedFailure
from repro.runtime import ResilientLoop as JResilientLoop
from repro.runtime import StragglerPolicy as JStragglerPolicy
from repro.scenario import ContinualTrainer as JTrainer
from repro.strategy import init_carry as jinit_carry
from repro.strategy import make_cl_step as jmake_cl_step
from repro.strategy import make_stale_step as jmake_stale_step
from repro_torch.buffer import TieredRows, UpdateSampleRows
from repro_torch.buffer.state import ItemSpec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import resnet50_cl as tcfgs
from repro_torch.configs.base import (RehearsalConfig, ResilienceConfig, RunConfig,
                                      ScenarioConfig, StrategyConfig, TrainConfig)
from repro_torch.convert import cnn_params_from_jax
from repro_torch.rng import fold_in
from repro_torch.runtime import (TRANSIENT_EXCEPTIONS, InjectedFailure, ResilientLoop,
                                 StragglerPolicy)
from repro_torch.scenario import ContinualTrainer
from repro_torch.strategy import init_carry, make_cl_step, make_stale_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: intra-op threads gain nothing while several test
    processes share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + 1e-7


# ---------------------------------------------------------------------------
# ResilientLoop and StragglerPolicy against the reference's
# ---------------------------------------------------------------------------

# (steps, loop settings, the steps that fail and how often, straggler)
LOOP_CASES = {
    "late_in_window": (12, dict(checkpoint_every=5), {8: 1}, None),
    "before_first_periodic": (6, dict(checkpoint_every=50), {3: 1}, None),
    "transient_oserror": (5, dict(checkpoint_every=50), {2: 1}, None),
    "backoff": (3, dict(checkpoint_every=5, max_restarts=4, backoff_base=1.0,
                        backoff_max=3.0), {1: 3}, None),
    "stats": (6, dict(checkpoint_every=2), {3: 1}, None),
    "straggle_bursts": (9, dict(checkpoint_every=50), {}, (1.0, 2, 0)),
    "straggle_and_fail": (14, dict(checkpoint_every=4), {6: 1, 11: 2}, (0.5, 2, 3)),
}


def _loop_run(pkg, case, tmp_path):
    """Run the case's toy loop in ``pkg`` ("jax" or "torch"): returns the
    history, the restarts, the backoff sleeps, the stats and the final w."""
    steps, kw, fails, straggle = LOOP_CASES[case]
    fails, sleeps = dict(fails), []
    exc = OSError if case == "transient_oserror" else (
        JInjectedFailure if pkg == "jax" else InjectedFailure)

    def chaos(step):
        if fails.get(step, 0):
            fails[step] -= 1
            raise exc(f"failure at {step}")

    def step_fn(carry, batch, key):
        return {"w": carry["w"] + batch}, {"s": float(batch[0]), "stale_step": 0.0}

    def stale_fn(carry, batch, key):
        return {"w": carry["w"] - batch}, {"s": float(batch[0]), "stale_step": 1.0}

    if pkg == "jax":
        loop_cls, mgr_cls, pol_cls = JResilientLoop, JCheckpointManager, JStragglerPolicy
        carry, key, batch_fn = {"w": jnp.zeros(2)}, jax.random.PRNGKey(0), \
            lambda s: jnp.full((2,), float(s))
    else:
        loop_cls, mgr_cls, pol_cls = ResilientLoop, CheckpointManager, StragglerPolicy
        carry, key, batch_fn = {"w": torch.zeros(2)}, 0, lambda s: torch.full((2,), float(s))
    extra = {}
    if straggle is not None:
        extra = dict(straggler=pol_cls(*straggle[:2], seed=straggle[2]), stale_step_fn=stale_fn)
    loop = loop_cls(step_fn=step_fn, ckpt=mgr_cls(str(tmp_path / pkg), async_save=False),
                    sleep_fn=sleeps.append, **kw, **extra)
    carry, hist, restarts = loop.run(carry, batch_fn, key, steps, failure_hook=chaos)
    stats = {k: loop.stats[k] for k in ("restarts", "stale_steps")}
    return hist, restarts, sleeps, stats, np.asarray(carry["w"]).tolist()


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_resilient_loop_matches_the_reference_loop(case, tmp_path):
    want = _loop_run("jax", case, tmp_path)
    got = _loop_run("torch", case, tmp_path)
    assert got == want
    hist, restarts, sleeps, stats, _ = got
    steps, _, fails, straggle = LOOP_CASES[case]
    assert [h["s"] for h in hist] == [float(s) for s in range(steps)]  # no duplicates
    assert restarts == sum(fails.values())
    if case == "backoff":
        assert sleeps == [1.0, 2.0, 3.0]  # 1, 2, then 4 capped at backoff_max
    if case == "straggle_bursts":
        assert [h["stale_step"] for h in hist] == [1.0, 1.0, 0.0] * 3
        assert stats["stale_steps"] == 6


def test_loop_stats_account_restores(tmp_path):
    loop = ResilientLoop(step_fn=lambda c, b, k: ({"w": c["w"] + b}, {"s": 0.0}),
                         ckpt=CheckpointManager(str(tmp_path)), checkpoint_every=2)
    fired = []

    def chaos(step):
        if step == 3 and not fired:
            fired.append(step)
            raise InjectedFailure("x")

    loop.run({"w": torch.zeros(2)}, lambda s: torch.ones(2), 0, 6, failure_hook=chaos)
    assert loop.stats["restarts"] == 1 and loop.stats["stale_steps"] == 0
    assert loop.stats["restore_seconds"] > 0.0


@pytest.mark.parametrize("exc,retry_on,raised", [
    (ValueError, None, ValueError),  # deterministic: never retried
    (OSError, (InjectedFailure,), OSError),  # a narrowed allowlist
    (RuntimeError, None, RuntimeError),  # e.g. a kernel that fails to build or launch
])
def test_exceptions_off_the_allowlist_propagate_at_once(exc, retry_on, raised, tmp_path):
    calls = []

    def step_fn(carry, batch, key):
        calls.append(1)
        if len(calls) == 3:
            raise exc("not transient")
        return carry, {"s": 0.0}

    loop = ResilientLoop(step_fn=step_fn, ckpt=CheckpointManager(str(tmp_path)),
                         checkpoint_every=5, retry_on=retry_on)
    with pytest.raises(raised, match="not transient"):
        loop.run({"w": torch.zeros(2)}, lambda s: None, 0, 5)
    assert len(calls) == 3


def test_the_allowlist_holds_the_reference_classes_and_the_distributed_errors():
    for cls in (InjectedFailure, OSError, ConnectionError, TimeoutError,
                torch.distributed.DistError, torch.distributed.DistNetworkError,
                torch.distributed.DistBackendError, torch.distributed.DistStoreError):
        assert issubclass(cls, TRANSIENT_EXCEPTIONS), cls
    assert not issubclass(RuntimeError, TRANSIENT_EXCEPTIONS)


def test_max_restarts_exceeded_raises(tmp_path):
    loop = ResilientLoop(step_fn=lambda c, b, k: (c, {}), max_restarts=2,
                         ckpt=CheckpointManager(str(tmp_path)), checkpoint_every=5)

    def chaos(step):
        raise InjectedFailure("permanent failure")

    with pytest.raises(RuntimeError, match="exceeded max_restarts=2"):
        loop.run({"w": torch.zeros(2)}, lambda s: None, 0, 5, failure_hook=chaos)


@pytest.mark.parametrize("delay,bound,seed,slow_every", [
    (0.0, 1, 0, 2), (0.3, 2, 7, 5), (0.5, 4, 11, 9), (0.9, 3, 2024, 3), (1.0, 6, 5, 7)])
def test_straggler_decisions_match_the_reference_and_stay_bounded(delay, bound, seed,
                                                                  slow_every):
    """The same decisions as the reference's policy over 300 steps of
    simulated delays and real overruns (``record_slow``), and consecutive
    reuses never past ``max_staleness``."""
    pols = [StragglerPolicy(delay, bound, seed), JStragglerPolicy(delay, bound, seed)]
    decisions = [[], []]
    for i in range(300):
        for pol, out in zip(pols, decisions):
            if i % slow_every == 0:
                pol.record_slow()
            out.append(pol.use_fresh())
    assert decisions[0] == decisions[1]
    assert pols[0].reuses == pols[1].reuses
    run = 0
    for fresh in decisions[0]:
        run = 0 if fresh else run + 1
        assert run <= bound


def test_record_slow_forces_reuse_next_step():
    pol = StragglerPolicy(delay_prob=0.0, max_staleness=2, seed=0)
    assert pol.use_fresh()
    pol.record_slow()
    assert not pol.use_fresh()
    assert pol.use_fresh()


def test_a_step_over_its_timeout_makes_the_next_step_stale(tmp_path):
    import time

    calls = []

    def step_fn(carry, batch, key):
        calls.append("fresh")
        if batch == 1:
            time.sleep(0.05)  # over the budget
        return carry, {}

    def stale_fn(carry, batch, key):
        calls.append("stale")
        return carry, {}

    loop = ResilientLoop(step_fn=step_fn, stale_step_fn=stale_fn,
                         ckpt=CheckpointManager(str(tmp_path)), checkpoint_every=50,
                         step_timeout=0.02, straggler=StragglerPolicy(0.0, 2, 0))
    loop.run({"w": torch.zeros(1)}, lambda s: s, 0, 4)
    assert calls == ["fresh", "fresh", "stale", "fresh"]
    assert loop.stats["stale_steps"] == 1


# ---------------------------------------------------------------------------
# make_stale_step against the reference's
# ---------------------------------------------------------------------------

STALE_RCFG = dict(num_buckets=2, slots_per_bucket=4, num_representatives=2, num_candidates=4,
                  mode="async", label_field="label")


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.as_tensor(np.array(w)))


def _jloss(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["label"].astype(jnp.float32)) ** 2), {}


def _tloss(model, batch):
    pred = batch["x"] @ model.w
    return torch.mean((pred - batch["label"].float()) ** 2), {}


def _jsgd(grads, opt, params):
    return jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, grads), opt, {}


def _tsgd(grads, opt, params):
    with torch.no_grad():
        for k, p in params.items():
            p.sub_(0.1 * grads[k])
    return params, opt, {}


def _stale_batch(s):
    r = np.random.default_rng(s)
    return {"x": r.normal(size=(4, 3)).astype(np.float32),
            "label": r.integers(0, 4, 4).astype(np.int32),
            "task": (np.arange(4) % 2).astype(np.int32)}


def _flat_rows(jc, jbatch, jrcfg, policy=None):
    """The rows of the reference's flat issue half (``jc`` holds its pipe and
    buffer), as a port ``UpdateSampleRows`` (the aux is set by the caller)."""
    k_up, k_samp = jax.random.split(jax.random.fold_in(jc.pipe.key, 0))
    flat, _, _, _, counts, seen = jstate.local_update_rows(
        jc.buffer, jbatch["task"], k_up, jrcfg.num_candidates, policy)
    samp, valid = jstate.local_sample_rows(jc.buffer._replace(counts=counts), k_samp,
                                           jrcfg.num_representatives, policy)
    return UpdateSampleRows(*(torch.from_numpy(np.array(a))
                              for a in (flat, counts, seen, samp, valid)))


def test_make_stale_step_leaves_buffer_and_pipe_untouched_and_matches_jax():
    """Three pipelined steps in both packages (the reference's rows fed
    through the seam), then a stale step: the same loss, fingerprints and
    parameters as the reference's stale step; the buffer, the pending slot
    and its key come back untouched, and ``stale_step`` is 1."""
    jrcfg, trcfg = JRehearsal(**STALE_RCFG), RehearsalConfig(**STALE_RCFG)
    spec = {"x": jax.ShapeDtypeStruct((3,), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}
    tspec = {"x": ItemSpec((3,), torch.float32), "label": ItemSpec((), torch.int32),
             "task": ItemSpec((), torch.int32)}
    jc = jinit_carry({"w": jnp.ones((3,), jnp.float32)}, {}, spec, jrcfg,
                     label_field="label", seed=3)
    tc = init_carry(_Linear(np.ones(3, np.float32)), {}, tspec, trcfg, label_field="label",
                    seed=3, device="cpu")
    jstep = jmake_cl_step(_jloss, _jsgd, jrcfg, exchange="local", label_field="label",
                          donate=False)
    tstep = make_cl_step(_tloss, _tsgd, trcfg, exchange="local", label_field="label",
                         device="cpu")
    for s in range(3):
        batch = _stale_batch(s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rows = _flat_rows(jc, jbatch, jrcfg)
        jc, _ = jstep(jc, jbatch, jax.random.fold_in(jax.random.PRNGKey(0), s))
        tc, _ = tstep(tc, batch, s, rows=rows)
    assert float(tc.buffer.counts.sum()) > 0 and bool(tc.pipe.valid.any())
    jstale = jmake_stale_step(_jloss, _jsgd, jrcfg, label_field="label")
    tstale = make_stale_step(_tloss, _tsgd, trcfg, label_field="label", device="cpu")
    batch = _stale_batch(3)
    before = {k: v.clone() for k, v in tc.buffer.data.items()}
    counts, reps = tc.buffer.counts.clone(), {k: v.clone() for k, v in tc.pipe.reps.items()}
    jout, jm = jstale(jc, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(9))
    w_before = tc.params.w.detach().clone()
    tout, tm = tstale(tc, batch, 9)
    assert float(tm["stale_step"]) == 1.0 == float(jm["stale_step"])
    _close(float(tm["loss"]), float(jm["loss"]))
    assert float(tm["rep_checksum"]) == float(jm["rep_checksum"]) > 0
    assert float(tm["buffer_fill"]) == float(jm["buffer_fill"])
    _close(tout.params.w.detach().numpy(), np.asarray(jout.params["w"]))
    assert not torch.equal(tout.params.w, w_before)
    assert tout.buffer is tc.buffer and tout.pipe is tc.pipe and tout.pipe.key == tc.pipe.key
    for k, v in before.items():
        assert torch.equal(tout.buffer.data[k], v)
    assert torch.equal(tout.buffer.counts, counts)
    for k, v in reps.items():
        assert torch.equal(tout.pipe.reps[k], v)


# ---------------------------------------------------------------------------
# The trainer: chaos parity (the acceptance pin)
# ---------------------------------------------------------------------------

CHAOS_KINDS = ("flat", "tiered", "der_pp")
FAIL_AT = 11  # mid task 1 (absolute step 11 of 16), off a checkpoint boundary


def _chaos_fields(kind):
    rcfg = dict(num_buckets=4, slots_per_bucket=6, num_representatives=3, num_candidates=6,
                mode="async", label_field="label")
    if kind == "flat":
        rcfg.update(policy="fifo")
    elif kind == "tiered":
        rcfg.update(policy="fifo", tiering="host", hot_slots=3, cold_slots=9)
    return dict(
        train=dict(optimizer="sgd", peak_lr=0.05, warmup_steps=5, linear_scaling=False),
        rehearsal=rcfg, strategy=dict(alpha=0.3, beta=0.3),
        scenario=dict(strategy="der_pp" if kind == "der_pp" else "rehearsal", num_tasks=2,
                      epochs_per_task=1, steps_per_epoch=8, batch_size=8, image_size=8,
                      classes_per_task=4, auto_defaults=False))


def _vision_run(kind, model=None) -> RunConfig:
    f = _chaos_fields(kind)
    return RunConfig(model=model, train=TrainConfig(**f["train"]),
                     rehearsal=RehearsalConfig(**f["rehearsal"]),
                     strategy=StrategyConfig(**f["strategy"]),
                     scenario=ScenarioConfig(**f["scenario"]))


def _chaos(fired):
    def hook(step):
        if step == FAIL_AT and not fired:
            fired.append(step)
            raise InjectedFailure("simulated preemption")

    return hook


RES = ResilienceConfig(checkpoint_every=3, max_restarts=2)


@pytest.mark.parametrize("kind", CHAOS_KINDS)
def test_chaos_parity_bitexact(kind, tmp_path):
    """A failure injected at a mid-task step: the history (loss,
    ``rep_checksum``, ``buffer_fill``), the losses, the accuracy matrix and
    the final model equal the uninterrupted run's bit for bit, and the
    uninterrupted resilient fit equals the plain fit."""
    plain_tr = ContinualTrainer(_vision_run(kind), device="cpu")
    plain = plain_tr.fit()
    clean_tr = ContinualTrainer(_vision_run(kind), device="cpu", ckpt_dir=str(tmp_path / "c"),
                                resilience=RES)
    clean = clean_tr.fit()
    fired = []
    chaotic_tr = ContinualTrainer(_vision_run(kind), device="cpu",
                                  ckpt_dir=str(tmp_path / "x"), resilience=RES,
                                  overrides={"failure_hook": _chaos(fired)})
    chaotic = chaotic_tr.fit()
    assert fired == [FAIL_AT]
    assert clean.restarts == 0 and chaotic.restarts == 1
    assert clean.history == chaotic.history == plain.history
    assert clean.losses == chaotic.losses == plain.losses and len(chaotic.losses) == 16
    np.testing.assert_array_equal(clean.accuracy_matrix, chaotic.accuracy_matrix)
    np.testing.assert_array_equal(plain.accuracy_matrix, chaotic.accuracy_matrix)
    assert any(h.get("buffer_fill") for h in chaotic.history)  # the buffer filled
    assert chaotic.resilience_stats["restore_seconds"] > 0.0
    assert len(chaotic.step_seconds) == len(chaotic.prefetch_wait_seconds) == 16
    # the per-task checkpoints hold the full carry
    assert CheckpointManager(str(tmp_path / "x")).list_steps() == [0, 1]


def test_a_step_that_raises_halfway_through_its_writes_replays_to_the_clean_run(
        monkeypatch, tmp_path):
    """The port's step writes the buffer (the issue half runs before the
    backward) and then the parameters in place. A step that raises after
    the optimizer wrote half of them leaves both half-written; the restore
    copies the checkpoint back into every tensor, and the replay ends on the
    clean run's result bit for bit."""
    import repro_torch.optim

    clean = ContinualTrainer(_vision_run("flat"), device="cpu", ckpt_dir=str(tmp_path / "c"),
                             resilience=RES).fit()
    real = repro_torch.optim.make_optimizer
    calls = []

    def make_optimizer(cfg, *args, **kwargs):
        init, update = real(cfg, *args, **kwargs)

        def failing_update(grads, state, params):
            calls.append(len(calls))
            if len(calls) == FAIL_AT + 1:  # step 11's update
                half = dict(list(params.items())[:len(params) // 2])
                update(grads, state, half)  # writes these tensors in place
                raise InjectedFailure("down halfway through the update")
            return update(grads, state, params)

        return init, failing_update

    monkeypatch.setattr(repro_torch.optim, "make_optimizer", make_optimizer)
    chaotic = ContinualTrainer(_vision_run("flat"), device="cpu",
                               ckpt_dir=str(tmp_path / "x"), resilience=RES).fit()
    assert chaotic.restarts == 1 and len(calls) == 16 + 1 + (FAIL_AT - 9)
    assert chaotic.history == clean.history and chaotic.losses == clean.losses
    np.testing.assert_array_equal(chaotic.accuracy_matrix, clean.accuracy_matrix)


def _jax_tiered_rows(js, labels, key_up, key_samp, c, n, policy):
    """The rows of the reference's ``tiered_update(key_up)`` then
    ``tiered_sample(key_samp, n)`` under the hot tier's ``policy``."""
    k_hot, k_flush = jax.random.split(key_up)
    stage_n = js.stage_labels.shape[0]
    c_flat, _, _, _, c_counts, c_seen = jstate.local_update_rows(
        js.cold, js.stage_labels, k_flush, stage_n, accept_mask=js.stage_valid)
    h_flat, accept, pos, slot, h_counts, h_seen = jstate.local_update_rows(
        js.hot, labels, k_hot, c, policy)
    cap = jstate.buffer_dims(js.hot)[1]
    evicted_valid = accept & (pos >= cap) & (slot < js.hot.counts[labels])
    src, stage_labels, stage_valid = jtiered._pack_stage(
        {"row": h_flat}, labels, evicted_valid, stage_n)
    k_h, k_c, k_m = jax.random.split(key_samp, 3)
    h_samp, h_valid = jstate.local_sample_rows(js.hot._replace(counts=h_counts), k_h, n,
                                               policy)
    c_samp, c_valid = jstate.local_sample_rows(js.cold._replace(counts=c_counts), k_c, n)
    hot_total, cold_total = jnp.sum(h_counts), jnp.sum(c_counts)
    p_hot = hot_total.astype(jnp.float32) / jnp.maximum(
        hot_total + cold_total, 1).astype(jnp.float32)
    use_hot = jax.random.uniform(k_m, (n,)) < p_hot
    use_hot = jnp.where(cold_total == 0, True, jnp.where(hot_total == 0, False, use_hot))

    def t(a):
        return torch.from_numpy(np.array(a))

    return TieredRows(
        UpdateSampleRows(*map(t, (c_flat, c_counts, c_seen, c_samp, c_valid))),
        UpdateSampleRows(*map(t, (h_flat, h_counts, h_seen, h_samp, h_valid))),
        t(src["row"]), t(stage_labels), t(stage_valid), t(use_hot))


def _aux(aux):
    return {k: torch.from_numpy(np.array(v)) for k, v in aux.items()} if aux else None


def _fresh(rows):
    """A copy of recorded rows: the step keeps the row tensors it is given
    as the new state's counts and aux, which a restore then writes in
    place, so a replay must not reuse the recorded tensors."""
    if isinstance(rows, torch.Tensor):
        return rows.clone()
    if isinstance(rows, dict):
        return {k: _fresh(v) for k, v in rows.items()}
    if isinstance(rows, tuple):
        return type(rows)(*map(_fresh, rows))
    return rows


@pytest.mark.parametrize("kind", CHAOS_KINDS)
def test_chaotic_run_matches_the_jax_trainer_through_the_rows_seam(kind, tmp_path):
    """The JAX trainer's clean resilient run records, for every step, the
    rows its issue half draws (and the policy aux they leave); the port's
    trainer starts from the same weights, runs with a failure injected at
    step 11 and takes those rows through the ``rows`` seam (the replayed
    steps too). Its ``rep_checksum`` / ``buffer_fill`` history equals the
    JAX trainer's, and its losses are within rtol 1e-4."""
    f = _chaos_fields(kind)
    jrun = JRun(model=jcfgs.reduced(num_classes=8), train=JTrain(**f["train"]),
                rehearsal=JRehearsal(**f["rehearsal"]), strategy=JStrategy(**f["strategy"]),
                scenario=JScenario(**f["scenario"]))
    jtr = JTrainer(jrun, ckpt_dir=str(tmp_path / "j"),
                   resilience=JResilience(checkpoint_every=3, max_restarts=2))
    jkey = jax.random.PRNGKey(jtr.seed)
    step_of = {tuple(np.asarray(jax.random.fold_in(jkey, s)).tolist()): s for s in range(16)}
    jrcfg, jpol = jtr.rcfg, jresolve_policy(jtr.rcfg.policy)
    rows_at, jstep = {}, jtr._step_fn

    def recording(carry, batch, key):
        s = step_of[tuple(np.asarray(key).tolist())]
        if kind == "tiered":
            key_up, key_samp = jax.random.split(jax.random.fold_in(carry.pipe.key, 0))
            rows = _jax_tiered_rows(carry.buffer, batch["task"], key_up, key_samp,
                                    jrcfg.num_candidates, jrcfg.num_representatives, jpol)
        else:
            rows = _flat_rows(carry, batch, jrcfg, jpol)
        # the key was only read to find its step above: the step is its one consumer
        carry, m = jstep(carry, batch, key)  # replint: disable=RPL001
        if kind == "tiered":
            rows = rows._replace(hot=rows.hot._replace(new_aux=_aux(carry.buffer.hot.aux)))
        else:
            rows = rows._replace(new_aux=_aux(carry.buffer.aux))
        rows_at[s] = rows
        return carry, m

    jtr._step_fn = recording
    want = jtr.fit()

    tr = ContinualTrainer(_vision_run(kind, model=tcfgs.reduced(num_classes=8)), device="cpu",
                          ckpt_dir=str(tmp_path / "t"), resilience=RES,
                          overrides={"failure_hook": _chaos([])})

    def jax_init(seed):
        jparams = jtr.init_params_fn(jax.random.PRNGKey(seed))
        return cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tr.run.model,
                                   device="cpu")

    tr.init_params_fn = jax_init
    tstep, tkey = tr._step_fn, {fold_in(tr.seed, s): s for s in range(16)}
    tr._step_fn = lambda carry, batch, key: tstep(carry, batch, key,
                                                  rows=_fresh(rows_at[tkey[key]]))
    got = tr.fit()
    assert got.restarts == 1
    assert [(h["task"], h["step"], h["rep_checksum"], h["buffer_fill"]) for h in got.history] \
        == [(h["task"], h["step"], h["rep_checksum"], h["buffer_fill"]) for h in want.history]
    assert any(h["rep_checksum"] for h in got.history)
    _close([h["loss"] for h in got.history], [h["loss"] for h in want.history])


def test_trainer_straggler_path_keeps_training(tmp_path):
    """delay_prob 1 and max_staleness 2: two thirds of the steps reuse the
    pending representatives; training completes, the stale steps are
    counted, and each one's ``buffer_fill`` is the step before's."""
    res = ResilienceConfig(checkpoint_every=5, straggler_delay_prob=1.0, max_staleness=2)
    out = ContinualTrainer(_vision_run("flat"), device="cpu", ckpt_dir=str(tmp_path),
                           resilience=res).fit()
    assert out.resilience_stats["stale_steps"] == pytest.approx(2 * 16 / 3, abs=1)
    assert np.isfinite(out.final_accuracy) and np.isfinite(out.losses).all()


def test_resilience_requires_ckpt_dir_and_the_fused_form(tmp_path):
    with pytest.raises(ValueError, match="ckpt_dir"):
        ContinualTrainer(_vision_run("flat"), device="cpu", resilience=ResilienceConfig())
    with pytest.raises(ValueError, match="ckpt_dir"):  # the config-file spelling
        ContinualTrainer(_vision_run("flat").replace(resilience=ResilienceConfig()),
                         device="cpu")
    with pytest.raises(ValueError, match="step_form='fused'"):
        ContinualTrainer(_vision_run("flat"), device="cpu", ckpt_dir=str(tmp_path),
                         resilience=ResilienceConfig(), step_form="split")
    with pytest.raises(TypeError, match="unknown trainer overrides"):
        ContinualTrainer(_vision_run("flat"), device="cpu", overrides={"step_fn": None})


def test_only_the_plain_pipelined_rehearsal_step_gets_a_stale_step(tmp_path):
    res = dict(ckpt_dir=str(tmp_path), resilience=ResilienceConfig(), device="cpu")
    assert ContinualTrainer(_vision_run("flat"), **res)._stale_step_fn is not None
    assert ContinualTrainer(_vision_run("der_pp"), **res)._stale_step_fn is None
    sync = _vision_run("flat")
    sync = sync.replace(rehearsal=dataclasses.replace(sync.rehearsal, mode="sync"))
    assert ContinualTrainer(sync, **res)._stale_step_fn is None
    assert ContinualTrainer(_vision_run("flat"), device="cpu")._stale_step_fn is None


def test_resilience_config_matches_the_reference():
    assert dataclasses.asdict(ResilienceConfig()) == dataclasses.asdict(JResilience())
    for bad in (dict(checkpoint_every=0), dict(max_restarts=-1)):
        with pytest.raises(ValueError):
            ResilienceConfig(**bad)
