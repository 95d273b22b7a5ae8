"""Online serving of the port (``OnlineLearner``, ``serve --online``) against
the JAX package's, on the CPU.

The runs are the reference's ``_run`` (``tests/test_serving.py``): the
reduced 2-layer SmolLM over a vocab of 64, seq 16, prompt 12 (so gen 5),
batch 4, AdamW at 3e-3. Both learners start from the reference's initial
weights (``lm_params_from_jax``). Greedy decode draws nothing, and neither
does a learner whose rehearsal is off, so with ``mode="off"`` both runs are
deterministic and are held round by round: the admitted records and served
tokens exactly, the losses within 1e-5 (as the LM trainer's step-by-step
test holds them). With the reservoir the two draw from different
generators, so that run is held to the reference's own assertions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import OnlineConfig as JOnline
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ScenarioConfig as JScenario
from repro.configs.base import TrainConfig as JTrain
from repro.serving import OnlineLearner as JOnlineLearner
from repro_torch.configs.base import (OnlineConfig, RehearsalConfig, RunConfig, ScenarioConfig,
                                      TrainConfig)
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.runtime import InjectedFailure
from repro_torch.serving import DecodeEngine, OnlineLearner

PROMPT = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU runs gain nothing from intra-op threads, and the
    suite runs several test processes on the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(enabled=True, rounds=4, train_every=1, mode="async", seed=0):
    return dict(
        train=dict(optimizer="adamw", peak_lr=3e-3, warmup_steps=2, linear_scaling=False,
                   compute_dtype="float32"),
        scenario=dict(name="drift_stream", modality="tokens", num_tasks=3, epochs_per_task=1,
                      steps_per_epoch=4, batch_size=4, seed=seed, vocab_size=64, seq_len=16),
        online=dict(enabled=enabled, rounds=rounds, requests_per_round=4, prompt_len=PROMPT,
                    train_every=train_every),
        rehearsal=dict(mode=mode))


def _runs(**kw):
    """The reference's ``_run`` in both packages."""
    f = _fields(**kw)
    jrun = JRun(train=JTrain(**f["train"]), scenario=JScenario(**f["scenario"]),
                online=JOnline(**f["online"]), rehearsal=JRehearsal(**f["rehearsal"]))
    run = RunConfig(train=TrainConfig(**f["train"]), scenario=ScenarioConfig(**f["scenario"]),
                    online=OnlineConfig(**f["online"]),
                    rehearsal=RehearsalConfig(**f["rehearsal"]))
    return jrun, run


def _learners(**kw):
    """Both learners, the port's starting from the reference's initial
    weights (its ``init_params_fn`` replaced, as the LM trainer tests do)."""
    jrun, run = _runs(**kw)
    jlrn = JOnlineLearner(jrun)
    lrn = OnlineLearner(run, device="cpu")
    cfg = lrn.engine.model.cfg

    def jax_init(seed):
        jparams = jlrn.trainer.init_params_fn(jax.random.PRNGKey(seed))
        return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                  device="cpu")

    lrn.trainer.init_params_fn = jax_init
    return jlrn, lrn


def _same_params(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


def _recording(learner):
    """Wrap ``learner._admit_records`` to keep each round's served tokens and
    admitted records as numpy arrays."""
    seen = []
    admit = learner._admit_records

    def wrapped(req, gen):
        rec = admit(req, gen)
        seen.append((np.asarray(gen.tokens),
                     {k: np.asarray(v) for k, v in rec.items()}))
        return rec

    learner._admit_records = wrapped
    return seen


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [dict(rounds=0), dict(prompt_len=0), dict(gen_len=-1),
                                    dict(train_every=-1)])
def test_online_config_rejects_what_the_reference_rejects(kwargs):
    with pytest.raises(ValueError):
        JOnline(**kwargs)
    with pytest.raises(ValueError):
        OnlineConfig(**kwargs)


def test_online_config_derives_the_reference_gen_len_and_checks_the_layout():
    assert OnlineConfig() == OnlineConfig(**dataclasses.asdict(JOnline()))
    assert OnlineConfig(prompt_len=12).resolved_gen_len(16) == JOnline(
        prompt_len=12).resolved_gen_len(16) == 5
    assert OnlineConfig(prompt_len=12, gen_len=3).resolved_gen_len(16) == 3
    with pytest.raises(ValueError, match="no room"):
        OnlineConfig(prompt_len=20).resolved_gen_len(16)
    # a record-layout mismatch is rejected at construction, not mid-round
    _, run = _runs()
    with pytest.raises(ValueError, match="seq_len"):
        OnlineLearner(run.replace(online=OnlineConfig(enabled=True, prompt_len=12, gen_len=3)),
                      device="cpu")
    # store_decode=False lifts it
    lrn = OnlineLearner(run.replace(online=OnlineConfig(
        enabled=True, prompt_len=12, gen_len=3, store_decode=False)), device="cpu")
    assert lrn.gen_len == 3


def test_online_learner_needs_a_token_scenario():
    _, run = _runs()
    vision = run.replace(scenario=ScenarioConfig(image_size=8, num_tasks=2))
    with pytest.raises(ValueError, match="token scenario"):
        OnlineLearner(vision, device="cpu")


@pytest.mark.parametrize("kwargs,item", [(dict(registry=object()), "item 14")])
def test_unported_online_options_raise(kwargs, item):
    _, run = _runs()
    with pytest.raises(NotImplementedError, match=item):
        OnlineLearner(run, device="cpu", **kwargs)


def test_online_resilient_restart_then_disable(tmp_path):
    """The reference's case (``tests/test_serving.py``): with
    ``run.resilience`` a transient failure is absorbed by a restart and
    every round trains; a persistent one spends the budget, training stops
    after round 0, every round is still served, and serving ends on the
    last checkpoint's weights, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ResilienceConfig

    _, run = _runs(rounds=3)
    fired = []

    def transient(step):
        if step == 1 and not fired:
            fired.append(step)
            raise InjectedFailure("blip")

    lrn = OnlineLearner(run.replace(resilience=ResilienceConfig(checkpoint_every=1,
                                                                max_restarts=3)),
                        ckpt_dir=str(tmp_path / "a"), failure_hook=transient, device="cpu")
    res = lrn.run()
    assert res.restarts >= 1 and not res.train_disabled
    assert len(res.history) == 3 and res.admission_rate == 1.0
    assert _same_params(res.params, res.carry.params)

    def persistent(step):
        if step >= 1:
            raise InjectedFailure("dead")

    lrn2 = OnlineLearner(run.replace(resilience=ResilienceConfig(checkpoint_every=1,
                                                                 max_restarts=1)),
                         ckpt_dir=str(tmp_path / "b"), failure_hook=persistent, device="cpu")
    res2 = lrn2.run()
    assert len(res2.history) == 3 and res2.train_disabled  # serving survived
    assert [h["trained"] for h in res2.history] == [1.0, 0.0, 0.0]  # round 0 only
    assert np.isfinite([h["tokens_per_second"] for h in res2.history]).all()
    assert res2.history[-1]["freshness"] == 2.0  # staleness grows once dead
    mgr = CheckpointManager(str(tmp_path / "b" / "resilient"))
    last, meta = mgr.restore(lrn2.trainer._init(lrn2.trainer.seed))
    assert meta["cursor"] == 1  # after round 0's step
    assert _same_params(res2.params, last.params)
    assert _same_params(res2.carry.params, last.params)  # the train side restored too
    round0 = OnlineLearner(run.replace(online=dataclasses.replace(run.online, rounds=1)),
                           device="cpu").run()
    assert _same_params(res2.params, round0.params)


# ---------------------------------------------------------------------------
# Against the reference learner
# ---------------------------------------------------------------------------


def test_online_disabled_is_pure_serving_and_decodes_as_the_reference():
    jlrn, lrn = _learners(enabled=False, rounds=3)
    want = jlrn.run()
    got = lrn.run()
    assert got.admission_rate == want.admission_rate == 0.0
    assert len(got.history) == 3 and not got.train_disabled
    assert [h["trained"] for h in got.history] == [0.0] * 3
    # serving never touched the train side: the weights are the initial ones
    p0 = lrn.trainer.init_params_fn(0)
    assert _same_params(got.params, p0) and _same_params(got.carry.params, p0)
    # the last round's decode equals the reference learner's and the engine's
    np.testing.assert_array_equal(got.last_tokens.numpy(), np.asarray(want.last_tokens))
    req = lrn.scenario.batch(0, 4, 2)
    ref = DecodeEngine(lrn.engine.model, lrn.engine.ctx).generate(
        p0, torch.as_tensor(req["tokens"][:, :PROMPT]), lrn.gen_len)
    assert torch.equal(got.last_tokens, ref.tokens)


def test_online_without_replay_matches_the_reference_round_by_round():
    """``mode="off"``: nothing is drawn, so both learners are deterministic.
    Round 0's admitted records (prompt ++ greedy continuation, re-bucketed by
    content) and served tokens are equal bit for bit, and every round's loss
    is within 1e-5 of the reference's (f32, AdamW's warm-up; the largest
    difference read here is 7.2e-7), and the final per-anchor accuracies
    within one evaluated position (they were equal)."""
    jlrn, lrn = _learners(mode="off", rounds=4)
    jseen, seen = _recording(jlrn), _recording(lrn)
    want = jlrn.run()
    got = lrn.run()
    (jtok, jrec), (tok, rec) = jseen[0], seen[0]
    np.testing.assert_array_equal(tok, jtok)
    assert set(rec) == set(jrec) == {"tokens", "labels", "label"}
    for k in jrec:
        assert rec[k].dtype == jrec[k].dtype, k
        np.testing.assert_array_equal(rec[k], jrec[k], err_msg=k)
    for key in ("trained", "freshness", "admission_rate"):
        assert [h[key] for h in got.history] == [h[key] for h in want.history], key
    assert [h["trained"] for h in got.history] == [1.0] * 4
    np.testing.assert_allclose([h["loss"] for h in got.history],
                               [h["loss"] for h in want.history], rtol=0, atol=1e-5)
    assert got.admission_rate == want.admission_rate == 1.0
    assert got.freshness_rounds == want.freshness_rounds == 1.0
    positions = lrn.scenario.eval_set(0)["labels"].size
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=0, atol=1.0 / positions)
    # the handed-off copy is the train side's weights, bit for bit
    assert _same_params(got.params, got.carry.params)


def test_online_learner_learns_and_serves():
    """The reference's test on the port: the reservoir, 4 rounds of 2 steps."""
    _, run = _runs(rounds=4, train_every=2)
    lrn = OnlineLearner(run, device="cpu")
    res = lrn.run()
    assert len(res.history) == 4
    losses = [h["loss"] for h in res.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res.admission_rate == 1.0 and not res.train_disabled and res.restarts == 0
    # steady-state freshness is exactly 1: the one-step-stale handoff
    assert [h["freshness"] for h in res.history] == [1.0] * 4
    assert float(res.carry.buffer.counts.sum()) > 0  # traffic was admitted
    assert not _same_params(lrn.trainer.init_params_fn(0), res.params)
    assert _same_params(res.params, res.carry.params)
    assert tuple(res.last_tokens.shape) == (4, lrn.gen_len)
    assert len(res.accuracy) == 3 and all(0.0 <= a <= 1.0 for a in res.accuracy)


def test_online_freshness_evals_run_at_the_stream_phase():
    _, run = _runs(rounds=4)
    run = run.replace(online=dataclasses.replace(run.online, freshness_every=2))
    res = OnlineLearner(run, device="cpu").run()
    assert [(e["round"], e["phase"]) for e in res.freshness_evals] == [(1, 0), (3, 0)]
    assert all(0.0 <= e["accuracy"] <= 1.0 for e in res.freshness_evals)


# ---------------------------------------------------------------------------
# Failures on the train side never reach serving
# ---------------------------------------------------------------------------


def test_online_train_failure_never_kills_serving_unresilient():
    steps = []

    def hook(step):
        steps.append(step)
        raise InjectedFailure("always down")

    _, run = _runs(rounds=3)
    lrn = OnlineLearner(run, device="cpu", failure_hook=hook)
    res = lrn.run()
    assert len(res.history) == 3  # every round still served
    assert res.train_disabled and res.admission_rate == 0.0 and steps == [0]
    assert [h["freshness"] for h in res.history] == [1.0, 2.0, 3.0]
    assert _same_params(res.params, lrn.trainer.init_params_fn(0))


def test_a_failure_mid_optimizer_leaves_serving_on_the_last_handoff(monkeypatch):
    """The port's optimizer writes parameters in place. A step that fails
    after it has written half of them (round 1) leaves the train weights
    half-updated; serving must end on round 0's handed-off weights bit for
    bit, and decode from them."""
    import repro_torch.optim

    real = repro_torch.optim.make_optimizer
    calls = []

    def make_optimizer(cfg, *args, **kwargs):
        init, update = real(cfg, *args, **kwargs)

        def failing_update(grads, state, params):
            calls.append(len(calls))
            if len(calls) == 2:  # round 1's step
                half = dict(list(params.items())[:len(params) // 2])
                update(grads, state, half)  # writes these tensors in place
                raise InjectedFailure("down halfway through the update")
            return update(grads, state, params)

        return init, failing_update

    _, run = _runs(rounds=3)
    round0 = OnlineLearner(run.replace(online=dataclasses.replace(run.online, rounds=1)),
                           device="cpu").run()
    monkeypatch.setattr(repro_torch.optim, "make_optimizer", make_optimizer)
    lrn = OnlineLearner(run, device="cpu")
    res = lrn.run()
    assert calls == [0, 1] and res.train_disabled
    assert [h["trained"] for h in res.history] == [1.0, 0.0, 0.0]
    assert [h["freshness"] for h in res.history] == [1.0, 1.0, 2.0]
    # the train side holds a half-written model; serving does not
    assert not _same_params(res.carry.params, round0.params)
    assert _same_params(res.params, round0.params)
    req = lrn.scenario.batch(0, 4, 2)
    ref = DecodeEngine(lrn.engine.model, lrn.engine.ctx).generate(
        round0.params, torch.as_tensor(req["tokens"][:, :PROMPT]), lrn.gen_len)
    assert torch.equal(res.last_tokens, ref.tokens)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_serve_online_runs_on_the_cpu(capsys):
    res = serve.main(["--online", "--device", "cpu", "--rounds", "2", "--batch", "2",
                      "--prompt-len", "8", "--gen-len", "4", "--phases", "2",
                      "--mesh", "2x2"])
    assert len(res.history) == 2 and res.admission_rate == 1.0
    assert [h["freshness"] for h in res.history] == [1.0, 1.0]
    assert tuple(res.last_tokens.shape) == (2, 4)
    assert "final round" in capsys.readouterr().out


def test_serve_online_takes_a_checkpoint_dir(tmp_path):
    """``--ckpt-dir`` reaches the learner (the reference's spelling): it runs
    and serves every round."""
    res = serve.main(["--online", "--device", "cpu", "--rounds", "2", "--batch", "2",
                      "--prompt-len", "8", "--gen-len", "4", "--phases", "2",
                      "--ckpt-dir", str(tmp_path)])
    assert len(res.history) == 2 and res.admission_rate == 1.0 and res.restarts == 0
