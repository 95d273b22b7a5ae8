"""The port's pipeline race sanitizer (``repro_torch.runtime.sanitizer``): the
reference's cases (``tests/test_sanitizer.py``) on the port's fused step,
stale step and split halves, the resilient loop's rewind, and the neutrality
contract: fingerprints bit-identical with the sanitizer on and off. The
reference's donation checks (``check_live``) have no counterpart: the port's
steps write in place and donate nothing."""
import numpy as np
import pytest
import torch

from repro_torch.buffer.state import ItemSpec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import (RehearsalConfig, ResilienceConfig, RunConfig,
                                      ScenarioConfig)
from repro_torch.runtime import InjectedFailure, ResilientLoop
from repro_torch.runtime.sanitizer import (PipelineRaceSanitizer, SanitizerError,
                                           sanitize_enabled)
from repro_torch.scenario import ContinualTrainer
from repro_torch.strategy import (init_carry, make_cl_step, make_pipelined_halves,
                                  make_stale_step)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU runs: intra-op threads gain nothing while several test
    processes share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPEC = {"x": ItemSpec((8,), torch.float32), "label": ItemSpec((), torch.int32),
        "task": ItemSpec((), torch.int32)}
PIPE = RehearsalConfig(num_buckets=2, slots_per_bucket=8, num_representatives=3,
                       num_candidates=6, mode="sync", pipelined=True)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(8, 4))


def _linear_loss(model, batch):
    logits = batch["x"] @ model.w
    mask = (batch["label"] >= 0).float()
    ce = torch.nn.functional.cross_entropy(logits, batch["label"].long().clamp(min=0),
                                           reduction="none")
    return torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1.0), {}


@torch.no_grad()
def _sgd(grads, opt, params):
    for k, p in params.items():
        p.sub_(0.1 * grads[k])
    return params, opt, {}


def _batch(step, b=16, n_classes=4):
    r = np.random.default_rng(step)
    lab = r.integers(0, n_classes, b).astype(np.int32)
    return {"x": r.normal(size=(b, 8)).astype(np.float32), "label": lab,
            "task": (lab % 2).astype(np.int32)}


def _carry():
    return init_carry(_Linear(), None, SPEC, PIPE, label_field="label", seed=3, device="cpu")


# ---------------------------------------------------------------------------
# The epoch model
# ---------------------------------------------------------------------------


def test_legal_alternation_is_silent():
    san = PipelineRaceSanitizer()
    for _ in range(5):  # consume the bootstrap, issue the next, repeat
        san.consume()
        san.issue()
        san.tick()
    assert san.races == 0 and san.step == 5


def test_double_issue_is_a_lost_sample_race():
    san = PipelineRaceSanitizer()
    san.consume()
    san.issue()
    with pytest.raises(SanitizerError, match="issued twice"):
        san.issue()
    assert san.races == 1


def test_wrong_order_drive_trips_at_step_zero():
    # the bootstrap slot is already issued: a loop that issues before the
    # first consume overwrote a never-read sample
    with pytest.raises(SanitizerError, match="issued twice"):
        PipelineRaceSanitizer().issue()


def test_double_consume_is_a_race_but_stale_reread_is_not():
    san = PipelineRaceSanitizer()
    san.consume()
    with pytest.raises(SanitizerError, match="consumed twice"):
        san.consume()
    san2 = PipelineRaceSanitizer()
    san2.consume()
    san2.consume(stale=True)  # bounded-staleness re-read: allowed
    san2.consume(stale=True)
    san2.issue()  # the slot still alternates afterwards
    assert san2.races == 0


def test_same_step_issue_then_consume_race():
    san = PipelineRaceSanitizer()
    san.consume()
    san.issue()
    with pytest.raises(SanitizerError, match="one step stale"):
        san.consume()


def test_error_carries_the_epoch_log():
    san = PipelineRaceSanitizer("fused")
    san.consume()
    san.issue()
    san.tick()
    with pytest.raises(SanitizerError) as exc:
        san.issue()
    msg = str(exc.value)
    assert "[fused]" in msg and "recent epochs" in msg and "issue@0" in msg


def test_rewind_resets_to_ready_to_consume():
    san = PipelineRaceSanitizer()
    for _ in range(4):
        san.consume()
        san.issue()
        san.tick()
    san.rewind(2)
    assert san.step == 2
    san.consume()  # the restored slot is freshly issued: consume is legal
    san.issue()
    assert san.races == 0


def test_sanitize_enabled_env_and_config(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize_enabled()
    assert sanitize_enabled(RunConfig(sanitize=True))
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert make_cl_step(_linear_loss, _sgd, PIPE, label_field="label",
                        device="cpu")._sanitizer is not None  # None follows the env


# ---------------------------------------------------------------------------
# Wrapped step factories: injected races against the disciplined drive
# ---------------------------------------------------------------------------


def _halves():
    return make_pipelined_halves(_linear_loss, _sgd, PIPE, exchange="local",
                                 label_field="label", device="cpu", sanitize=True)


def test_split_halves_wrong_order_trips_sanitizer():
    """The issue half before the first train half overwrites the
    never-consumed bootstrap sample: without the sanitizer the numbers are
    silently wrong; with it, step 0 raises."""
    _, issue_half = _halves()
    carry = _carry()
    with pytest.raises(SanitizerError, match="issued twice"):
        issue_half(carry.buffer, carry.pipe, _batch(0), 0)


def test_split_halves_same_step_reuse_trips_sanitizer():
    train_half, _ = _halves()
    carry = _carry()
    model, opt, _ = train_half(carry.params, carry.opt, carry.pipe, _batch(0))
    with pytest.raises(SanitizerError, match="consumed twice"):
        train_half(model, opt, carry.pipe, _batch(0))


def test_split_halves_disciplined_drive_is_silent():
    train_half, issue_half = _halves()
    carry = _carry()
    model, opt, buf, pipe = carry.params, carry.opt, carry.buffer, carry.pipe
    for s in range(6):
        model, opt, _ = train_half(model, opt, pipe, _batch(s))
        buf, pipe = issue_half(buf, pipe, _batch(s), s)
    assert train_half._sanitizer is issue_half._sanitizer
    assert train_half._sanitizer.races == 0 and train_half._sanitizer.step == 6
    assert issue_half.stream is None and issue_half.join() is None  # attributes kept


def test_fused_step_clean_run_and_shared_stale_clock():
    step = make_cl_step(_linear_loss, _sgd, PIPE, exchange="local", label_field="label",
                        device="cpu", sanitize=True)
    san = step._sanitizer
    stale = make_stale_step(_linear_loss, _sgd, PIPE, label_field="label", device="cpu",
                            sanitize=san)
    assert stale._sanitizer is san
    carry = _carry()
    for s in range(4):
        fn = stale if s == 2 else step  # a stale dispatch mid-run is legal
        carry, _ = fn(carry, _batch(s), s)
    assert san.races == 0 and san.step == 4


def test_a_read_of_the_slot_outside_the_step_makes_the_next_fused_step_a_race():
    """The fused step consumes and issues in one call; a loop that also
    reads the pending slot between two steps is caught on the same clock."""
    step = make_cl_step(_linear_loss, _sgd, PIPE, exchange="local", label_field="label",
                        device="cpu", sanitize=True)
    carry = _carry()
    carry, _ = step(carry, _batch(0), 0)
    san = step._sanitizer
    san.consume()  # a loop that read the pending slot outside the step...
    with pytest.raises(SanitizerError, match="consumed twice"):
        step(carry, _batch(1), 1)  # ...makes the next fused consume a race


# ---------------------------------------------------------------------------
# Neutrality: fingerprints bit-identical sanitize on/off
# ---------------------------------------------------------------------------


def _checksums(sanitize):
    step = make_cl_step(_linear_loss, _sgd, PIPE, exchange="local", label_field="label",
                        device="cpu", sanitize=sanitize)
    carry = _carry()
    out = []
    for s in range(8):
        carry, m = step(carry, _batch(s), s)
        out.append((float(m["rep_checksum"]), float(m["loss"]), float(m["buffer_fill"])))
    return out, carry.params.w.detach().clone()


def test_fingerprints_bit_identical_on_off():
    on, w_on = _checksums(True)
    off, w_off = _checksums(False)
    assert on == off and torch.equal(w_on, w_off)
    assert any(c for c, _, _ in on)


def _run(**rk):
    return RunConfig(
        rehearsal=RehearsalConfig(slots_per_bucket=6, num_representatives=2, num_candidates=4,
                                  mode="async", **rk),
        scenario=ScenarioConfig(num_tasks=2, steps_per_epoch=4, batch_size=8, image_size=8,
                                classes_per_task=4))


@pytest.mark.parametrize("form", ["fused", "split", "resilient"])
def test_trainer_with_the_sanitizer_keeps_its_histories(form, tmp_path):
    """``RunConfig(sanitize=True)`` on the trainer: no race on the fused, split
    and resilient paths (the last with stale steps and a restart), and the
    same history as the run without it."""
    kw = {"step_form": "split"} if form == "split" else {}
    if form == "resilient":
        kw = dict(resilience=ResilienceConfig(checkpoint_every=2, straggler_delay_prob=0.5,
                                              max_staleness=1))
    fired = []

    def hook(step):
        if step == 5 and not fired:
            fired.append(step)
            raise InjectedFailure("blip")

    def fit(sanitize):
        if form == "resilient":  # each fit restores from its own checkpoints
            kw.update(ckpt_dir=str(tmp_path / str(sanitize)), overrides={"failure_hook": hook})
        tr = ContinualTrainer(_run().replace(sanitize=sanitize), device="cpu", **kw)
        fired.clear()
        return tr, tr.fit()

    tr_on, on = fit(True)
    _, off = fit(False)
    san = (tr_on._halves[0] if form == "split" else tr_on._step_fn)._sanitizer
    assert san.races == 0 and san.step == 8
    assert on.history == off.history and on.losses == off.losses
    if form == "resilient":
        assert on.restarts == 1 and on.resilience_stats["stale_steps"] > 0


# ---------------------------------------------------------------------------
# ResilientLoop integration
# ---------------------------------------------------------------------------


def _toy_loop(tmp_path, step_fn, **kw):
    return ResilientLoop(step_fn=step_fn, ckpt=CheckpointManager(str(tmp_path)),
                         checkpoint_every=2, max_restarts=3, **kw)


def test_resilient_restore_rewinds_the_slot_clock(tmp_path):
    san = PipelineRaceSanitizer("loop")

    def step_fn(carry, batch, key):
        san.consume()
        out = {"w": carry["w"] + 1.0}
        san.issue()
        san.tick()
        return out, {"loss": 0.0}

    step_fn._sanitizer = san
    fails = {4}

    def hook(step):
        if step in fails:
            fails.discard(step)
            raise InjectedFailure(f"boom@{step}")

    carry, _, restarts = _toy_loop(tmp_path, step_fn).run(
        {"w": torch.zeros(2)}, lambda s: None, 0, 6, failure_hook=hook)
    assert restarts == 1
    assert san.races == 0  # the rewind realigned the clock: no false race
    assert san.step == 6  # rewind(4), then the remaining 2 steps
    assert carry["w"].tolist() == [6.0, 6.0]


def test_sanitizer_error_is_never_retried(tmp_path):
    calls = []

    def step_fn(carry, batch, key):
        calls.append(1)
        raise SanitizerError("injected race")

    # a retry_on that matches (RuntimeError covers SanitizerError) must not
    # make the loop burn restarts on a race
    loop = _toy_loop(tmp_path, step_fn, retry_on=(RuntimeError,))
    with pytest.raises(SanitizerError, match="injected race"):
        loop.run({"w": torch.zeros(2)}, lambda s: None, 0, 3)
    assert len(calls) == 1
