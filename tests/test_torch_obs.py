"""The port's telemetry (``repro_torch.obs``, ``repro_torch.utils.logging``)
against the JAX package's (``repro.obs``, ``tests/test_obs.py``), on the CPU.

The contract: telemetry never perturbs the run. With the gauges on, the
``rep_checksum``/``buffer_fill``/loss fingerprints and the parameters are
bit-identical to the run with them off, flat and tiered, and the step adds
no read of a value back to the host (``aten._local_scalar_dense``) and
draws nothing. With them off it dispatches exactly the operators of a step
built without the switch. The gauges' values are held against the
reference's on the same state (the JAX state carried across with
``convert.buffer_from_jax``/``tiered_from_jax``): the buffer gauges (flat,
tiered, GRASP's mean distance, and a two-worker state as the mesh backend
sums it) within 1e-6 relative; the two packages' norms of the same arrays
too. ``PhasePipeline`` equals the fused step bit for bit, flat and tiered.
The rest is the host-side half: the tracer, the event bus, the exporters,
the runtime's publishers, the trainer's artifacts, the serve CLI's flags.
"""
import json
import logging
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.buffer as JB
from repro import obs as jobs
from repro.buffer import tiered as JT
from repro.buffer.api import buffer_obs as jbuffer_obs
from repro_torch import obs
from repro_torch.buffer import api as tapi
from repro_torch.buffer import tiered as TT
from repro_torch.buffer.state import ItemSpec
from repro_torch.configs.base import ObsConfig, RehearsalConfig
from repro_torch.convert import buffer_from_jax, tiered_from_jax
from repro_torch.obs.events import EventBus, read_events
from repro_torch.obs.exporters import (MetricsRegistry, MetricsWriter, prom_name,
                                       start_metrics_server)
from repro_torch.obs.metrics import estimate_obs_cost, obs_keys, read_gauges, tree_l2
from repro_torch.obs.trace import Tracer, validate_trace
from repro_torch.strategy import init_carry, make_cl_step
from repro_torch.utils.logging import get_logger

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _reset_global_obs():
    """Every test leaves the module-global tracer and bus disabled again."""
    yield
    obs.shutdown()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# get_logger
# ---------------------------------------------------------------------------


def test_get_logger_rank_prefix_and_level(monkeypatch):
    monkeypatch.setenv("REPRO_MP_PID", "3")
    monkeypatch.setenv("REPRO_LOG_LEVEL", "DEBUG")
    log = get_logger("repro_torch.test_obs_rank")
    assert log.level == logging.DEBUG
    ours = [h for h in log.handlers if getattr(h, "_repro_handler", False)]
    assert len(ours) == 1 and "[rank 3]" in ours[0].formatter._fmt
    # repeated calls update in place: no second handler, the environment re-read
    monkeypatch.setenv("REPRO_MP_PID", "")
    monkeypatch.setenv("REPRO_LOG_LEVEL", "WARNING")
    log2 = get_logger("repro_torch.test_obs_rank")
    assert log2 is log and len(log.handlers) == 1
    assert log.level == logging.WARNING and "[rank" not in log.handlers[0].formatter._fmt


def test_get_logger_bad_level_falls_back_to_info(monkeypatch):
    monkeypatch.setenv("REPRO_LOG_LEVEL", "NOT_A_LEVEL")
    assert get_logger("repro_torch.test_obs_badlevel").level == logging.INFO


def test_get_logger_leaves_foreign_handlers_alone(monkeypatch):
    monkeypatch.delenv("REPRO_MP_PID", raising=False)
    log = logging.getLogger("repro_torch.test_obs_foreign")
    foreign = logging.NullHandler()
    log.addHandler(foreign)
    get_logger("repro_torch.test_obs_foreign")
    assert log.handlers == [foreign]


def test_port_loggers_reach_pytest_capture(caplog):
    """The records still propagate: a handler up the tree sees them."""
    log = get_logger("repro_torch.test_obs_propagate")
    with caplog.at_level("INFO", logger=log.name):
        log.info("seen by the capture")
    assert "seen by the capture" in caplog.text


# ---------------------------------------------------------------------------
# Tracer, event bus, configure/shutdown, exporters
# ---------------------------------------------------------------------------


def test_tracer_spans_save_and_validate(tmp_path):
    tr = Tracer(enabled=True, pid=2)
    with tr.span("issue_sample", cat="pipeline", exchange="local"):
        pass
    with tr.span("checkpoint_save", cat="checkpoint", tid=1):
        pass
    tr.instant("restart", step=3)
    tr.counter("fill", {"hot": 4.0})
    assert tr.span_names() == {"issue_sample", "checkpoint_save"}
    assert tr.span_stats()["issue_sample"]["count"] == 1
    doc = json.load(open(tr.save(str(tmp_path / "trace.json"))))
    assert validate_trace(doc) == [] and doc["displayTimeUnit"] == "ms"
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert by_name["issue_sample"]["ph"] == "X" and by_name["issue_sample"]["pid"] == 2
    assert by_name["issue_sample"]["args"]["exchange"] == "local"
    assert by_name["checkpoint_save"]["tid"] == 1
    assert by_name["restart"]["ph"] == "i" and by_name["fill"]["ph"] == "C"
    # the reference's validator reads the port's file the same way
    assert jobs.validate_trace(doc) == []


def test_tracer_disabled_is_noop():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    tr.instant("y")
    tr.counter("z", {"a": 1})
    assert tr.events() == []


def test_validate_trace_rejects_malformed():
    assert validate_trace([]) != []
    assert validate_trace({"traceEvents": 3}) != []
    bad = {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0},
                           {"name": "b", "ph": "i", "pid": 0, "tid": 0},
                           {"name": 1, "ph": "i", "ts": 0, "pid": 0, "tid": 0,
                            "args": []}]}
    problems = validate_trace(bad)
    assert len(problems) == 4 and problems == jobs.validate_trace(bad)


def test_event_bus_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "ev" / "events.jsonl")
    bus = EventBus(enabled=True, path=path, rank=1)
    bus.publish("restart", source="resilient_loop", step=3, restarts=1)
    bus.publish("reshard", source="scale_carry", n_new=2)
    bus.close()
    evs = read_events(path)
    assert [e["kind"] for e in evs] == ["restart", "reshard"]
    assert evs[0]["rank"] == 1 and evs[0]["step"] == 3 and "ts" in evs[0]
    assert bus.kinds() == {"restart", "reshard"} and len(bus.of_kind("reshard")) == 1


def test_event_bus_disabled_publishes_nothing(tmp_path):
    bus = EventBus(enabled=False, path=str(tmp_path / "events.jsonl"))
    assert bus.publish("x") is None and bus.events == []
    assert not os.path.exists(tmp_path / "events.jsonl")


def test_configure_shutdown_lifecycle(tmp_path):
    d = str(tmp_path / "obs")
    tracer, bus = obs.configure(d, rank=0)
    assert tracer.enabled and bus.enabled and obs.get_tracer() is tracer
    with obs.get_tracer().span("demo"):
        pass
    obs.get_event_bus().publish("demo", source="test")
    assert obs.shutdown() == os.path.join(d, "trace.json")
    assert not obs.get_tracer().enabled and not obs.get_event_bus().enabled
    assert validate_trace(json.load(open(os.path.join(d, "trace.json")))) == []
    assert read_events(os.path.join(d, "events.jsonl"))[0]["kind"] == "demo"
    # a rank > 0 writes its own files; trace=False leaves the tracer off
    tracer, bus = obs.configure(d, rank=3, trace=False)
    assert not tracer.enabled and bus.enabled and tracer.pid == 3
    bus.publish("demo3")
    assert obs.shutdown() is None
    assert read_events(os.path.join(d, "events.rank3.jsonl"))[0]["rank"] == 3


def test_rank_comes_from_the_multiproc_variable(monkeypatch):
    monkeypatch.setenv("REPRO_MP_PID", "5")
    assert Tracer(enabled=True).pid == 5 and EventBus(enabled=False).rank == 5
    monkeypatch.delenv("REPRO_MP_PID")
    monkeypatch.delenv("RANK", raising=False)
    assert Tracer(enabled=True).pid == 0


def test_prom_name_sanitizes():
    for key in ("obs/replay_fraction", "9lives", "a-b.c", "/"):
        assert prom_name(key) == jobs.exporters.prom_name(key)


def test_metrics_registry_renders_text_format():
    reg = MetricsRegistry()
    reg.set("obs/fill", 3, help="records")
    reg.set_many({"b": 1.5})
    jreg = jobs.MetricsRegistry()
    jreg.set("obs/fill", 3, help="records")
    jreg.set_many({"b": 1.5})
    assert reg.render() == jreg.render()
    assert "# TYPE obs_fill gauge" in reg.render() and MetricsRegistry().render() == ""


def test_metrics_server_serves_registry():
    reg = MetricsRegistry()
    reg.set("repro_up", 1.0)
    server, port = start_metrics_server(reg, port=0)
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read()
        assert b"repro_up 1.0" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/other", timeout=10)
    finally:
        server.shutdown()


def test_metrics_writer_summary_and_bench_rows():
    rows = [{"loss": 1.0, "obs/fill": 2.0}, {"loss": 0.5, "obs/fill": 4.0}]
    w, jw = MetricsWriter(), jobs.MetricsWriter()
    for i, r in enumerate(rows):
        assert w.add(r, step=i) == jw.add(r, step=i) == {"obs/fill": r["obs/fill"]}
    assert w.summary() == jw.summary() == {"obs/fill": {"last": 4.0, "mean": 3.0, "max": 4.0,
                                                        "n": 2}}
    assert w.bench_rows() == jw.bench_rows() and w.steps == 2


# ---------------------------------------------------------------------------
# The static half
# ---------------------------------------------------------------------------


def _rcfg(**kw):
    base = dict(num_buckets=2, slots_per_bucket=8, num_representatives=3, num_candidates=6,
                mode="async", label_field="label")
    base.update(kw)
    return RehearsalConfig(**base)


@pytest.mark.parametrize("case", ["flat", "tiered", "grasp", "no_norms", "aux", "none"])
def test_obs_keys_and_cost_match_the_reference(case):
    from repro.configs.base import RehearsalConfig as JRehearsal

    rc = {"flat": {}, "tiered": dict(tiering="host", hot_slots=4, cold_slots=8),
          "grasp": dict(policy="grasp"), "no_norms": {}, "aux": {}, "none": None}[case]
    kw = dict(grad_norms=case != "no_norms", has_aux=case == "aux")
    rcfg = None if rc is None else _rcfg(**rc)
    jrcfg = None if rc is None else JRehearsal(**dict(dict(
        num_buckets=2, slots_per_bucket=8, num_representatives=3, num_candidates=6,
        mode="async", label_field="label"), **rc))
    assert obs_keys(rcfg, **kw) == jobs.obs_keys(jrcfg, **kw)
    assert estimate_obs_cost(rcfg, **kw) == jobs.estimate_obs_cost(jrcfg, **kw)


# ---------------------------------------------------------------------------
# Step gauges: the toggle is bit-exact, and the step reads nothing back
# ---------------------------------------------------------------------------


def _spec(d=8):
    return {"x": ItemSpec((d,), torch.float32), "label": ItemSpec((), torch.int32),
            "task": ItemSpec((), torch.int32)}


class _Linear(torch.nn.Module):
    def __init__(self, d=8, k=4):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(d, k))


def _linear_loss(model, batch):
    logits = batch["x"] @ model.w
    labels = batch["label"].long()
    mask = (labels >= 0).float()
    ce = torch.nn.functional.cross_entropy(logits, labels.clamp(min=0), reduction="none")
    return torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1.0), {}


def _sgd(grads, opt, params):
    with torch.no_grad():
        for k, p in params.items():
            p.sub_(0.1 * grads[k])
    return params, opt, {}


def _batch(step, b=16, d=8, n_classes=4):
    r = np.random.default_rng(step)
    lab = r.integers(0, n_classes, b).astype(np.int32)
    return {"x": torch.from_numpy(r.normal(size=(b, d)).astype(np.float32)),
            "label": torch.from_numpy(lab), "task": torch.from_numpy(lab % 2)}


def _tiered(**kw):
    return _rcfg(tiering="host", hot_slots=8, cold_slots=16, **kw)


def _run_steps(rcfg, obs_cfg, steps=6, step_fn=None):
    step = step_fn or make_cl_step(_linear_loss, _sgd, rcfg, exchange="local",
                                   label_field="label", device="cpu", obs=obs_cfg)
    carry = init_carry(_Linear(), None, _spec(), rcfg, label_field="label", seed=3,
                       device="cpu")
    history = []
    for s in range(steps):
        carry, m = step(carry, _batch(s), 100 + s)
        history.append(m)
    return history, carry


@pytest.mark.parametrize("tiering", ["off", "host"])
def test_obs_toggle_is_fingerprint_bit_exact(tiering):
    """Off against on: rep_checksum, buffer_fill, loss and the parameters
    to the bit; on only adds obs/* keys."""
    rcfg = _rcfg() if tiering == "off" else _tiered()
    h_off, c_off = _run_steps(rcfg, None)
    h_on, c_on = _run_steps(rcfg, ObsConfig(enabled=True))
    for off, on in zip(h_off, h_on):
        for k in ("rep_checksum", "buffer_fill", "loss"):
            assert off[k].numpy().tobytes() == on[k].numpy().tobytes(), k
        assert set(off) == {k for k in on if not k.startswith("obs/")}
        assert any(k.startswith("obs/") for k in on)
    assert torch.equal(c_off.params.w, c_on.params.w)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _step_ops(rcfg, obs_cfg):
    step = make_cl_step(_linear_loss, _sgd, rcfg, exchange="local", label_field="label",
                        device="cpu", obs=obs_cfg)
    carry = init_carry(_Linear(), None, _spec(), rcfg, label_field="label", seed=3,
                       device="cpu")
    carry, _ = step(carry, _batch(0), 1)
    with _Ops() as mode:
        step(carry, _batch(1), 2)
    return mode.ops


@pytest.mark.parametrize("tiering", ["off", "host"])
def test_gauges_add_no_host_read_and_nothing_when_off(tiering):
    """Off (or disabled) dispatches exactly the operators of a step built
    without the switch; on adds operators but none that reads a value back
    to the host: the gauges stay on the device until ``read_gauges``."""
    rcfg = _rcfg() if tiering == "off" else _tiered()
    plain = _step_ops(rcfg, None)
    assert _step_ops(rcfg, ObsConfig()) == plain
    assert _step_ops(rcfg, ObsConfig(enabled=True, step_metrics=False)) == plain
    on = _step_ops(rcfg, ObsConfig(enabled=True))
    reads = "aten._local_scalar_dense.default"
    assert len(on) > len(plain) and on.count(reads) == plain.count(reads)


def test_obs_gauge_sanity_flat():
    h, _ = _run_steps(_rcfg(), ObsConfig(enabled=True), steps=8)
    last = read_gauges(h[-1])
    assert 0 < last["obs/fill"] <= 2 * 8
    assert 0.0 <= last["obs/replay_fraction"] < 1.0 and last["obs/reps_valid"] <= 3
    assert last["obs/rep_staleness"] == 1.0
    assert last["obs/grad_norm"] >= 0 and last["obs/param_norm"] > 0
    fills = [read_gauges(m)["obs/fill"] for m in h]
    assert fills == sorted(fills) and fills == [float(m["buffer_fill"]) for m in h]


def test_obs_gauge_sanity_tiered():
    rcfg = _rcfg(tiering="host", hot_slots=4, cold_slots=8, slots_per_bucket=4)
    h, _ = _run_steps(rcfg, ObsConfig(enabled=True), steps=8)
    last = read_gauges(h[-1])
    assert {"obs/hot_fill", "obs/cold_fill", "obs/demotions", "obs/stage_pending"} <= set(last)
    assert last["obs/hot_fill"] <= 2 * 4 and last["obs/cold_fill"] > 0
    assert last["obs/fill"] == last["obs/hot_fill"] + last["obs/cold_fill"]


def test_grad_norms_flag_gates_norm_gauges():
    h, _ = _run_steps(_rcfg(), ObsConfig(enabled=True, grad_norms=False))
    assert "obs/grad_norm" not in h[0] and "obs/param_norm" not in h[0]
    assert "obs/fill" in h[0]


def test_split_train_half_and_stale_step_gauges():
    """The split form's train half carries the norms and the replay's
    gauges (the buffer's belong to the fused step), the stale step all of
    them with the slot's structural staleness; neither changes the loss."""
    from repro_torch.strategy import make_pipelined_halves, make_stale_step

    rcfg = _rcfg()
    _, carry = _run_steps(rcfg, None, steps=3)
    batch = _batch(9)
    got = {}
    for name, ocfg in (("off", None), ("on", ObsConfig(enabled=True))):
        train, _ = make_pipelined_halves(_linear_loss, _sgd, rcfg, label_field="label",
                                         device="cpu", obs=ocfg)
        stale = make_stale_step(_linear_loss, _sgd, rcfg, label_field="label", device="cpu",
                                obs=ocfg)
        w = carry.params.w.detach().clone()
        _, _, m_half = train(carry.params, None, carry.pipe, batch)
        carry.params.w.data.copy_(w)
        _, m_stale = stale(carry, batch, 1)
        # the model is shared by the old carry and the step's result: the
        # weights are put back through the old carry on purpose
        carry.params.w.data.copy_(w)  # replint: disable=RPL010
        got[name] = (m_half, m_stale)
    (half_off, stale_off), (half_on, stale_on) = got["off"], got["on"]
    assert torch.equal(half_off["loss"], half_on["loss"])
    assert torch.equal(stale_off["loss"], stale_on["loss"])
    assert {k for k in half_on if k.startswith("obs/")} == {
        "obs/grad_norm", "obs/param_norm", "obs/reps_valid", "obs/replay_fraction",
        "obs/rep_staleness"}
    assert "obs/fill" in stale_on and read_gauges(stale_on)["obs/rep_staleness"] == 1.0
    assert read_gauges(stale_on)["obs/fill"] == float(stale_on["buffer_fill"])


def test_read_gauges_takes_tensors_and_host_values():
    m = {"loss": torch.tensor(1.0), "obs/a": torch.tensor(2.0), "obs/b": 3.0,
         "obs/c": torch.tensor(4, dtype=torch.int32)}
    assert read_gauges(m) == {"obs/a": 2.0, "obs/b": 3.0, "obs/c": 4.0}
    assert read_gauges({"loss": 1.0}) == {}


# ---------------------------------------------------------------------------
# Gauge values against the reference's, on the same state
# ---------------------------------------------------------------------------


def _jspec(d=8):
    return {"x": jax.ShapeDtypeStruct((d,), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}


def _jbatch(step, b=16):
    return {k: jnp.asarray(v.numpy()) for k, v in _batch(step, b).items()}


def _close(got, want, what):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        assert abs(g - w) <= RTOL * max(abs(w), 1e-30), (what, k, g, w)


def _jax_flat(policy, steps=6, c=6, seed=0):
    jbuf = JB.init_buffer(_jspec(), 2, 4, policy)
    for s in range(steps):
        b = _jbatch(seed + s)
        jbuf = JB.local_update(jbuf, b, b["task"], jax.random.PRNGKey(seed * 100 + s), c,
                               policy)
    return jbuf


@pytest.mark.parametrize("policy", ["reservoir", "fifo", "class_balanced", "grasp"])
def test_buffer_obs_matches_jax(policy):
    """``buffer_obs`` of the reference's buffer after six updates (full
    buckets, evictions), carried across: every gauge, GRASP's mean
    prototype distance included."""
    from repro.buffer.policies import resolve_policy as jresolve_policy
    from repro_torch.buffer.policies import resolve_policy

    rc = _rcfg(policy=policy)
    jbuf = _jax_flat(policy)
    tbuf = buffer_from_jax(jbuf, "cpu")
    want = jbuffer_obs(jbuf, rc)
    _close(tapi.buffer_obs(tbuf, rc), want, policy)
    assert float(want["obs/evictions"]) > 0
    aux = resolve_policy(policy).obs_aux(tbuf)
    _close(aux, jresolve_policy(policy).obs_aux(jbuf), f"{policy} obs_aux")
    assert ("obs/grasp_mean_dist" in aux) == (policy == "grasp")


def test_replay_metrics_match_jax():
    valid = np.array([True, False, True])
    want = jobs.metrics.replay_metrics(jnp.asarray(valid), 16)
    _close(obs.metrics.replay_metrics(torch.from_numpy(valid), 16), want, "replay")


def test_tiered_obs_matches_jax():
    jst = JT.init_tiered(_jspec(), 2, 2, 16, 8, "reservoir")
    for s in range(5):
        b = _jbatch(s)
        jst = JT.tiered_update(jst, b, b["task"], jax.random.PRNGKey(s), 6, "reservoir")
    want = JT.tiered_obs(jst)
    got = TT.tiered_obs(tiered_from_jax(jst, "cpu"))
    _close(got, want, "tiered")
    assert float(want["obs/cold_fill"]) > 0 and float(want["obs/stage_pending"]) > 0
    rc = _tiered(policy="grasp")
    jst = JT.init_tiered(_jspec(), 2, 2, 16, 8, "grasp")
    for s in range(3):
        b = _jbatch(s)
        jst = JT.tiered_update(jst, b, b["task"], jax.random.PRNGKey(s), 6, "grasp")
    _close(tapi.buffer_obs(tiered_from_jax(jst, "cpu"), rc), jbuffer_obs(jst, rc), "grasp")


@pytest.mark.parametrize("policy", ["reservoir", "grasp"])
def test_summed_parts_of_two_workers_match_the_stacked_state(policy):
    """The mesh backend's rule: each worker's additive parts, summed (as the
    one all_reduce sums them), give the gauges the reference reads off its
    ``[N_dp, K]`` state."""
    rc = _rcfg(policy=policy)
    jbufs = [_jax_flat(policy, seed=w * 10) for w in range(2)]
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jbufs)
    parts = [tapi.buffer_obs_parts(buffer_from_jax(b, "cpu"), rc) for b in jbufs]
    summed = {k: parts[0][k] + parts[1][k] for k in parts[0]}
    _close(tapi.obs_from_parts(summed, rc), jbuffer_obs(stacked, rc), policy)


def test_tree_l2_matches_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want = float(jobs.metrics.tree_l2([jnp.asarray(a) for a in arrays]))
    got = float(tree_l2([torch.from_numpy(a) for a in arrays] + [torch.ones(2, dtype=torch.int32)]))
    assert abs(got - want) <= RTOL * want


# ---------------------------------------------------------------------------
# PhasePipeline: bit-exact against the fused step, one span a phase
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiering", ["off", "host", "host_fused"])
def test_phase_pipeline_matches_fused_step(tiering):
    rcfg = {"off": _rcfg(), "host": _tiered(),
            "host_fused": _tiered(fused_kernels=True)}[tiering]
    h_fused, c_fused = _run_steps(rcfg, None)
    tracer = Tracer(enabled=True)
    pipeline = obs.PhasePipeline(_linear_loss, _sgd, rcfg, exchange="local",
                                 label_field="label", tracer=tracer, device="cpu")
    h_phased, carry = _run_steps(rcfg, None, step_fn=pipeline.step)
    for fused, phased in zip(h_fused, h_phased):
        for k in ("loss", "rep_checksum", "buffer_fill"):
            assert fused[k].numpy().tobytes() == phased[k].numpy().tobytes(), k
    assert torch.equal(c_fused.params.w, carry.params.w)
    for k in ("reps", "valid"):
        a, b = getattr(c_fused.pipe, k), getattr(carry.pipe, k)
        if isinstance(a, dict):
            assert all(torch.equal(a[n], b[n]) for n in a)
        else:
            assert torch.equal(a, b)
    if tiering == "off":
        assert torch.equal(c_fused.buffer.counts, carry.buffer.counts)
        assert all(torch.equal(c_fused.buffer.data[n], carry.buffer.data[n])
                   for n in carry.buffer.data)
        expected = {"consume_reps", "issue_sample", "all_to_all"}
    else:
        for tier in ("hot", "cold"):
            a, b = getattr(c_fused.buffer, tier), getattr(carry.buffer, tier)
            assert torch.equal(a.counts, b.counts)
        assert torch.equal(c_fused.buffer.stage_valid, carry.buffer.stage_valid)
        expected = set(obs.PHASES)
    assert tracer.span_names() == expected
    assert all(s["count"] == 6 for s in tracer.span_stats().values())


def test_phase_pipeline_needs_rehearsal():
    with pytest.raises(ValueError, match="RehearsalConfig"):
        obs.PhasePipeline(_linear_loss, _sgd, _rcfg(mode="off"), device="cpu")


# ---------------------------------------------------------------------------
# The runtime's publishers
# ---------------------------------------------------------------------------


def test_runtime_publishers_emit_events_and_spans(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import InjectedFailure, ResilientLoop
    from repro_torch.runtime.autoscale import Autoscaler, scale_carry

    d = str(tmp_path / "obs")
    obs.configure(d, rank=0)
    rcfg = _rcfg()
    step = make_cl_step(_linear_loss, _sgd, rcfg, exchange="local", label_field="label",
                        device="cpu")
    carry = init_carry(_Linear(), None, _spec(), rcfg, label_field="label", seed=3,
                       device="cpu")
    loop = ResilientLoop(step_fn=step, ckpt=CheckpointManager(str(tmp_path / "ckpt")),
                         checkpoint_every=1, max_restarts=2)
    fired = []

    def chaos(s):
        if s == 1 and not fired:
            fired.append(s)
            raise InjectedFailure("injected")

    carry, _, restarts = loop.run(carry, _batch, 0, 3, failure_hook=chaos)
    assert restarts == 1
    assert Autoscaler(cooldown_steps=1, max_workers=4).observe(step=0, load=3.5,
                                                               current=1) == 4
    _, seconds = scale_carry([carry], 2)
    assert seconds > 0

    tracer, bus = obs.get_tracer(), obs.get_event_bus()
    assert {"restart", "checkpoint_save", "checkpoint_restore", "autoscale",
            "reshard"} <= bus.kinds()
    restart = bus.of_kind("restart")[0]
    assert restart["source"] == "resilient_loop" and restart["error"] == "InjectedFailure"
    assert restart["step"] == 1
    auto = bus.of_kind("autoscale")[0]
    assert (auto["old"], auto["new"]) == (1, 4)
    assert bus.of_kind("reshard")[0]["n_new"] == 2
    assert {"restore", "checkpoint_save", "checkpoint_restore", "reshard"} <= \
        tracer.span_names()
    saves = [e for e in tracer.events() if e["name"] == "checkpoint_save"]
    assert saves and all(e["tid"] == 1 for e in saves)  # the writer thread's track
    obs.shutdown()
    assert validate_trace(json.load(open(os.path.join(d, "trace.json")))) == []
    assert {"restart", "reshard"} <= {e["kind"] for e in
                                      read_events(os.path.join(d, "events.jsonl"))}


def test_straggler_policy_publishes_stale_dispatch(tmp_path):
    from repro_torch.runtime import StragglerPolicy

    obs.configure(str(tmp_path / "obs"), rank=0)
    pol = StragglerPolicy(delay_prob=0.0, max_staleness=2)
    pol.record_slow()
    assert pol.use_fresh() is False
    ev = obs.get_event_bus().of_kind("stale_dispatch")
    assert len(ev) == 1 and ev[0]["source"] == "straggler" and ev[0]["staleness"] == 1
    assert ev[0]["detected"] is True


# ---------------------------------------------------------------------------
# The trainer and the serve CLI
# ---------------------------------------------------------------------------


def _token_run(obs_cfg, strategy="rehearsal", tiering="off"):
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import RunConfig, ScenarioConfig, StrategyConfig, TrainConfig

    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=128, num_layers=2)
    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                           num_candidates=6, mode="async", tiering=tiering, hot_slots=4,
                           cold_slots=8, label_field="labels")
    return RunConfig(
        model=cfg, obs=obs_cfg,
        train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                          linear_scaling=False, compute_dtype="float32"),
        rehearsal=rcfg, strategy=StrategyConfig(alpha=0.5, beta=0.5, top_k=8),
        scenario=ScenarioConfig(name="class_incremental", modality="tokens", strategy=strategy,
                                num_tasks=2, epochs_per_task=1, steps_per_epoch=4,
                                batch_size=8, vocab_size=128, seq_len=16,
                                auto_defaults=False))


def _fingerprints(result):
    return [(h["rep_checksum"], h["buffer_fill"], h["loss"]) for h in result.history]


def test_trainer_obs_toggle_der_pp_and_artifacts(tmp_path):
    """der_pp through ``ContinualTrainer`` with obs off and on: identical
    fingerprints and losses, the gauges in every history entry and in
    ``result.obs`` (der's stored logits as the aux payload), and the
    trace with its eval spans on disk."""
    from repro_torch.scenario import ContinualTrainer

    d = str(tmp_path / "obs")
    off = ContinualTrainer(_token_run(ObsConfig(), "der_pp"), device="cpu").fit()
    on = ContinualTrainer(_token_run(ObsConfig(enabled=True, dir=d), "der_pp"),
                          device="cpu").fit()
    assert _fingerprints(off) == _fingerprints(on) and off.losses == on.losses
    assert off.obs is None and "obs/fill" in on.obs
    assert on.obs["obs/aux_row_bytes"]["last"] > 0
    assert all(any(k.startswith("obs/") for k in h) for h in on.history)
    assert all(h["obs/fill"] == h["buffer_fill"] for h in on.history)
    doc = json.load(open(os.path.join(d, "trace.json")))
    assert validate_trace(doc) == []
    evals = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e["name"] == "eval"]
    assert [e["args"]["task"] for e in evals] == [0, 1]


@pytest.mark.parametrize("tiering", ["off", "host"])
def test_carry_equals_mesh_fingerprints_with_obs_on(tiering):
    """The carry backend and the mesh backend at 1x1 (``exchange='local'``)
    with obs on: the same fingerprints and the same gauges under the same
    keys, both in ``result.obs``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.scenario import ContinualTrainer, TokenClassIncremental

    run = _token_run(ObsConfig(enabled=True), tiering=tiering)
    sc = TokenClassIncremental(run.scenario)
    mesh = ContinualTrainer(run, sc, device="cpu", mesh=make_mesh((1, 1), ("data", "model")),
                            exchange="local").fit()
    carry = ContinualTrainer(run, sc, device="cpu").fit()
    assert _fingerprints(mesh) == _fingerprints(carry)
    for hm, hc in zip(mesh.history, carry.history):
        gm = {k: v for k, v in hm.items() if k.startswith("obs/")}
        gc = {k: v for k, v in hc.items() if k.startswith("obs/")}
        assert set(gm) == set(gc) and "obs/fill" in gm
        assert all(gm[k] == gc[k] for k in gm if not k.endswith("_norm"))
    assert mesh.obs and carry.obs


def test_serve_obs_writes_a_valid_trace(tmp_path):
    from repro_torch.launch import serve

    d = str(tmp_path / "serve_obs")
    serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen-len", "3", "--obs", d])
    doc = json.load(open(os.path.join(d, "trace.json")))
    assert validate_trace(doc) == []
    spans = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"prefill", "decode"} <= set(spans) and spans["decode"]["args"]["tokens"] == 3
    assert not obs.get_tracer().enabled  # the CLI shut its telemetry down


def test_serve_metrics_port_serves_the_gauges(monkeypatch):
    """``--metrics-port 0``: the gauges are scraped from the endpoint while
    it is up (just before the CLI shuts it down)."""
    from repro_torch.launch import serve

    scraped = []
    real = obs.start_metrics_server

    def start(registry, port=0, host="127.0.0.1"):
        server, bound = real(registry, port=port, host=host)
        stop = server.shutdown

        def shutdown():
            url = f"http://127.0.0.1:{bound}/metrics"
            scraped.append(urllib.request.urlopen(url, timeout=10).read().decode())
            stop()

        server.shutdown = shutdown
        return server, bound

    monkeypatch.setattr(obs, "start_metrics_server", start)
    res = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "4", "--gen-len", "3", "--metrics-port", "0"])
    (text,) = scraped
    assert f"repro_serve_decode_tokens_per_second {res.tokens_per_second!r}" in text
    assert "repro_serve_prefill_seconds" in text and "repro_serve_batch_size 2.0" in text
