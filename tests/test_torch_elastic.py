"""Elastic resharding and autoscaling of the port against the reference.

The port's buffers are per process, so ``reshard_carry`` / ``reshard_tiered``
/ ``reshard_buffer`` take the N ranks' states and return N' new ones; the
reference takes one state with a worker axis. Both see the same records
(random, from a seed), and the port's new states stacked must equal the
reference's: records, counts, ``seen``, the tiered stage, the demoted int8
rows and FIFO's rebuilt cursor bit for bit; GRASP's rebuilt prototypes and
distances at rtol 1e-6 (f32 sums in another order, as
``tests/test_torch_policies.py`` holds ``reshard_aux``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.buffer import state as jstate
from repro.buffer import tiered as jtiered
from repro.checkpoint import reshard_buffer as jreshard_buffer
from repro.runtime import Autoscaler as JAutoscaler
from repro.runtime import TrafficSignal as JTrafficSignal
from repro.runtime import reshard_carry as jreshard_carry
from repro.runtime import reshard_tiered as jreshard_tiered
from repro.strategy import PipelinedRehearsalCarry as JPipe
from repro.strategy import TrainCarry as JTrainCarry
from repro_torch.checkpoint import reshard_buffer
from repro_torch.convert import buffer_from_jax, tiered_from_jax
from repro_torch.runtime import (Autoscaler, TrafficSignal, reshard_carry, reshard_tiered,
                                 scale_carry)
from repro_torch.strategy import PipelinedRehearsalCarry, TrainCarry

K, SLOTS, HOT, COLD, STAGE, R = 3, 4, 3, 5, 4, 2
SPEC = {"x": jax.ShapeDtypeStruct((6,), jnp.float32),
        "label": jax.ShapeDtypeStruct((), jnp.int32),
        "task": jax.ShapeDtypeStruct((), jnp.int32)}


def _fill(buf, rng, slots, aux_policy=None):
    """A JAX BufferState with random records, counts and seen (and a random
    FIFO cursor)."""
    def rand(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
        if a.dtype == np.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape).astype(np.int8))
        return jnp.asarray(rng.integers(0, 50, a.shape).astype(a.dtype))

    data = jax.tree_util.tree_map(rand, buf.data)
    counts = jnp.asarray(rng.integers(0, slots + 1, K).astype(np.int32))
    seen = counts + jnp.asarray(rng.integers(0, 9, K).astype(np.int32))
    aux = buf.aux
    if aux_policy == "fifo":
        aux = {"cursor": jnp.asarray(rng.integers(0, slots, K).astype(np.int32))}
    return buf._replace(data=data, counts=counts, seen=seen, aux=aux)


def _jax_flat(n, policy, seed):
    rng = np.random.default_rng(seed)
    return [_fill(jstate.init_buffer(SPEC, K, SLOTS, policy), rng, SLOTS, policy)
            for _ in range(n)]


def _jax_tiered(n, policy, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        st = jtiered.init_tiered(SPEC, K, HOT, COLD, STAGE, policy)
        st = st._replace(hot=_fill(st.hot, rng, HOT, policy),
                         cold=_fill(st.cold, rng, COLD))
        out.append(st._replace(
            stage={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                   if v.dtype == jnp.float32 else jnp.asarray(
                       rng.integers(0, 9, v.shape).astype(np.int32))
                   for k, v in st.stage.items()},
            stage_labels=jnp.asarray(rng.integers(0, K, STAGE).astype(np.int32)),
            stage_valid=jnp.asarray(rng.random(STAGE) < 0.6)))
    return out


def _stack(states):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def _pipes(n, seed):
    rng = np.random.default_rng(seed)
    reps = [{"x": rng.normal(size=(R, 6)).astype(np.float32),
             "label": rng.integers(0, 9, R).astype(np.int32),
             "task": rng.integers(0, K, R).astype(np.int32)} for _ in range(n)]
    valid = [rng.random(R) < 0.7 for _ in range(n)]
    return reps, valid


def _same(got, want, name="", rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _same(got[k], want[k], f"{name}/{k}", rtol)
        return
    got, want = got.cpu().numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if rtol and got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=name)
    else:
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=name)


def _same_buffer(got, want, w):
    _same(got.data, jax.tree_util.tree_map(lambda a: a[w], dict(want.data)), "data")
    _same(got.counts, want.counts[w], "counts")
    _same(got.seen, want.seen[w], "seen")
    if want.aux:
        _same(got.aux, jax.tree_util.tree_map(lambda a: a[w], dict(want.aux)), "aux",
              rtol=1e-6)
    else:
        assert got.aux == ()


CASES = [(2, 4), (4, 2), (2, 1), (3, 3)]


@pytest.mark.parametrize("n_old,n_new", CASES)
@pytest.mark.parametrize("policy", ["reservoir", "fifo", "grasp"])
def test_reshard_carry_of_flat_buffers_matches_the_reference(policy, n_old, n_new):
    jstates = _jax_flat(n_old, policy, seed=10 * n_old + n_new)
    reps, valid = _pipes(n_old, seed=n_new)
    jcarry = JTrainCarry({}, {}, _stack(jstates),
                         JPipe({k: jnp.asarray(np.stack([r[k] for r in reps])) for k in reps[0]},
                               jnp.asarray(np.stack(valid)), jax.random.PRNGKey(3)), None)
    want = jreshard_carry(jcarry, n_new, policy=None if policy == "reservoir" else policy)
    carries = [TrainCarry("model", "opt", buffer_from_jax(s, "cpu"),
                          PipelinedRehearsalCarry({k: torch.from_numpy(v) for k, v in r.items()},
                                                  torch.from_numpy(m), 17), None)
               for s, r, m in zip(jstates, reps, valid)]
    got = reshard_carry(carries, n_new, policy=None if policy == "reservoir" else policy)
    assert len(got) == n_new
    for w, c in enumerate(got):
        assert c.params == "model" and c.opt == "opt" and c.pipe.key == 17
        _same_buffer(c.buffer, want.buffer, w)
        _same(c.pipe.reps, {k: v[w] for k, v in want.pipe.reps.items()}, "reps")
        _same(c.pipe.valid, want.pipe.valid[w], "valid")
    # every record within the new aggregate capacity is kept
    before = sum(int(s.counts.sum()) for s in jstates)
    pooled = np.stack([np.asarray(s.counts) for s in jstates]).sum(0)
    assert sum(int(c.buffer.counts.sum()) for c in got) == int(
        np.minimum(pooled, n_new * SLOTS).sum()) and pooled.sum() == before


@pytest.mark.parametrize("n_old,n_new", CASES)
def test_reshard_buffer_matches_the_reference(n_old, n_new):
    jstates = _jax_flat(n_old, None, seed=n_old + 7 * n_new)
    want_data, want_counts = jreshard_buffer(_stack(jstates).data,
                                             np.stack([np.asarray(s.counts) for s in jstates]),
                                             n_new)
    ports = [buffer_from_jax(s, "cpu") for s in jstates]
    data, counts = reshard_buffer([p.data for p in ports], [p.counts for p in ports], n_new)
    for w in range(n_new):
        _same(data[w], jax.tree_util.tree_map(lambda a: a[w], dict(want_data)), "data")
        assert counts[w].tolist() == want_counts[w].tolist()


@pytest.mark.parametrize("n_old,n_new", CASES)
@pytest.mark.parametrize("policy", ["reservoir", "fifo"])
def test_reshard_tiered_matches_the_reference(policy, n_old, n_new):
    """Tier by tier, with the hot overflow int8-demoted into the cold pool
    on a shrink (2 -> 1 demotes at these fills)."""
    jstates = _jax_tiered(n_old, policy, seed=3 * n_old + n_new)
    pol = None if policy == "reservoir" else policy
    want = jreshard_tiered(_stack(jstates), n_new, pol)
    got = reshard_tiered([tiered_from_jax(s, "cpu") for s in jstates], n_new, pol)
    for w, st in enumerate(got):
        _same_buffer(st.hot, want.hot, w)
        _same_buffer(st.cold, want.cold, w)
        _same(st.stage, {k: v[w] for k, v in want.stage.items()}, "stage")
        _same(st.stage_labels, want.stage_labels[w], "stage_labels")
        _same(st.stage_valid, want.stage_valid[w], "stage_valid")
    if (n_old, n_new) == (2, 1):
        hot_pool = np.stack([np.asarray(s.hot.counts) for s in jstates]).sum(0)
        assert (hot_pool > HOT).any()  # records were demoted, not dropped
        assert int(got[0].cold.counts.sum()) > sum(
            int(np.asarray(s.cold.counts).sum()) for s in jstates) - K * COLD


def test_aux_without_a_policy_is_refused():
    carries = [TrainCarry(None, None, buffer_from_jax(s, "cpu"), None, None)
               for s in _jax_flat(2, "fifo", seed=0)]
    with pytest.raises(ValueError, match="pass the policy"):
        reshard_carry(carries, 1)


def test_scale_carry_grows_and_shrinks_without_losing_a_record():
    """1 -> 2 -> 1 within the aggregate capacity: the multiset of records
    (every leaf's bytes) is the one the carry started with."""
    jstates = _jax_flat(1, "fifo", seed=5)
    start = TrainCarry(None, None, buffer_from_jax(jstates[0], "cpu"), None, None)

    def records(carries):
        out = []
        for c in carries:
            b = c.buffer
            for k in range(K):
                for s in range(int(b.counts[k])):
                    out.append((k,) + tuple(float(v) for v in b.data["x"][k, s]) +
                               (int(b.data["label"][k, s]), int(b.data["task"][k, s])))
        return sorted(out)

    two, seconds = scale_carry([start], 2, policy="fifo")
    assert len(two) == 2 and seconds >= 0.0
    one, _ = scale_carry(two, 1, policy="fifo")
    assert records(two) == records(one) == records([start]) and records([start])


# ---------------------------------------------------------------------------
# Autoscaling (the reference's tests/test_autoscale.py, and its decisions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["square", "ramp", "sine"])
def test_autoscaler_decisions_match_the_reference(pattern):
    ours, theirs = [], []
    for sig_cls, scaler_cls, out in ((TrafficSignal, Autoscaler, ours),
                                     (JTrafficSignal, JAutoscaler, theirs)):
        sig = sig_cls(pattern, period=40, low=1.4, high=3.9)
        scaler = scaler_cls(min_workers=1, max_workers=4, cooldown_steps=5)
        n = 2
        for step in range(160):
            out.append(sig.load(step))
            target = scaler.observe(step, sig.load(step), n)
            if target is not None:
                n = target
        out.append(scaler.events)
    assert ours == theirs and ours[-1]


def test_traffic_signal_pure_and_bounded():
    for pattern in ("square", "ramp", "sine"):
        sig = TrafficSignal(pattern, period=20, low=1.0, high=4.0)
        loads = [sig.load(s) for s in range(60)]
        assert loads == [sig.load(s) for s in range(60)]  # replayable
        assert all(1.0 <= x <= 4.0 for x in loads)
        assert loads[:20] == loads[20:40]  # periodic


def test_square_signal_drives_grow_then_shrink():
    sig = TrafficSignal("square", period=40, low=1.4, high=3.9)
    scaler = Autoscaler(min_workers=2, max_workers=4, cooldown_steps=5)
    n = 2
    for step in range(80):
        target = scaler.observe(step, sig.load(step), n)
        if target is not None:
            n = target
    assert scaler.events[:3] == [(20, 2, 4), (40, 4, 2), (60, 2, 4)]


def test_hysteresis_cooldown_and_anti_thrash():
    scaler = Autoscaler(min_workers=1, max_workers=4)
    assert scaler.observe(0, 0.7, 1) is None and scaler.events == []  # in the band
    scaler = Autoscaler(min_workers=1, max_workers=4, cooldown_steps=10)
    assert scaler.observe(0, 3.6, 1) == 4
    assert scaler.observe(5, 0.5, 4) is None  # inside the cooldown
    assert scaler.observe(10, 0.5, 4) == 1
    scaler = Autoscaler(min_workers=1, max_workers=4, cooldown_steps=0)
    assert scaler.observe(0, 1.7, 4) == 2  # 0.85 on 2 workers: under the up threshold
    assert Autoscaler(cooldown_steps=0).observe(0, 0.1, 1) is None  # at the floor


@pytest.mark.parametrize("kwargs", [dict(upscale_threshold=0.4, downscale_threshold=0.45),
                                    dict(min_workers=0), dict(min_workers=4, max_workers=2)])
def test_autoscaler_validation(kwargs):
    with pytest.raises(ValueError):
        Autoscaler(**kwargs)
    with pytest.raises(ValueError):
        JAutoscaler(**kwargs)


@pytest.mark.parametrize("args", [("sawtooth",), ("square", 1)])
def test_traffic_signal_validation(args):
    with pytest.raises(ValueError):
        TrafficSignal(*args)
