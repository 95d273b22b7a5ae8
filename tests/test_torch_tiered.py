"""The port's tiered rehearsal store against the JAX package.

Parity: a JAX ``TieredState`` and the port's evolve side by side, the JAX row
vectors of every step (flush, push, stage packing, both samples and the tier
mix, under the keys ``tiered_update`` / ``tiered_sample`` use) fed to the
port through the ``rows`` seam (``TieredRows``), with the fused kernels and
without. Every leaf, the int8 cold payloads and their scales included, and
every sampled batch must match bit for bit: the cold tier's arithmetic is
the jitted reference's, and everything else is copied bytes.

The port's own generator draws are held to the reference's properties
(``tests/test_tiered.py``): one-step-stale batched demotion, the int8 round
trip, capacity beyond the hot tier, bounded staging, fused == unfused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.buffer import state as jstate
from repro.buffer import tiered as jtiered
from repro.configs import resnet50_cl as jcfgs
from repro.configs.base import RehearsalConfig as JRehearsal
from repro.configs.base import TrainConfig as JTrain
from repro.data import ClassIncrementalImages as JImages
from repro.data import ImageStreamConfig as JStreamCfg
from repro.models import model_zoo as jzoo
from repro.models import resnet as jresnet
from repro.optim import make_optimizer as jmake_optimizer
from repro.strategy import init_carry as jinit_carry
from repro.strategy import make_cl_step as jmake_cl_step
from repro_torch.buffer import api as tapi
from repro_torch.buffer import tiered as T
from repro_torch.buffer.state import BufferState, ItemSpec, UpdateSampleRows
from repro_torch.configs import resnet50_cl as tcfgs
from repro_torch.configs.base import RehearsalConfig, TrainConfig
from repro_torch.convert import (cnn_params_from_jax, named_from_tree, opt_state_from_jax,
                                 tiered_from_jax)
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import resnet as tresnet
from repro_torch.optim import make_optimizer
from repro_torch.strategy import (PipelinedRehearsalCarry, TrainCarry, init_carry,
                                  make_cl_step)


def _jspec(d=8):
    return {"x": jax.ShapeDtypeStruct((d,), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}


def _tspec(d=8):
    return {"x": ItemSpec((d,), torch.float32), "label": ItemSpec((), torch.int32),
            "task": ItemSpec((), torch.int32)}


def _batch(step, b=16, d=8, n_buckets=2):
    rng = np.random.default_rng(step)
    lab = rng.integers(0, 2 * n_buckets, b).astype(np.int32)
    return {"x": (rng.normal(size=(b, d)) * 3).astype(np.float32), "label": lab,
            "task": lab % n_buckets}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _state_leaves(st):
    """(name, array) of every leaf of a JAX or port TieredState."""
    for part in ("hot", "cold"):
        buf = getattr(st, part)
        yield from _leaves({f"{part}.data": buf.data, f"{part}.counts": buf.counts,
                            f"{part}.seen": buf.seen})
    yield from _leaves({"stage": st.stage, "stage_labels": st.stage_labels,
                        "stage_valid": st.stage_valid})


def _assert_bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=what)


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy; bf16 as JAX's numpy bf16 (numpy has none)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _assert_states(port: T.TieredState, ref):
    want = dict(_state_leaves(ref))
    got = dict(_state_leaves(port))
    assert got.keys() == want.keys()
    for name, leaf in want.items():
        _assert_bits(_np(got[name]), leaf, name)


def jax_tiered_rows(js, labels, key_up, key_samp, c: int, n: int) -> T.TieredRows:
    """The row vectors JAX's ``tiered_update(key_up)`` then
    ``tiered_sample(key_samp, n)`` use, as a port ``TieredRows``."""
    k_hot, k_flush = jax.random.split(key_up)
    stage_n = js.stage_labels.shape[0]
    c_flat, _, _, _, c_counts, c_seen = jstate.local_update_rows(
        js.cold, js.stage_labels, k_flush, stage_n, accept_mask=js.stage_valid)
    h_flat, accept, pos, slot, h_counts, h_seen = jstate.local_update_rows(
        js.hot, labels, k_hot, c)
    cap = jstate.buffer_dims(js.hot)[1]
    evicted_valid = accept & (pos >= cap) & (slot < js.hot.counts[labels])
    src, stage_labels, stage_valid = jtiered._pack_stage(
        {"row": h_flat}, labels, evicted_valid, stage_n)
    k_h, k_c, k_m = jax.random.split(key_samp, 3)
    h_samp, h_valid = jstate.local_sample_rows(js.hot._replace(counts=h_counts), k_h, n)
    c_samp, c_valid = jstate.local_sample_rows(js.cold._replace(counts=c_counts), k_c, n)
    hot_total, cold_total = jnp.sum(h_counts), jnp.sum(c_counts)
    p_hot = hot_total.astype(jnp.float32) / jnp.maximum(
        hot_total + cold_total, 1).astype(jnp.float32)
    use_hot = jax.random.uniform(k_m, (n,)) < p_hot
    use_hot = jnp.where(cold_total == 0, True, jnp.where(hot_total == 0, False, use_hot))

    def t(a):
        return torch.from_numpy(np.array(a))

    return T.TieredRows(
        UpdateSampleRows(*map(t, (c_flat, c_counts, c_seen, c_samp, c_valid))),
        UpdateSampleRows(*map(t, (h_flat, h_counts, h_seen, h_samp, h_valid))),
        t(src["row"]), t(stage_labels), t(stage_valid), t(use_hot))


# ---------------------------------------------------------------------------
# parity with the JAX package through the rows seam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("k,hot,cold,stage,b,steps,seed", [
    (2, 2, 4, 3, 8, 8, 0),  # stage overflow, cold duplicates
    (3, 3, 6, 6, 5, 10, 1),
    (4, 2, 9, 7, 4, 8, 2),
    (2, 4, 3, 4, 8, 9, 3),  # cold tier smaller than the stage
])
def test_tiered_step_matches_jax_bit_for_bit(fused, k, hot, cold, stage, b, steps, seed):
    """Every leaf of the evolving state, every sample and its validity:
    JAX ``tiered_update`` + ``tiered_sample`` (fused or not) against the
    port's ``tiered_update_sample`` fed the JAX rows."""
    js = jtiered.init_tiered(_jspec(), k, hot, cold, stage)
    ts = T.init_tiered(_tspec(), k, hot, cold, stage, device="cpu")
    for i in range(steps):
        batch = _batch(100 * seed + i, b, n_buckets=k)
        jitems = {name: jnp.asarray(v) for name, v in batch.items()}
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        key_up, key_samp = jax.random.split(key)
        rows = jax_tiered_rows(js, jitems["task"], key_up, key_samp, b, 4)
        js = jtiered.tiered_update(js, jitems, jitems["task"], key_up, b, fused=fused)
        jreps, jvalid = jtiered.tiered_sample(js, key_samp, 4, fused=fused)
        ts, treps, tvalid = T.tiered_update_sample(ts, _torch(batch), rows, fused=fused)
        _assert_states(ts, js)
        _assert_bits(tvalid.numpy(), jvalid, "valid")
        for name, leaf in jreps.items():
            _assert_bits(treps[name].numpy(), leaf, name)
    assert int(ts.cold.counts.sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_step_dequantizes_in_the_update_sample_launch(monkeypatch, dtype):
    """The unfused tiered step, bit for bit against the JAX package through
    the rows seam as above, with counters patched on the CPU path: its cold
    pass calls ``rehearsal_update_sample_leaves`` once a step with the float
    field's int8 leaf dequantized on the gather, and ``dequantize_rows``
    never (the reference's third launch is folded into the second)."""
    from repro_torch.core import compression

    calls = {"dequantize_rows": 0, "leaves": 0, "folded": 0}
    leaves, dequantize = compression.rehearsal_update_sample_leaves, compression.dequantize_rows

    def count_leaves(*args, **kw):
        calls["leaves"] += 1
        calls["folded"] += bool(args[4] if len(args) > 4 else kw.get("dequant"))
        return leaves(*args, **kw)

    def count_dequantize(*args, **kw):
        calls["dequantize_rows"] += 1
        return dequantize(*args, **kw)

    monkeypatch.setattr(compression, "rehearsal_update_sample_leaves", count_leaves)
    monkeypatch.setattr(compression, "dequantize_rows", count_dequantize)
    jspec = dict(_jspec(), x=jax.ShapeDtypeStruct((8,), jnp.dtype(dtype)))
    tspec = dict(_tspec(), x=ItemSpec((8,), getattr(torch, dtype)))
    k, hot, cold, stage, b, steps = 2, 2, 4, 3, 8, 8
    js = jtiered.init_tiered(jspec, k, hot, cold, stage)
    ts = T.init_tiered(tspec, k, hot, cold, stage, device="cpu")
    for i in range(steps):
        batch = _batch(700 + i, b, n_buckets=k)
        jitems = {name: jnp.asarray(v) for name, v in batch.items()}
        jitems["x"] = jitems["x"].astype(dtype)
        items = dict(_torch(batch), x=torch.from_numpy(batch["x"]).to(getattr(torch, dtype)))
        key_up, key_samp = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), i))
        rows = jax_tiered_rows(js, jitems["task"], key_up, key_samp, b, 4)
        js = jtiered.tiered_update(js, jitems, jitems["task"], key_up, b)
        jreps, jvalid = jtiered.tiered_sample(js, key_samp, 4)
        ts, treps, tvalid = T.tiered_update_sample(ts, items, rows)
        _assert_states(ts, js)
        _assert_bits(tvalid.numpy(), jvalid, "valid")
        for name, leaf in jreps.items():
            _assert_bits(_np(treps[name]), leaf, name)
    assert int(ts.cold.counts.sum()) > 0
    assert calls == {"dequantize_rows": 0, "leaves": steps, "folded": steps}


def test_empty_stage_flush_is_identity_fused_and_not():
    """The step-0 flush (all-invalid stage) leaves the cold tier untouched."""
    for fused in (False, True):
        s0 = T.init_tiered(_tspec(), 2, 3, 6, 4, device="cpu")
        before = {n: v.clone() for n, v in _leaves(s0.cold.data)}
        f = T.tiered_flush(s0, _gen(0), fused=fused)
        for name, leaf in _leaves(f.cold.data):
            assert torch.equal(leaf, before[name])
        assert int(f.cold.counts.sum()) == 0


def test_tiered_from_jax_roundtrip():
    js = jtiered.init_tiered(_jspec(), 2, 2, 4, 4)
    for i in range(4):
        batch = {n: jnp.asarray(v) for n, v in _batch(i, 8).items()}
        js = jtiered.tiered_update(js, batch, batch["task"], jax.random.PRNGKey(i), 8)
    assert int(jnp.sum(js.cold.counts)) > 0
    ts = tiered_from_jax(js, "cpu")
    _assert_states(ts, js)
    assert T.resolve_cold_placement("cpu") == "device"
    assert T.resolve_cold_placement("cuda") == "pinned_host"


# ---------------------------------------------------------------------------
# the port's own draws: properties of tests/test_tiered.py
# ---------------------------------------------------------------------------


def test_init_shapes_and_config_resolution():
    st = T.init_tiered(_tspec(), num_buckets=2, hot_slots=4, cold_slots=12, stage_rows=8,
                       device="cpu")
    assert T.tiered_dims(st) == (2, 4, 12)
    assert st.hot.data["x"].shape == (2, 4, 8)
    assert st.cold.data["x"]["q"].shape == (2, 12, 8)
    assert st.cold.data["x"]["q"].dtype == torch.int8
    assert st.cold.data["x"]["scale"].shape == (2, 12, 1)
    assert st.cold.data["label"]["raw"].shape == (2, 12)
    assert st.stage["x"].shape == (8, 8)
    assert T.record_spec_of(st) == _tspec()

    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, tiering="host",
                           cold_slots=0, num_candidates=5)
    assert rcfg.tiered and not rcfg.fused_kernels
    assert (rcfg.resolved_hot_slots, rcfg.resolved_cold_slots,
            rcfg.resolved_demote_stage, rcfg.total_slots_per_bucket) == (4, 12, 10, 16)
    assert RehearsalConfig(slots_per_bucket=4).total_slots_per_bucket == 4
    st2 = tapi.init_from_config(_tspec(), rcfg, "cpu")
    assert isinstance(st2, T.TieredState) and T.tiered_dims(st2) == (2, 4, 12)
    assert isinstance(tapi.init_from_config(_tspec(), RehearsalConfig(), "cpu"), BufferState)
    for field in ("hot_slots", "cold_slots", "demote_stage", "fused_kernels"):
        assert getattr(rcfg, field) == getattr(JRehearsal(
            num_buckets=2, slots_per_bucket=4, tiering="host", num_candidates=5), field)


def test_demotion_is_one_step_stale_and_batched():
    """Records evicted from the hot tier at step t reach the cold tier only
    with step t+1's flush."""
    st = T.init_tiered(_tspec(), 2, hot_slots=2, cold_slots=16, stage_rows=16, device="cpu")
    gen = _gen(0)
    bt = _torch(_batch(0))
    # c == b: all 16 accepted, the 2x2 hot tier overflows within the batch only
    st = T.tiered_update(st, bt, bt["task"], gen, 16)
    assert int(st.hot.counts.sum()) == 4
    assert int(st.stage_valid.sum()) == 0 and int(st.cold.counts.sum()) == 0
    bt1 = _torch(_batch(1))
    st = T.tiered_update(st, bt1, bt1["task"], gen, 16)
    staged = int(st.stage_valid.sum())
    assert staged > 0 and int(st.cold.counts.sum()) == 0  # staged, not flushed yet
    bt2 = _torch(_batch(2))
    st = T.tiered_update(st, bt2, bt2["task"], gen, 16)
    assert int(st.cold.counts.sum()) == staged


def test_evicted_records_are_the_pre_batch_occupants():
    """local_update_with_evicted reports what each displacing candidate
    overwrote, as it was before the batch."""
    from repro_torch.buffer import state as tstate

    spec = {"v": ItemSpec((), torch.float32)}
    buf = tstate.init_buffer(spec, 1, 2, device="cpu")
    labels = torch.zeros(2, dtype=torch.int32)
    buf = tstate.local_update(buf, {"v": torch.tensor([1.0, 2.0])}, labels, _gen(0), 2)
    old = buf.data["v"].clone()
    new, evicted, valid = tstate.local_update_with_evicted(
        buf, {"v": torch.tensor([3.0, 4.0, 5.0])}, torch.zeros(3, dtype=torch.int32),
        _gen(1), 3)
    assert bool(valid.all())  # bucket full: every accepted candidate displaces
    assert set(evicted["v"].tolist()) <= set(old[0].tolist())
    assert set(new.data["v"][0].tolist()) <= {1.0, 2.0, 3.0, 4.0, 5.0}


def test_cold_records_roundtrip_quantized():
    spec = {"x": ItemSpec((16,), torch.float32), "task": ItemSpec((), torch.int32)}
    st = T.init_tiered(spec, 1, hot_slots=1, cold_slots=32, stage_rows=8, device="cpu")
    gen = _gen(0)
    rows = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 16)).astype(np.float32))
    for s in range(6):
        items = {"x": rows[s % 4][None], "task": torch.zeros((1,), dtype=torch.int32)}
        st = T.tiered_update(st, items, items["task"], gen, 1)
    assert int(st.cold.counts.sum()) >= 3
    got, valid = T.tiered_sample(st, _gen(1), 16)
    assert bool(valid.all())
    for row in got["x"]:
        assert float((rows - row[None]).abs().amax(dim=1).min()) < 0.05


def test_capacity_exceeds_hot_tier():
    spec = {"v": ItemSpec((), torch.float32), "task": ItemSpec((), torch.int32)}
    st = T.init_tiered(spec, 1, hot_slots=2, cold_slots=16, stage_rows=8, device="cpu")
    gen = _gen(0)
    for s in range(12):
        items = {"v": torch.tensor([float(s + 1)]), "task": torch.zeros((1,), dtype=torch.int32)}
        st = T.tiered_update(st, items, items["task"], gen, 1)
    assert int(T.tiered_fill(st)) > 2
    seen = set()
    for t in range(40):
        got, valid = T.tiered_sample(st, _gen(100 + t), 4)
        assert bool(valid.all())
        seen |= {round(float(v)) for v in got["v"]}
    assert len(seen) > 2, seen


def test_stage_overflow_drops_excess():
    st = T.init_tiered(_tspec(), 2, hot_slots=1, cold_slots=4, stage_rows=2, device="cpu")
    gen = _gen(0)
    for s in range(3):
        bt = _torch(_batch(s))
        st = T.tiered_update(st, bt, bt["task"], gen, 16)
    assert int(st.stage_valid.sum()) <= 2
    assert (st.cold.counts <= 4).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_and_move_equals_update_then_sample(seed):
    """With one generator, ``plan_tiered`` + ``tiered_update_sample`` (the
    step's form: shared launches) == ``tiered_update`` then ``tiered_sample``:
    the draw order flush, push, hot sample, cold sample, mix."""
    for fused in (False, True):
        a = T.init_tiered(_tspec(), 2, 2, 5, 4, device="cpu")
        b = T.init_tiered(_tspec(), 2, 2, 5, 4, device="cpu")
        ga, gb = _gen(seed), _gen(seed)
        for i in range(6):
            bt = _torch(_batch(10 * seed + i, 6))
            rows = T.plan_tiered(a, bt["task"], ga, 6, 3)
            a, reps_a, valid_a = T.tiered_update_sample(a, bt, rows, fused=fused)
            b = T.tiered_update(b, bt, bt["task"], gb, 6, fused=fused)
            reps_b, valid_b = T.tiered_sample(b, gb, 3, fused=fused)
            assert torch.equal(valid_a, valid_b)
            for name in reps_a:
                assert torch.equal(reps_a[name], reps_b[name])
            for (na, la), (nb, lb) in zip(_state_leaves(a), _state_leaves(b)):
                assert na == nb and torch.equal(la, lb), na


def test_fused_dispatch_via_buffer_api():
    """``fused_kernels`` routes the api to the fused kernels, same results."""
    kw = dict(num_buckets=2, slots_per_bucket=4, tiering="host", hot_slots=3,
              cold_slots=6, num_candidates=5)
    rcfg_off, rcfg_on = RehearsalConfig(**kw), RehearsalConfig(fused_kernels=True, **kw)
    s_off = tapi.init_from_config(_tspec(), rcfg_off, "cpu")
    s_on = tapi.init_from_config(_tspec(), rcfg_on, "cpu")
    g_off, g_on = _gen(3), _gen(3)
    for i in range(8):
        bt = _torch(_batch(i, 5))
        s_off, r_off, v_off = tapi.buffer_update_sample(
            s_off, bt, tapi.plan_update_and_sample(s_off, bt["task"], g_off, 4, rcfg_off),
            rcfg_off)
        s_on, r_on, v_on = tapi.buffer_update_sample(
            s_on, bt, tapi.plan_update_and_sample(s_on, bt["task"], g_on, 4, rcfg_on), rcfg_on)
        assert torch.equal(v_off, v_on)
        for name in r_off:
            assert torch.equal(r_off[name], r_on[name])
    for (na, la), (_, lb) in zip(_state_leaves(s_off), _state_leaves(s_on)):
        assert torch.equal(la, lb), na
    assert int(s_on.cold.counts.sum()) > 0
    assert float(tapi.buffer_fill(s_on)) == float(T.tiered_fill(s_off)) > 2 * 3
    got, valid = tapi.buffer_sample(s_on, _gen(5), 4, rcfg_on)
    want, valid_off = tapi.buffer_sample(s_off, _gen(5), 4, rcfg_off)
    assert torch.equal(valid, valid_off) and torch.equal(got["x"], want["x"])


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(8, 4))


def _ce(model, b):
    logits = b["x"] @ model.w
    mask = (b["label"] >= 0).float()
    ce = torch.nn.functional.cross_entropy(logits, b["label"].long().clamp(min=0),
                                           reduction="none")
    return (ce * mask).sum() / mask.sum().clamp(min=1.0), {}


def _sgd(grads, opt, params):
    with torch.no_grad():
        for name, p in params.items():
            p -= 0.1 * grads[name]
    return params, opt, {}


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_tiered_cl_step_end_to_end(pipelined):
    """Cold capacity > hot capacity trains end to end through make_cl_step,
    and the buffer grows past what the hot tier holds."""
    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=4,
                           num_candidates=8, mode="sync", pipelined=pipelined,
                           tiering="host", hot_slots=4, cold_slots=16, label_field="label")
    step = make_cl_step(_ce, _sgd, rcfg, exchange="local", device="cpu")
    carry = init_carry(_Linear(), None, _tspec(), rcfg, device="cpu")
    for s in range(25):
        carry, m = step(carry, _batch(s), s)
        assert np.isfinite(float(m["loss"])), s
    assert isinstance(carry.buffer, T.TieredState)
    assert float(m["buffer_fill"]) > 2 * 4
    assert int(carry.buffer.cold.counts.sum()) > 0


# ---------------------------------------------------------------------------
# the whole slice: the tiered train step against the JAX make_cl_step
# ---------------------------------------------------------------------------

JCFG = jcfgs.CNNConfig("t", "resnet18", num_classes=8, width=4, stage_blocks=(1, 1),
                       bottleneck=False, image_size=8)
TCFG = tcfgs.CNNConfig("t", "resnet18", num_classes=8, width=4, stage_blocks=(1, 1),
                       bottleneck=False, image_size=8)
STREAM = dict(num_tasks=2, classes_per_task=4, image_size=8)
RCFG = dict(num_buckets=2, slots_per_bucket=4, num_representatives=3, num_candidates=6,
            label_field="label", task_field="task", tiering="host", hot_slots=2,
            cold_slots=4, demote_stage=4)
RECIPE = dict(peak_lr=0.1, warmup_steps=1)
STEP_B, STEPS = 8, 4


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + 1e-7


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_tiered_port_step_matches_jax_make_cl_step(pipelined, fused):
    """Four steps of the tiered train step from the same carry on the same
    batches, the JAX issue half's rows fed through the seam: the tiered
    buffer, the pending slot, ``buffer_fill`` and ``rep_checksum`` exactly;
    loss and parameters at rtol 1e-4 of the largest value (f32 convolutions
    in another order, four SGD steps compounding them)."""
    jrcfg = JRehearsal(mode="sync", pipelined=pipelined, fused_kernels=fused, **RCFG)
    spec = {"images": jax.ShapeDtypeStruct((8, 8, 3), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}

    def jloss(p, batch):
        logits = jresnet.apply_cnn(p, batch["images"], JCFG)
        return jzoo.cross_entropy(logits[:, None, :], batch["label"][:, None]), {}

    def tloss(model, batch):
        logits = tresnet.apply_cnn(model, batch["images"])
        return tzoo.cross_entropy(logits[:, None, :], batch["label"][:, None]), {}

    jinit, jupdate = jmake_optimizer(JTrain(**RECIPE))
    params = jax.jit(lambda k: jresnet.init_cnn(k, JCFG))(jax.random.PRNGKey(0))
    jstep = jmake_cl_step(jloss, jupdate, jrcfg, strategy="rehearsal", exchange="local",
                          label_field="label", donate=False)
    jc = jinit_carry(params, jinit(params), spec, jrcfg, label_field="label", seed=3)
    tc = TrainCarry(
        cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jc.params), TCFG, "cpu"),
        opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jc.opt), "cpu"),
        tiered_from_jax(jc.buffer, "cpu"),
        PipelinedRehearsalCarry({k: torch.from_numpy(np.array(v))
                                 for k, v in jc.pipe.reps.items()},
                                torch.from_numpy(np.array(jc.pipe.valid)), 3))
    trcfg = RehearsalConfig(mode="sync", pipelined=pipelined, fused_kernels=fused, **RCFG)
    _, tupdate = make_optimizer(TrainConfig(**RECIPE))
    tstep = make_cl_step(tloss, tupdate, trcfg, exchange="local", label_field="label",
                         device="cpu")
    stream = JImages(JStreamCfg(**STREAM))
    for s in range(STEPS):
        batch = stream.batch(int(s >= STEPS // 2), STEP_B, s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        key_up, key_samp = jax.random.split(jax.random.fold_in(jc.pipe.key, 0))
        rows = jax_tiered_rows(jc.buffer, jbatch["task"], key_up, key_samp,
                               jrcfg.num_candidates, jrcfg.num_representatives)
        jc, jm = jstep(jc, jbatch, jax.random.fold_in(jax.random.PRNGKey(0), s))
        tc, tm = tstep(tc, batch, s, rows=rows)
        _close(float(tm["loss"]), float(jm["loss"]))
        assert float(tm["buffer_fill"]) == float(jm["buffer_fill"])
        assert float(tm["rep_checksum"]) == float(jm["rep_checksum"])
        _assert_states(tc.buffer, jc.buffer)
        for name, leaf in jc.pipe.reps.items():
            _assert_bits(tc.pipe.reps[name].numpy(), leaf, name)
        assert tc.pipe.valid.tolist() == np.asarray(jc.pipe.valid).tolist()
    assert float(tm["buffer_fill"]) > 2 * 2  # past the hot tier
    assert int(tc.buffer.cold.counts.sum()) > 0
    want = named_from_tree(jax.tree_util.tree_map(np.asarray, jc.params))
    for name, p in tc.params.named_parameters():
        _close(p.detach().numpy(), want[name])


def test_trainer_tiered_fused_and_unfused_fingerprints_identical():
    """``ContinualTrainer`` with the tiered store on the CPU: the fused and
    unfused runs give identical ``rep_checksum`` / ``buffer_fill`` histories
    (the reference's fused == unfused contract), past the hot tier."""
    from repro_torch.configs.base import RunConfig, ScenarioConfig
    from repro_torch.scenario import ContinualTrainer

    def run(fused):
        cfg = RunConfig(
            model=tcfgs.reduced(num_classes=8),
            rehearsal=RehearsalConfig(slots_per_bucket=4, num_representatives=2,
                                      num_candidates=4, mode="async", tiering="host",
                                      hot_slots=2, cold_slots=8, fused_kernels=fused),
            scenario=ScenarioConfig(num_tasks=2, classes_per_task=4, steps_per_epoch=4,
                                    batch_size=8, image_size=8))
        res = ContinualTrainer(cfg, device="cpu").fit()
        assert np.isfinite(res.losses).all()
        return [(h["rep_checksum"], h["buffer_fill"]) for h in res.history]

    off, on = run(False), run(True)
    assert off == on
    assert max(fill for _, fill in on) > 2 * 2
