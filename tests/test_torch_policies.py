"""The port's buffer policies (reservoir, fifo, class_balanced, grasp)
against the JAX package's ``repro.buffer.policies``.

Deterministic hooks are held against the JAX policy on the same state (the
JAX state carried across with ``repro_torch.convert.buffer_from_jax``) and
the same ``accept_mask``: FIFO's eviction slots and cursor exactly, GRASP's
eviction order exactly, ``update_aux`` (GRASP's prototypes and distances at
rtol 1e-6: f32 sums in another order) and ``reshard_aux``. With
``num_candidates == b`` every candidate is accepted and neither FIFO nor
GRASP draws, so whole updates (flat and tiered) are held too. The draws of
class_balanced's acceptance and of every sampler come from a
``torch.Generator`` and are held statistically, as the reference's own
tests hold them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.buffer as JB
from repro.buffer import state as jstate
import repro_torch.buffer as TB
from repro_torch.buffer.state import ItemSpec
from repro_torch.convert import buffer_from_jax, tiered_from_jax

POLICY_NAMES = ("reservoir", "fifo", "class_balanced", "grasp")
RTOL = 1e-6  # prototypes and distances: f32 sums in another order


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jspec(d=8, embed=0):
    spec = {"x": jax.ShapeDtypeStruct((d,), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}
    if embed:
        spec["embed"] = jax.ShapeDtypeStruct((embed,), jnp.float32)
    return spec


def _tspec(d=8, embed=0):
    spec = {"x": ItemSpec((d,), torch.float32), "label": ItemSpec((), torch.int32),
            "task": ItemSpec((), torch.int32)}
    if embed:
        spec["embed"] = ItemSpec((embed,), torch.float32)
    return spec


def _batch(step, b=16, d=8, n_classes=4, embed=0, k=2):
    r = np.random.default_rng(step)
    lab = r.integers(0, n_classes, b).astype(np.int32)
    out = {"x": r.normal(size=(b, d)).astype(np.float32), "label": lab,
           "task": (lab % k).astype(np.int32)}
    if embed:
        out["embed"] = r.normal(size=(b, embed)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_aux(port, ref, exact=False):
    if ref == ():
        assert port == ()
        return
    assert set(port) == set(ref)
    for name, want in ref.items():
        got, want = port[name].numpy(), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if exact or got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=name)


def _assert_leaves(port, ref, name=""):
    if isinstance(ref, dict):
        for k, v in ref.items():
            _assert_leaves(port[k], v, f"{name}.{k}")
        return
    np.testing.assert_array_equal(port.numpy().view(np.uint8),
                                  np.asarray(ref).view(np.uint8), err_msg=name)


def _assert_buffer(port, ref):
    _assert_leaves(port.data, dict(ref.data))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(port.seen.numpy(), np.asarray(ref.seen))
    _assert_aux(port.aux, ref.aux)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_has_the_four_policies():
    assert set(POLICY_NAMES) <= set(TB.POLICIES)
    assert TB.resolve_policy(None) is TB.get_policy("reservoir")
    assert TB.resolve_policy("fifo").name == "fifo"
    with pytest.raises(KeyError, match="registered"):
        TB.get_policy("nope")


def test_register_custom_policy():
    class Mine(TB.Policy):
        name = "mine_test"

    TB.register_policy(Mine())
    try:
        assert TB.get_policy("mine_test").name == "mine_test"
    finally:
        del TB.POLICIES["mine_test"]


def test_bufferstate_three_field_construction_still_works():
    s = TB.BufferState({"x": torch.zeros((2, 4, 8))}, torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32))
    assert s.aux == ()


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_init_aux_matches_jax(policy):
    """Every policy's initial aux: names, shapes, dtypes and values."""
    for d, embed in ((8, 0), (8, 5)):
        jb = JB.init_buffer(_jspec(d, embed), 3, 4, policy)
        tb = TB.init_buffer(_tspec(d, embed), 3, 4, policy, device="cpu")
        _assert_aux(tb.aux, jb.aux, exact=True)


def test_feature_field_preferred_by_grasp_policy():
    from repro.buffer.policies import _feature_dim as jfeature_dim
    from repro_torch.buffer.policies import _feature_dim, _features

    items = {"x": torch.ones((4, 100)), TB.FEATURE_FIELD: torch.arange(8.0).reshape(4, 2)}
    assert _features(items).shape == (4, 2)
    spec = {"x": ItemSpec((100,), torch.float32),
            TB.FEATURE_FIELD: ItemSpec((2,), torch.float32)}
    assert _feature_dim(spec) == 2
    assert _feature_dim({"x": ItemSpec((100,), torch.float32)}) == 100
    # without the field: the first float leaf in sorted key order, as the
    # reference's tree_leaves orders a dict
    mixed = {"task": ItemSpec((), torch.int32), "zz": ItemSpec((3,), torch.float32),
             "images": ItemSpec((2, 5), torch.float32)}
    jmixed = {"task": jax.ShapeDtypeStruct((), jnp.int32),
              "zz": jax.ShapeDtypeStruct((3,), jnp.float32),
              "images": jax.ShapeDtypeStruct((2, 5), jnp.float32)}
    assert _feature_dim(mixed) == jfeature_dim(jmixed) == 10


# ---------------------------------------------------------------------------
# Deterministic hooks against the JAX policy
# ---------------------------------------------------------------------------


def _jax_grown(policy, steps, spec_kw, buckets=2, cap=4, c=8, b=16):
    """A JAX buffer after ``steps`` updates under ``policy`` (its own keys)."""
    buf = JB.init_buffer(_jspec(**spec_kw), buckets, cap, policy)
    key = jax.random.PRNGKey(0)
    for s in range(steps):
        bt = _j(_batch(s, b=b, **spec_kw, k=buckets))
        buf = JB.local_update(buf, bt, bt["task"], jax.random.fold_in(key, s), c, policy)
    return buf


@pytest.mark.parametrize("policy", ["fifo", "grasp"])
@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("spec_kw", [dict(d=8), dict(d=8, embed=6)], ids=["x", "embed"])
def test_rows_and_update_aux_match_jax(policy, steps, spec_kw):
    """On the same state and ``accept_mask``: the eviction slots (FIFO's ring,
    GRASP's distance order, every pos < cap fill), the flat rows and counts
    exactly; the new aux (FIFO's cursor exactly, GRASP's prototypes and
    distances at RTOL)."""
    jbuf = _jax_grown(policy, steps, spec_kw)
    tbuf = buffer_from_jax(jbuf, "cpu")
    bt = _batch(100 + steps, **spec_kw)
    accept = np.random.default_rng(steps).random(16) < 0.7
    jflat, jacc, jpos, jslot, jcounts, jseen = jstate.local_update_rows(
        jbuf, jnp.asarray(bt["task"]), jax.random.PRNGKey(1), 8, policy,
        accept_mask=jnp.asarray(accept))
    tflat, tacc, tpos, tslot, tcounts, tseen = TB.local_update_rows(
        tbuf, torch.from_numpy(bt["task"]), _gen(1), 8, policy,
        accept_mask=torch.from_numpy(accept))
    for got, want in ((tflat, jflat), (tpos, jpos), (tcounts, jcounts), (tseen, jseen)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a rejected candidate's slot is never used (its row is dropped)
    np.testing.assert_array_equal(tslot.numpy()[accept], np.asarray(jslot)[accept])
    pol, jpol = TB.get_policy(policy), JB.get_policy(policy)
    got = pol.update_aux(tbuf, _t(bt), torch.from_numpy(bt["task"]), tacc, tflat, tcounts)
    want = jpol.update_aux(jbuf, _j(bt), jnp.asarray(bt["task"]), jacc, jflat, jcounts)
    _assert_aux(got, want)


def test_grasp_evict_order_matches_jax_with_tied_distances():
    """The eviction order is a stable argsort, as the reference's: tied
    distances (unfilled slots at 1e30, equal records) keep slot order."""
    spec = {"x": ItemSpec((2,), torch.float32), "task": ItemSpec((), torch.int32)}
    jspec = {"x": jax.ShapeDtypeStruct((2,), jnp.float32),
             "task": jax.ShapeDtypeStruct((), jnp.int32)}
    jbuf = JB.init_buffer(jspec, 1, 6, "grasp")
    jbuf = jbuf._replace(counts=jnp.asarray([6], jnp.int32), aux=dict(
        jbuf.aux, dist=jnp.asarray([[1.0, 3.0, 1.0, 3.0, 1e30, 1e30]], jnp.float32)))
    tbuf = buffer_from_jax(jbuf, "cpu")
    labels = np.zeros(6, np.int32)
    pos = np.arange(6, 12, dtype=np.int32)
    rank = np.arange(6, dtype=np.int32)
    want = JB.get_policy("grasp").evict(jbuf, jnp.asarray(labels), jnp.asarray(pos),
                                         jnp.asarray(rank), jax.random.PRNGKey(0))
    got = TB.get_policy("grasp").evict(tbuf, torch.from_numpy(labels).long(),
                                       torch.from_numpy(pos).long(),
                                       torch.from_numpy(rank).long(), _gen(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [4, 5, 1, 3, 0, 2]


def test_grasp_dist_scatter_keeps_the_last_duplicate():
    """More overflow candidates than slots clip onto the last order entry:
    the distance scatter keeps the last duplicate and drops out-of-range
    rows, as the reference's ``mode='drop'`` scatter does."""
    jbuf = _jax_grown("grasp", 2, dict(d=3), buckets=1, cap=2)
    tbuf = buffer_from_jax(jbuf, "cpu")
    bt = _batch(7, b=9, d=3, k=1)
    accept = np.ones(9, bool)
    accept[4] = False
    jflat, jacc, _, _, jcounts, _ = jstate.local_update_rows(
        jbuf, jnp.asarray(bt["task"]), jax.random.PRNGKey(1), 9, "grasp",
        accept_mask=jnp.asarray(accept))
    assert len(set(np.asarray(jflat)[accept].tolist())) < accept.sum()  # duplicates
    want = JB.get_policy("grasp").update_aux(jbuf, _j(bt), jnp.asarray(bt["task"]), jacc,
                                              jflat, jcounts)
    got = TB.get_policy("grasp").update_aux(
        tbuf, _t(bt), torch.from_numpy(bt["task"]), torch.from_numpy(accept),
        torch.from_numpy(np.array(jflat)), torch.from_numpy(np.array(jcounts)))
    _assert_aux(got, want)


@pytest.mark.parametrize("policy", ["fifo", "grasp"])
def test_full_acceptance_updates_match_jax(policy):
    """With c == b every candidate enters and FIFO and GRASP draw nothing:
    five whole ``local_update`` calls give the reference's buffer bit for
    bit (record bytes, counts, seen, cursor) and its GRASP aux at RTOL. The
    port state is carried across from the reference's before every step."""
    jbuf = JB.init_buffer(_jspec(embed=4), 2, 4, policy)
    key = jax.random.PRNGKey(0)
    for s in range(5):
        bt = _batch(s, b=8, embed=4)
        tbuf = buffer_from_jax(jbuf, "cpu")
        tbuf = TB.local_update(tbuf, _t(bt), torch.from_numpy(bt["task"]), _gen(s), 8,
                               policy)
        jbuf = JB.local_update(jbuf, _j(bt), jnp.asarray(bt["task"]),
                               jax.random.fold_in(key, s), 8, policy)
        _assert_buffer(tbuf, jbuf)
    assert int(jbuf.counts.sum()) == 8


@pytest.mark.parametrize("policy", ["fifo", "grasp"])
def test_full_acceptance_tiered_updates_match_jax(policy):
    """The tiered store's hot tier runs the policy with its aux: with c == b
    and a cold tier that never fills, ``tiered_update`` draws nothing, and
    four steps give the reference's hot tier (bytes and aux), stage and
    int8 cold tier."""
    from repro.buffer import tiered as JT
    from repro_torch.buffer import tiered as TT

    jst = JT.init_tiered(_jspec(embed=4), 2, 2, 16, 8, policy)
    key = jax.random.PRNGKey(0)
    for s in range(4):
        bt = _batch(s, b=6, embed=4)
        tst = tiered_from_jax(jst, "cpu")
        tst = TT.tiered_update(tst, _t(bt), torch.from_numpy(bt["task"]), _gen(s), 6,
                               policy)
        jst = JT.tiered_update(jst, _j(bt), jnp.asarray(bt["task"]),
                               jax.random.fold_in(key, s), 6, policy)
        _assert_buffer(tst.hot, jst.hot)
        _assert_buffer(tst.cold, jst.cold)
        for name, leaf in jst.stage.items():
            np.testing.assert_array_equal(tst.stage[name].numpy(), np.asarray(leaf))
        np.testing.assert_array_equal(tst.stage_valid.numpy(), np.asarray(jst.stage_valid))
    assert int(jst.cold.counts.sum()) > 0


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_reshard_aux_matches_jax(policy):
    """``reshard_aux`` on compacted data and counts: FIFO's cursor (counts %
    cap) exactly, GRASP's recomputed prototypes and distances at RTOL, ()
    for the stateless policies."""
    rng = np.random.default_rng(3)
    data = {"x": rng.normal(size=(3, 5, 4)).astype(np.float32),
            "task": np.zeros((3, 5), np.int32)}
    counts = np.asarray([0, 3, 5], np.int32)
    want = JB.get_policy(policy).reshard_aux(_j(data), jnp.asarray(counts))
    got = TB.get_policy(policy).reshard_aux(_t(data), torch.from_numpy(counts))
    _assert_aux(got, want)


def test_fifo_reshard_resumes_the_ring_at_the_first_empty_slot():
    """After a reshard the cursor is counts % cap, so the next insert lands in
    the first empty slot (a stale cursor would skip it)."""
    spec = {"v": ItemSpec((), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 8, "fifo", device="cpu")
    for s in range(6):
        items = {"v": torch.tensor([float(s + 1)]), "task": torch.zeros(1, dtype=torch.int32)}
        buf = TB.local_update(buf, items, items["task"], _gen(s), 1, "fifo")
    counts = torch.tensor([3], dtype=torch.int32)  # compacted to 3 records
    buf = buf._replace(counts=counts,
                       aux=TB.get_policy("fifo").reshard_aux(buf.data, counts))
    assert buf.aux["cursor"].tolist() == [3]
    items = {"v": torch.tensor([99.0]), "task": torch.zeros(1, dtype=torch.int32)}
    buf = TB.local_update(buf, items, items["task"], _gen(9), 1, "fifo")
    assert float(buf.data["v"][0, 3]) == 99.0


def test_grasp_reshard_recomputes_distances():
    spec = {"x": ItemSpec((4,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 4, "grasp", device="cpu")
    items = {"x": torch.ones((3, 4)), "task": torch.zeros(3, dtype=torch.int32)}
    buf = TB.local_update(buf, items, items["task"], _gen(0), 3, "grasp")
    aux = TB.get_policy("grasp").reshard_aux(buf.data, buf.counts)
    assert (aux["dist"][0, :3] < 1e29).all() and (aux["dist"][0, 3:] > 1e29).all()


# ---------------------------------------------------------------------------
# Per-policy semantics, with the port's own draws (the reference's tests)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_capacity_and_sampling_invariants(policy):
    """Every policy: counts <= cap, samples come from filled slots."""
    buf = TB.init_buffer(_tspec(4), 2, 4, policy, device="cpu")
    for s in range(6):
        bt = _t(_batch(s, d=4))
        buf = TB.local_update(buf, bt, bt["task"], _gen(s), 8, policy)
    assert (buf.counts <= 4).all()
    reps, valid = TB.local_sample(buf, _gen(100), 6, policy)
    assert reps["x"].shape == (6, 4)
    assert bool(valid.all())
    assert set(reps["task"].tolist()) <= {0, 1}


def test_fifo_overwrites_oldest():
    """A full FIFO bucket evicts in arrival order (ring semantics)."""
    spec = {"v": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 3, "fifo", device="cpu")
    for s in range(5):
        items = {"v": torch.tensor([s], dtype=torch.int32),
                 "task": torch.zeros(1, dtype=torch.int32)}
        buf = TB.local_update(buf, items, items["task"], _gen(s), 1, "fifo")
    assert sorted(buf.data["v"][0].tolist()) == [2, 3, 4]
    assert int(buf.aux["cursor"][0]) == 5 % 3


def test_class_balanced_acceptance_boosts_underfilled_buckets():
    """Acceptance probability clip(c/b * (1 + mean fill) / (1 + fill)): the
    reference's formula, held on 4000 draws per bucket (3 sigma < 0.025)."""
    spec = {"v": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 2, 16, "class_balanced", device="cpu")
    buf = buf._replace(counts=torch.tensor([14, 2], dtype=torch.int32))
    pol, b, c = TB.get_policy("class_balanced"), 4000, 1000
    for bucket, fill in ((0, 14), (1, 2)):
        labels = torch.full((b,), bucket, dtype=torch.long)
        rate = pol.select_candidates(buf, labels, _gen(bucket), c).float().mean().item()
        want = min(1.0, (c / b) * (1 + 8.0) / (1 + fill))
        assert abs(rate - want) < 0.025, (bucket, rate, want)


def test_class_balanced_sampling_balances_skewed_fill():
    """With one bucket 8x fuller than the other, balanced sampling replays
    both at comparable rates (uniform-over-filled would be about 8:1)."""
    spec = {"v": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 2, 16, "class_balanced", device="cpu")
    buf = buf._replace(counts=torch.tensor([16, 2], dtype=torch.int32),
                       data={"v": buf.data["v"],
                             "task": torch.arange(2, dtype=torch.int32)[:, None].expand(2, 16)
                             .contiguous()})
    hits = np.zeros(2)
    for t in range(60):
        reps, valid = TB.local_sample(buf, _gen(t), 8, "class_balanced")
        assert bool(valid.all())
        for b_ in reps["task"].tolist():
            hits[b_] += 1
    assert 0.5 < hits[0] / hits[1] < 2.0, hits
    # and within a bucket only its filled slots are drawn
    flat, _ = TB.local_sample_rows(buf, _gen(0), 400, "class_balanced")
    slots = (flat % 16)[flat // 16 == 1]
    assert set(slots.tolist()) == {0, 1}


def test_grasp_evicts_least_prototypical():
    """A full GRASP bucket displaces the record farthest from the class
    prototype: an injected outlier goes before the cluster."""
    spec = {"x": ItemSpec((4,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 4, "grasp", device="cpu")
    cluster = [[1.0] * 4, [1.1] * 4, [0.9] * 4, [100.0] * 4]
    items = {"x": torch.tensor(cluster), "task": torch.zeros(4, dtype=torch.int32)}
    buf = TB.local_update(buf, items, items["task"], _gen(0), 4, "grasp")
    assert int(buf.counts[0]) == 4
    items2 = {"x": torch.tensor([[1.05] * 4]), "task": torch.zeros(1, dtype=torch.int32)}
    buf = TB.local_update(buf, items2, items2["task"], _gen(1), 1, "grasp")
    assert buf.data["x"][0].max() < 50.0


def test_grasp_sampling_prefers_prototypical():
    spec = {"x": ItemSpec((4,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 8, "grasp", device="cpu")
    vals = [[1.0] * 4] * 6 + [[30.0] * 4, [40.0] * 4]
    items = {"x": torch.tensor(vals), "task": torch.zeros(8, dtype=torch.int32)}
    buf = TB.local_update(buf, items, items["task"], _gen(0), 8, "grasp")
    far = 0
    for t in range(50):
        reps, _ = TB.local_sample(buf, _gen(t), 2, "grasp")
        far += int((reps["x"][:, 0] > 10).sum())
    # outliers are 2/8 of the buffer; distance-ordered replay draws them
    # well below the 25% a uniform sampler would
    assert far / (50 * 2) < 0.20, far


def test_grasp_sampling_is_without_replacement():
    spec = {"x": ItemSpec((2,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 2, 4, "grasp", device="cpu")
    items = {"x": torch.randn(8, 2, generator=_gen(0)),
             "task": torch.tensor([0, 1] * 4, dtype=torch.int32)}
    buf = TB.local_update(buf, items, items["task"], _gen(0), 8, "grasp")
    for t in range(10):
        flat, valid = TB.local_sample_rows(buf, _gen(t), 8, "grasp")
        assert sorted(flat.tolist()) == list(range(8)) and bool(valid.all())


def test_grasp_partial_fill_marks_surplus_draws_invalid():
    spec = {"x": ItemSpec((4,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 2, 8, "grasp", device="cpu")
    items = {"x": torch.ones((4, 4)), "task": torch.tensor([0, 0, 1, 1], dtype=torch.int32)}
    buf = TB.local_update(buf, items, items["task"], _gen(0), 4, "grasp")
    assert int(buf.counts.sum()) == 4
    reps, valid = TB.local_sample(buf, _gen(1), 8, "grasp")
    assert int(valid.sum()) == 4
    assert bool((reps["x"][valid] == 1.0).all())
    reps, valid = TB.local_sample(buf, _gen(2), 40, "grasp")  # n > 2 * K * cap
    assert reps["x"].shape == (40, 4) and valid.shape == (40,)


def test_grasp_same_batch_evictions_hit_distinct_slots():
    spec = {"x": ItemSpec((2,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 4, "grasp", device="cpu")
    fill = {"x": torch.ones((4, 2)), "task": torch.zeros(4, dtype=torch.int32)}
    buf = TB.local_update(buf, fill, fill["task"], _gen(0), 4, "grasp")
    burst = {"x": torch.full((3, 2), 2.0), "task": torch.zeros(3, dtype=torch.int32)}
    buf = TB.local_update(buf, burst, burst["task"], _gen(1), 3, "grasp")
    assert int((buf.data["x"][0, :, 0] == 2.0).sum()) == 3


def test_plan_update_sample_samples_from_the_updated_aux():
    """GRASP's sample reads this step's distances: the plan updates the aux
    before it draws, so a record pushed into an empty buffer is sampled in
    the same step (with the pre-update aux every slot would still be at the
    1e30 sentinel and score as unfilled-but-valid noise)."""
    spec = {"x": ItemSpec((2,), torch.float32), "task": ItemSpec((), torch.int32)}
    buf = TB.init_buffer(spec, 1, 8, "grasp", device="cpu")
    items = {"x": torch.tensor([[0.0, 0.0], [0.1, 0.0], [50.0, 50.0]]),
             "task": torch.zeros(3, dtype=torch.int32)}
    rows = TB.plan_update_sample(buf, items["task"], _gen(0), 3, 2, "grasp", items)
    assert rows.new_aux["dist"][0, :3].max() < 1e29
    assert bool(rows.samp_valid.all())
    assert set(rows.samp_rows.tolist()) <= {0, 1, 2}
    new, reps, valid = TB.local_update_sample(buf, items, rows)
    assert new.aux is rows.new_aux
    with pytest.raises(ValueError, match="items"):
        TB.plan_update_sample(buf, items["task"], _gen(0), 3, 2, "grasp")
