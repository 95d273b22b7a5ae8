"""The port's flat rehearsal buffer against the JAX package.

Parity: the JAX ``local_update_rows`` / ``local_sample_rows`` row vectors go
into the port's byte movement (``local_update_sample``), and the buffer
states and samples must match the JAX ``local_update`` / ``local_sample``
bit for bit (bytes are copied, nothing is computed).

The port draws its rows from a ``torch.Generator``, which cannot reproduce
threefry's bits, so its own draws are held to the statistical properties of
``tests/test_rehearsal.py``: the c/b acceptance rate, fill order, capacity,
class balance and uniform sampling over filled slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.buffer import state as jstate
from repro_torch.buffer import api as tapi
from repro_torch.buffer import state as tstate
from repro_torch.buffer.state import ItemSpec, UpdateSampleRows
from repro_torch.configs.base import RehearsalConfig
from repro_torch.convert import buffer_from_jax

K, CAP, B, C, N = 3, 4, 6, 3, 5


def _jspec():
    return {"images": jax.ShapeDtypeStruct((2, 2, 3), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}


def _tspec():
    return {"images": ItemSpec((2, 2, 3), torch.float32),
            "label": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}


def _batch(step, b=B, k=K):
    rng = np.random.default_rng(step)
    return {"images": rng.normal(size=(b, 2, 2, 3)).astype(np.float32),
            "label": rng.integers(0, 100, b).astype(np.int32),
            "task": rng.integers(0, k, b).astype(np.int32)}


def _assert_state(port, ref):
    for name, leaf in ref.data.items():
        np.testing.assert_array_equal(port.data[name].numpy().view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(port.seen.numpy(), np.asarray(ref.seen))


def _rows(jflat, jcounts, jseen, jsamp, jvalid):
    return UpdateSampleRows(*(torch.from_numpy(np.asarray(a).copy())
                              for a in (jflat, jcounts, jseen, jsamp, jvalid)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_byte_movement_matches_jax_update_and_sample(seed):
    """Six pushes (so buckets fill and evict) + a draw after each: the JAX
    rows fed to the port give the JAX states and samples, bit for bit."""
    jbuf = jstate.init_buffer(_jspec(), K, CAP)
    tbuf = tstate.init_buffer(_tspec(), K, CAP, device="cpu")
    key = jax.random.PRNGKey(seed)
    for step in range(6):
        batch = _batch(100 * seed + step)
        jitems = {k: jnp.asarray(v) for k, v in batch.items()}
        k_up, k_samp = jax.random.split(jax.random.fold_in(key, step))
        flat, _, _, _, counts, seen = jstate.local_update_rows(
            jbuf, jitems["task"], k_up, C)
        # parity test: the rows and the full update/sample must see the SAME
        # key, so the deliberate reuse is the point here
        jbuf = jstate.local_update(jbuf, jitems, jitems["task"], k_up, C)  # replint: disable=RPL001
        samp, valid = jstate.local_sample_rows(jbuf, k_samp, N)
        jreps, jvalid = jstate.local_sample(jbuf, k_samp, N)  # replint: disable=RPL001

        titems = {k: torch.from_numpy(v) for k, v in batch.items()}
        tbuf, treps, tvalid = tstate.local_update_sample(
            tbuf, titems, _rows(flat, counts, seen, samp, valid))
        _assert_state(tbuf, jbuf)
        assert tvalid.tolist() == np.asarray(jvalid).tolist()
        for name in jreps:
            np.testing.assert_array_equal(treps[name].numpy(), np.asarray(jreps[name]))
    assert int(tbuf.counts.sum()) > 0


def test_buffer_from_jax_roundtrip():
    jbuf = jstate.local_update(jstate.init_buffer(_jspec(), K, CAP),
                               {k: jnp.asarray(v) for k, v in _batch(9).items()},
                               jnp.asarray(_batch(9)["task"]), jax.random.PRNGKey(0), B)
    _assert_state(buffer_from_jax(jbuf, "cpu"), jbuf)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _items(b, value=None):
    out = {k: torch.from_numpy(v) for k, v in _batch(0, b).items()}
    if value is not None:
        out["images"] = torch.full((b, 2, 2, 3), float(value))
    return out


def test_update_fills_in_order():
    buf = tstate.init_buffer(_tspec(), 2, 4, device="cpu")
    items = _items(4)
    labels = torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    buf = tstate.local_update(buf, items, labels, _gen(0), num_candidates=4)
    assert buf.counts.tolist() == [3, 1]
    for bucket, slot, src in [(0, 0, 0), (0, 1, 1), (0, 2, 3), (1, 0, 2)]:
        assert torch.equal(buf.data["images"][bucket, slot], items["images"][src])


@pytest.mark.parametrize("seed", range(4))
def test_capacity_never_exceeded(seed):
    rng = np.random.default_rng(seed)
    k, cap, b = int(rng.integers(1, 5)), int(rng.integers(1, 8)), int(rng.integers(2, 16))
    buf = tstate.init_buffer(_tspec(), k, cap, device="cpu")
    gen = _gen(seed)
    for s in range(4):
        labels = torch.as_tensor(rng.integers(0, k, b), dtype=torch.int32)
        buf = tstate.local_update(buf, _items(b, s + 1), labels, gen,
                                  int(rng.integers(1, b + 1)))
    assert (buf.counts <= cap).all() and (buf.counts >= 0).all()
    for bucket in range(k):
        n = int(buf.counts[bucket])
        assert (buf.data["images"][bucket, :n] > 0).all()  # only non-zero payloads


def test_acceptance_rate_matches_c_over_b():
    """Alg. 1: each sample enters with probability c/b."""
    b, c, trials = 64, 16, 200
    empty = tstate.init_buffer(_tspec(), 1, 100000, device="cpu")
    gen = _gen(42)
    labels = torch.zeros(b, dtype=torch.int32)
    accepted = sum(int(tstate.local_update_rows(empty, labels, gen, c)[4][0])
                   for _ in range(trials))
    rate = accepted / (trials * b)
    assert abs(rate - c / b) < 0.02, rate


def test_eviction_keeps_class_balance():
    buf = tstate.init_buffer(_tspec(), 2, 2, device="cpu")
    gen = _gen(0)
    for s in range(20):
        buf = tstate.local_update(buf, _items(4, s + 10),
                                  torch.tensor([0, 0, 1, 1], dtype=torch.int32), gen, 4)
    assert buf.counts.tolist() == [2, 2]


def test_local_sample_uniform_over_filled():
    buf = tstate.init_buffer({"x": ItemSpec((1,), torch.int32)}, 2, 8, device="cpu")
    items = {"x": torch.arange(12, dtype=torch.int32)[:, None] + 1}
    labels = (torch.arange(12) % 2).to(torch.int32)
    buf = tstate.local_update(buf, items, labels, _gen(1), 12)
    counts = np.zeros(13)
    gen = _gen(2)
    for _ in range(300):
        s, valid = tstate.local_sample(buf, gen, 4)
        assert bool(valid.all())
        for v in s["x"][:, 0].tolist():
            counts[v] += 1
    assert counts[0] == 0  # never sample empty slots
    filled = counts[1:13]
    assert filled.min() > 0.4 * filled.mean()


def test_empty_buffer_sample_invalid_and_masked():
    buf = tstate.init_buffer(_tspec(), 2, 4, device="cpu")
    s, valid = tstate.local_sample(buf, _gen(0), 3)
    assert not bool(valid.any())
    aug = tstate.augment_batch(_items(2), s, valid, "label")
    assert aug["images"].shape == (5, 2, 2, 3)
    assert aug["label"][2:].tolist() == [-1, -1, -1]


def test_api_flat_branch_only():
    """The flat branch for ``tiering='off'`` (the tiered one is held in
    tests/test_torch_tiered.py); a registered policy other than the
    reservoir builds a buffer with its aux (fifo: a zero cursor per bucket),
    and an unknown policy raises ``KeyError`` naming the four."""
    assert isinstance(tapi.init_from_config(_tspec(), RehearsalConfig(), "cpu"),
                      tstate.BufferState)
    assert not isinstance(tapi.init_from_config(_tspec(), RehearsalConfig(tiering="host"),
                                                "cpu"), tstate.BufferState)
    fifo = tapi.init_from_config(_tspec(), RehearsalConfig(num_buckets=3, policy="fifo"),
                                 "cpu")
    assert isinstance(fifo, tstate.BufferState)
    assert fifo.aux["cursor"].tolist() == [0, 0, 0]
    assert fifo.aux["cursor"].dtype == torch.int32
    with pytest.raises(KeyError, match="'class_balanced', 'fifo', 'grasp', 'reservoir'"):
        tapi.init_from_config(_tspec(), RehearsalConfig(policy="lru"), "cpu")


def test_sample_global_without_peers_draws_r_filled_records():
    """One process (no group): the no-collective branch, r valid records
    drawn from the filled slots only, for the full and pod_local exchanges;
    an unknown exchange mode raises."""
    from repro_torch.core import distributed as tdist

    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4)
    buf = tstate.local_update(tstate.init_buffer(_tspec(), 2, 4, device="cpu"),
                              _items(4, 7), torch.tensor([0, 1, 0, 1], dtype=torch.int32),
                              _gen(0), 4)
    reps, valid = tdist.sample_global(buf, _gen(1), 5, rcfg=rcfg)
    assert reps["images"].shape == (5, 2, 2, 3) and bool(valid.all())
    assert (reps["images"] == 7.0).all()  # never an empty (zero) slot
    # pod_local without a group: no peers inside the pod, the same branch
    reps, valid = tdist.sample_global(buf, _gen(1), 5, exchange="pod_local", rcfg=rcfg)
    assert reps["images"].shape == (5, 2, 2, 3) and bool(valid.all())
    assert (reps["images"] == 7.0).all()
    with pytest.raises(ValueError):
        tdist.sample_global(buf, _gen(1), 5, exchange="ring", rcfg=rcfg)
