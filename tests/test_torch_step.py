"""The whole slice: the port's train step against the JAX ``make_cl_step``,
and its split form (``make_pipelined_halves``) against the fused step and
the JAX halves.

Both start from the same carry (JAX params, optimizer state, buffer and
pending slot carried across with ``repro_torch.convert``) and see the same
numpy batches. The port draws no rows of its own here: each step gets the
JAX step's row vectors (``local_update_rows`` / ``local_sample_rows`` under
the key the JAX step's issue half uses) through the ``rows`` seam.

Tolerances: ``buffer_fill``, ``rep_checksum``, the buffer and the pending
slot exactly (bytes are copied); loss and parameters at rtol 1e-4 of the
largest value (f32 convolutions and reductions in another order, four SGD
steps compounding them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.buffer import state as jstate
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
from repro.strategy import make_pipelined_halves as jmake_pipelined_halves
from repro.strategy import rep_checksum as jrep_checksum
from repro_torch.buffer.state import ItemSpec, UpdateSampleRows
from repro_torch.configs import resnet50_cl as tcfgs
from repro_torch.configs.base import RehearsalConfig, TrainConfig
from repro_torch.convert import (buffer_from_jax, cnn_params_from_jax, named_from_tree,
                                 opt_state_from_jax)
from repro_torch.core import distributed as tdist
from repro_torch.data import ClassIncrementalImages, ImageStreamConfig
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import resnet as tresnet
from repro_torch.optim import make_optimizer
from repro_torch.strategy import (PipelinedRehearsalCarry, TrainCarry, init_carry,
                                  make_cl_step, make_pipelined_halves, rep_checksum)

JCFG = jcfgs.CNNConfig("t", "resnet18", num_classes=8, width=4, stage_blocks=(1, 1),
                       bottleneck=False, image_size=8)
TCFG = tcfgs.CNNConfig("t", "resnet18", num_classes=8, width=4, stage_blocks=(1, 1),
                       bottleneck=False, image_size=8)
STREAM = dict(num_tasks=2, classes_per_task=4, image_size=8)
RCFG = dict(num_buckets=2, slots_per_bucket=4, num_representatives=3, num_candidates=4,
            label_field="label", task_field="task")
RECIPE = dict(peak_lr=0.1, warmup_steps=1)
B, STEPS = 8, 4


def _batch(stream, s):
    return stream.batch(int(s >= STEPS // 2), B, s)  # task 0, then task 1


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + 1e-7


def _jax_loss(p, batch):
    logits = jresnet.apply_cnn(p, batch["images"], JCFG)
    return jzoo.cross_entropy(logits[:, None, :], batch["label"][:, None]), {}


def _jax_run(pipelined):
    rcfg = JRehearsal(mode="sync", pipelined=pipelined, **RCFG)
    spec = {"images": jax.ShapeDtypeStruct((8, 8, 3), jnp.float32),
            "label": jax.ShapeDtypeStruct((), jnp.int32),
            "task": jax.ShapeDtypeStruct((), jnp.int32)}
    init, update = jmake_optimizer(JTrain(**RECIPE))
    params = jax.jit(lambda k: jresnet.init_cnn(k, JCFG))(jax.random.PRNGKey(0))
    step = jmake_cl_step(_jax_loss, update, rcfg, strategy="rehearsal", exchange="local",
                         label_field="label", donate=False)
    return rcfg, spec, params, init(params), step


def _port_carry(jc):
    np_tree = jax.tree_util.tree_map(np.asarray, jc.params)
    pipe = PipelinedRehearsalCarry(
        {k: torch.from_numpy(np.array(v)) for k, v in jc.pipe.reps.items()},
        torch.from_numpy(np.array(jc.pipe.valid)), 3)
    return TrainCarry(cnn_params_from_jax(np_tree, TCFG, "cpu"),
                      opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jc.opt), "cpu"),
                      buffer_from_jax(jc.buffer, "cpu"), pipe)


def _port_loss(model, batch):
    logits = tresnet.apply_cnn(model, batch["images"])
    return tzoo.cross_entropy(logits[:, None, :], batch["label"][:, None]), {}


def _port_step(pipelined):
    rcfg = RehearsalConfig(mode="sync", pipelined=pipelined, **RCFG)
    _, update = make_optimizer(TrainConfig(**RECIPE))
    return make_cl_step(_port_loss, update, rcfg, strategy="rehearsal", exchange="local",
                        label_field="label", device="cpu")


def _port_halves():
    rcfg = RehearsalConfig(mode="sync", pipelined=True, **RCFG)
    _, update = make_optimizer(TrainConfig(**RECIPE))
    return make_pipelined_halves(_port_loss, update, rcfg, exchange="local",
                                 label_field="label", device="cpu")


def _jax_rows(jc, jbatch, rcfg):
    """The row vectors the JAX step's issue half computes (``jc`` carries the
    ``pipe`` and the ``buffer``)."""
    k_up, k_samp = jax.random.split(jax.random.fold_in(jc.pipe.key, 0))
    flat, _, _, _, counts, seen = jstate.local_update_rows(
        jc.buffer, jbatch["task"], k_up, rcfg.num_candidates)
    samp, valid = jstate.local_sample_rows(jc.buffer._replace(counts=counts), k_samp,
                                           rcfg.num_representatives)
    return UpdateSampleRows(*(torch.from_numpy(np.array(a))
                              for a in (flat, counts, seen, samp, valid)))


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_port_step_matches_jax_make_cl_step(pipelined):
    rcfg, spec, params, opt, jstep = _jax_run(pipelined)
    jc = jinit_carry(params, opt, spec, rcfg, label_field="label", seed=3)
    tc = _port_carry(jc)
    tstep = _port_step(pipelined)
    stream = JImages(JStreamCfg(**STREAM))
    key = jax.random.PRNGKey(0)
    for s in range(STEPS):
        batch = _batch(stream, s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rows = _jax_rows(jc, jbatch, rcfg)
        jc, jm = jstep(jc, jbatch, jax.random.fold_in(key, s))
        tc, tm = tstep(tc, batch, s, rows=rows)
        _close(float(tm["loss"]), float(jm["loss"]))
        assert float(tm["buffer_fill"]) == float(jm["buffer_fill"])
        assert float(tm["rep_checksum"]) == float(jm["rep_checksum"])
        for name, leaf in jc.buffer.data.items():
            np.testing.assert_array_equal(tc.buffer.data[name].numpy(), np.asarray(leaf))
            np.testing.assert_array_equal(tc.pipe.reps[name].numpy(),
                                          np.asarray(jc.pipe.reps[name]))
        assert tc.pipe.valid.tolist() == np.asarray(jc.pipe.valid).tolist()
    assert float(tm["buffer_fill"]) > 0 and float(tm["rep_checksum"]) > 0
    want = named_from_tree(jax.tree_util.tree_map(np.asarray, jc.params))
    for name, p in tc.params.named_parameters():
        _close(p.detach().numpy(), want[name])


def test_port_halves_match_jax_make_pipelined_halves():
    """The split form against the reference's: the JAX halves run as the
    reference trainer dispatches them (train, then issue); the port's issue
    half gets the JAX issue half's row vectors through the ``rows`` seam.
    Buffer, pending reps and valid, ``buffer_fill`` and ``rep_checksum`` of
    the consumed slot exactly; loss and parameters within ``_close``."""
    rcfg, spec, params, opt, _ = _jax_run(True)
    jc = jinit_carry(params, opt, spec, rcfg, label_field="label", seed=3)
    jtrain, jissue = jmake_pipelined_halves(_jax_loss, jmake_optimizer(JTrain(**RECIPE))[1],
                                            rcfg, exchange="local", label_field="label")
    tc = _port_carry(jc)
    ttrain, tissue = _port_halves()
    assert tissue.stream is None  # the CPU runs the halves in line
    jparams, jopt, jbuf, jpipe = jc.params, jc.opt, jc.buffer, jc.pipe
    model, topt, tbuf, tpipe, _ = tc
    stream = JImages(JStreamCfg(**STREAM))
    key = jax.random.PRNGKey(0)
    for s in range(STEPS + 2):
        batch = _batch(stream, s)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        rows = _jax_rows(TrainCarry(None, None, jbuf, jpipe), jbatch, rcfg)
        jck = float(jrep_checksum(jpipe.reps, jpipe.valid, "label"))
        tck = float(rep_checksum(tpipe.reps, tpipe.valid, "label"))
        jparams, jopt, jm = jtrain(jparams, jopt, jpipe, jbatch)
        jbuf, jpipe = jissue(jbuf, jpipe, jbatch, jax.random.fold_in(key, s))
        model, topt, tm = ttrain(model, topt, tpipe, batch)
        tbuf, tpipe = tissue(tbuf, tpipe, batch, s, rows=rows)
        assert tck == jck
        _close(float(tm["loss"]), float(jm["loss"]))
        assert float(tbuf.counts.sum()) == float(jbuf.counts.sum())
        for name, leaf in jbuf.data.items():
            np.testing.assert_array_equal(tbuf.data[name].numpy(), np.asarray(leaf))
            np.testing.assert_array_equal(tpipe.reps[name].numpy(), np.asarray(jpipe.reps[name]))
        assert tpipe.valid.tolist() == np.asarray(jpipe.valid).tolist()
    assert float(tbuf.counts.sum()) > 0 and tck > 0
    want = named_from_tree(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in model.named_parameters():
        _close(p.detach().numpy(), want[name])


def test_port_halves_match_port_fused_pipelined_step():
    """``make_pipelined_halves`` dispatched train then issue reproduces the
    fused pipelined ``make_cl_step`` over 6 steps with the port's own
    generator: parameters, optimizer state, buffer and pending slot bit for
    bit (as tests/test_pipelined.py holds the reference's halves)."""
    checksums, _, fused = _port_run(True, steps=6)
    _, _, carry = _port_run(True, steps=0)
    train_half, issue_half = _port_halves()
    stream = ClassIncrementalImages(ImageStreamConfig(**STREAM))
    model, opt, buf, pipe, _ = carry
    split_checksums = []
    for s in range(6):
        batch = _batch(stream, s)
        split_checksums.append(float(rep_checksum(pipe.reps, pipe.valid, "label")))
        model, opt, _ = train_half(model, opt, pipe, batch)
        buf, pipe = issue_half(buf, pipe, batch, s)
    assert split_checksums == checksums
    assert pipe.key == fused.pipe.key and torch.equal(pipe.valid, fused.pipe.valid)
    for k in fused.buffer.data:
        assert torch.equal(buf.data[k], fused.buffer.data[k])
        assert torch.equal(pipe.reps[k], fused.pipe.reps[k])
    assert torch.equal(buf.counts, fused.buffer.counts)
    assert torch.equal(buf.seen, fused.buffer.seen)
    want = dict(fused.params.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, want[name]), name
    assert opt.step == fused.opt.step
    for name, mu in fused.opt.mu.items():
        assert torch.equal(opt.mu[name], mu), name


def test_halves_refuse_the_sync_path():
    rcfg = RehearsalConfig(mode="sync", **RCFG)
    with pytest.raises(ValueError, match="mode='async'"):
        make_pipelined_halves(_port_loss, make_optimizer(TrainConfig(**RECIPE))[1], rcfg,
                              device="cpu")


def _port_run(pipelined, steps=6):
    tstep = _port_step(pipelined)
    model = tresnet.init_cnn(torch.Generator().manual_seed(0), TCFG, device="cpu")
    opt = make_optimizer(TrainConfig(**RECIPE))[0](dict(model.named_parameters()))
    spec = {"images": ItemSpec((8, 8, 3), torch.float32),
            "label": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}
    carry = init_carry(model, opt, spec, RehearsalConfig(mode="sync", **RCFG),
                       label_field="label", seed=3, device="cpu")
    stream = ClassIncrementalImages(ImageStreamConfig(**STREAM))
    checksums, pendings = [], []
    for s in range(steps):
        carry, m = tstep(carry, _batch(stream, s), s)
        checksums.append(float(m["rep_checksum"]))
        pendings.append({k: v.clone() for k, v in carry.pipe.reps.items()})
    return checksums, pendings, carry


def test_pipelined_reps_are_sync_reps_shifted_one_step():
    """With the port's own generator: pipelined reps at t == sync reps at t-1,
    the pending slots and the final buffers are identical."""
    sync_ck, sync_pend, sync_c = _port_run(False)
    pipe_ck, pipe_pend, pipe_c = _port_run(True)
    assert pipe_ck[1:] == sync_ck[:-1]
    assert pipe_ck[0] == 0.0 and pipe_ck != sync_ck
    for a, b in zip(sync_pend, pipe_pend):
        for k in a:
            assert torch.equal(a[k], b[k])
    for k in sync_c.buffer.data:
        assert torch.equal(sync_c.buffer.data[k], pipe_c.buffer.data[k])
    assert torch.equal(sync_c.buffer.counts, pipe_c.buffer.counts)


def test_issue_consume_composition_equals_update_and_sample():
    """issue_sample then consume_reps == the fused update_and_sample."""
    from repro_torch.buffer.state import init_buffer
    from repro_torch.rng import fold_in, generator

    rcfg = RehearsalConfig(mode="sync", **RCFG)
    spec = {"images": ItemSpec((8, 8, 3), torch.float32),
            "label": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}
    stream = ClassIncrementalImages(ImageStreamConfig(**STREAM))
    batch = {k: torch.from_numpy(v) for k, v in stream.batch(1, B, 0).items()}
    buf1, buf2 = (init_buffer(spec, 2, 4, device="cpu") for _ in range(2))
    s1, pending = tdist.issue_sample(buf1, batch, batch["task"],
                                     generator(fold_in(42, 0), "cpu"), rcfg)
    r1, v1 = tdist.consume_reps(pending, "label")
    s2, r2, v2 = tdist.update_and_sample(buf2, batch, batch["task"], 42, rcfg,
                                         label_field="label")
    assert torch.equal(v1, v2) and torch.equal(s1.counts, s2.counts)
    for k in r1:
        assert torch.equal(r1[k], r2[k]) and torch.equal(s1.data[k], s2.data[k])


def test_stream_batches_identical_to_jax_package():
    jstream, tstream = JImages(JStreamCfg(**STREAM)), ClassIncrementalImages(
        ImageStreamConfig(**STREAM))
    for got, want in [(tstream.batch(1, 5, 7), jstream.batch(1, 5, 7)),
                      (tstream.eval_set(0), jstream.eval_set(0)),
                      (tstream.cumulative_batch(1, 3, 2), jstream.cumulative_batch(1, 3, 2))]:
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
