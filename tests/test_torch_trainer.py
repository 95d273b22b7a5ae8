"""The port's entry point: ``ContinualTrainer`` on the CPU, and what it refuses."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import resnet50_cl
from repro_torch.configs.base import RehearsalConfig, ResilienceConfig, RunConfig, ScenarioConfig
from repro_torch.data import ClassIncrementalImages, Cursor, ImageStreamConfig, Prefetcher
from repro_torch.scenario import ContinualTrainer

RUN = RunConfig(
    model=resnet50_cl.reduced(num_classes=20),
    rehearsal=RehearsalConfig(slots_per_bucket=8, num_representatives=2,
                              num_candidates=4, mode="async"),
    scenario=ScenarioConfig(num_tasks=2, steps_per_epoch=3, batch_size=8))


@pytest.mark.parametrize("strategy", ["rehearsal", "incremental"])
def test_trainer_runs_reduced_two_tasks_on_cpu(strategy):
    res = ContinualTrainer(RUN, device="cpu", strategy=strategy).fit()
    acc = res.accuracy_matrix
    assert acc.shape == (2, 2) and np.isfinite(acc).all()
    assert len(res.losses) == 6 and np.isfinite(res.losses).all()
    assert len(res.step_seconds) == len(res.prefetch_wait_seconds) == 6
    if strategy == "rehearsal":
        fills = [h["buffer_fill"] for h in res.history]
        assert fills[-1] > fills[0] and res.history[0]["rep_checksum"] == 0.0
    else:
        assert "buffer_fill" not in res.history[0]


def test_trainer_applies_scenario_defaults_and_cuts_tasks():
    tr = ContinualTrainer(RUN, device="cpu")
    assert tr.rcfg.num_buckets == 2 and tr.rcfg.label_field == "label"
    assert tr.fit(num_tasks=1).accuracy_matrix.shape == (1, 1)
    with pytest.raises(ValueError):
        tr.fit(num_tasks=3)


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from repro_torch.strategy import init_carry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinualTrainer(RUN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_carry(None, None)


@pytest.mark.parametrize("name", [
    "init_buffer", "init_tiered", "init_cnn", "cnn_params_from_jax", "buffer_from_jax",
    "tiered_from_jax", "opt_state_from_jax", "ef_from_jax"])
def test_constructors_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from repro_torch import convert
    from repro_torch.buffer.state import ItemSpec, init_buffer
    from repro_torch.buffer.tiered import init_tiered
    from repro_torch.models.resnet import init_cnn

    spec = {"x": ItemSpec((3,), torch.float32)}
    make = {
        "init_buffer": lambda: init_buffer(spec, 2, 4),
        "init_tiered": lambda: init_tiered(spec, 2, 2, 4, 4),
        "init_cnn": lambda: init_cnn(torch.Generator(), RUN.model),
        "cnn_params_from_jax": lambda: convert.cnn_params_from_jax({}, RUN.model),
        "buffer_from_jax": lambda: convert.buffer_from_jax(None),
        "tiered_from_jax": lambda: convert.tiered_from_jax(None),
        "opt_state_from_jax": lambda: convert.opt_state_from_jax(None),
        "ef_from_jax": lambda: convert.ef_from_jax({}),
    }[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.parametrize("kwargs,refusal", [(dict(mesh=(1, 2), resilience=ResilienceConfig(
    checkpoint_every=1)), "item 21")])
def test_unported_options_raise(kwargs, refusal, tmp_path):
    """Item 21's restarts on a model axis: ``ContinualTrainer(mesh=1x2,
    resilience=...)`` builds and fits on two gloo ranks (one model row),
    model rank 1 failing once before step 1: both ranks restart once and
    report the same finite losses. Named for the refusal it asserted before this path ran; ``refusal`` is
    that refusal's message, which no rank logs now."""
    import json
    import os

    from repro_torch.runtime import multiproc

    src = r"""
import json, dataclasses, torch
torch.set_num_threads(1)
from repro_torch.runtime import multiproc
multiproc.init_from_env("gloo")
import torch.distributed as dist
from repro_torch import configs
from repro_torch.configs.base import RehearsalConfig, ResilienceConfig, RunConfig, ScenarioConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import InjectedFailure
from repro_torch.scenario import ContinualTrainer

cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=64, num_layers=1)
run = RunConfig(model=cfg, rehearsal=RehearsalConfig(num_buckets=2, label_field="labels"),
                scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                        num_tasks=1, steps_per_epoch=3, batch_size=2,
                                        vocab_size=64, seq_len=8, auto_defaults=False))
fired = []
def hook(step):
    if dist.get_rank() == 1 and step == 1 and not fired:
        fired.append(step)
        raise InjectedFailure("model rank 1")
trainer = ContinualTrainer(run, device="cpu", mesh=make_mesh(%r, ("data", "model")),
                           ckpt_dir=%r, resilience=ResilienceConfig(checkpoint_every=%d),
                           overrides={"failure_hook": hook})
res = trainer.fit()
print(json.dumps({"losses": res.losses, "restarts": res.restarts}))
del trainer
dist.barrier()
dist.destroy_process_group()
""" % (tuple(kwargs["mesh"]), str(tmp_path / "ck"), kwargs["resilience"].checkpoint_every)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    outs = multiproc.launch_workers(src, 2, timeout=300, pythonpath=path,
                                    extra_env={"OMP_NUM_THREADS": "1"},
                                    rendezvous_dir=str(tmp_path))
    for o in outs:
        assert o.returncode == 0, o.stderr[-4000:]
        assert refusal not in o.stderr
    a, b = (json.loads(o.stdout.strip().splitlines()[-1]) for o in outs)
    assert a == b and a["restarts"] == 1 and len(a["losses"]) == 3, a
    assert np.isfinite(a["losses"]).all()


def test_trainer_checkpoints_the_full_carry_per_task(tmp_path):
    """The per-task checkpoints hold the full carry: the buffer's records,
    counts and policy aux, and the pending slot with its key, beside the
    model and the optimizer (the reference's ``tests/test_system.py``)."""
    import numpy as _np

    from repro_torch.configs.base import TrainConfig

    run = RunConfig(
        train=TrainConfig(optimizer="sgd", peak_lr=0.05, warmup_steps=5,
                          linear_scaling=False),
        rehearsal=RehearsalConfig(num_buckets=4, slots_per_bucket=8, num_representatives=3,
                                  num_candidates=6, mode="async", policy="fifo",
                                  label_field="label"),
        scenario=ScenarioConfig(num_tasks=1, epochs_per_task=1, steps_per_epoch=4,
                                batch_size=8, image_size=8, classes_per_task=4,
                                auto_defaults=False))
    trainer = ContinualTrainer(run, device="cpu", ckpt_dir=str(tmp_path), ckpt_every=3)
    assert trainer.ckpt_every == 3  # read by the mesh backend only
    trainer.fit()
    with _np.load(str(tmp_path / "step_0000000000" / "state.npz")) as z:
        keys = set(z.files)
        assert int(z["opt/step"]) == 4 and int(z["buffer/counts"].sum()) > 0
    assert {"buffer/aux/cursor", "buffer/data/images", "pipe/valid", "pipe/key"} <= keys
    assert any(k.startswith("params/") for k in keys)
    assert any(k.startswith("opt/mu/") for k in keys)


def test_trainer_runs_resilient_with_a_checkpoint_dir(tmp_path):
    from repro_torch.configs.base import ResilienceConfig

    res = ContinualTrainer(RUN, device="cpu", ckpt_dir=str(tmp_path),
                           resilience=ResilienceConfig(checkpoint_every=2)).fit()
    plain = ContinualTrainer(RUN, device="cpu").fit()
    assert res.history == plain.history and res.losses == plain.losses
    assert res.restarts == 0 and plain.resilience_stats is None
    assert res.resilience_stats == {"restarts": 0.0, "stale_steps": 0.0,
                                    "restore_seconds": 0.0}


TIERED = dataclasses.replace(RUN.rehearsal, tiering="host", hot_slots=2, cold_slots=6)


@pytest.mark.parametrize("rehearsal", [RUN.rehearsal, TIERED], ids=["flat", "tiered"])
def test_split_form_histories_equal_the_fused_form(rehearsal):
    """``step_form='split'`` (train half, then issue half) against the fused
    step on the CPU: the same ``rep_checksum`` / ``buffer_fill`` / loss
    history, losses and accuracy matrix, bit for bit."""
    run = RUN.replace(rehearsal=rehearsal)
    fused = ContinualTrainer(run, device="cpu").fit()
    split_trainer = ContinualTrainer(run, device="cpu", step_form="split")
    assert split_trainer._halves is not None
    split = split_trainer.fit()
    assert split.history == fused.history and split.losses == fused.losses
    assert np.array_equal(split.accuracy_matrix, fused.accuracy_matrix)
    assert len(split.step_seconds) == len(split.prefetch_wait_seconds) == 6
    fills = [h["buffer_fill"] for h in split.history]
    assert fills[-1] > fills[0] and any(h["rep_checksum"] for h in split.history)
    if rehearsal.tiered:
        assert fills[-1] > 2 * 2  # past the hot tier: the cold tier holds records


@pytest.mark.parametrize("kwargs", [dict(strategy="incremental"),
                                    dict(run=RUN.replace(rehearsal=dataclasses.replace(
                                        RUN.rehearsal, mode="sync")))],
                         ids=["not_rehearsal", "not_pipelined"])
def test_split_form_refuses_what_the_reference_refuses(kwargs):
    run = kwargs.pop("run", RUN)
    with pytest.raises(ValueError, match="pipelined rehearsal path"):
        ContinualTrainer(run, device="cpu", step_form="split", **kwargs)


def test_unported_configs_raise():
    # the token scenarios are ported (item 11): the config builds the LM trainer
    tokens = ContinualTrainer(RUN.replace(model=None, scenario=dataclasses.replace(
        RUN.scenario, modality="tokens")), device="cpu")
    assert type(tokens.scenario).__name__ == "TokenClassIncremental"
    assert set(tokens.item_spec) == {"tokens", "labels", "task"}
    # and so are the domain-incremental and blurry-boundary scenarios (item 9)
    domain = ContinualTrainer(RUN, scenario="domain_incremental", device="cpu")
    assert type(domain.scenario).__name__ == "DomainIncremental"
    assert set(domain.item_spec) == {"images", "label", "task"}
    blurry = ContinualTrainer(RUN, scenario="blurry_boundary", device="cpu")
    assert type(blurry.scenario).__name__ == "BlurryBoundary"
    assert set(blurry.item_spec) == {"images", "label"}
    with pytest.raises(KeyError, match="unknown scenario"):
        ContinualTrainer(RUN, scenario="no_such_scenario", device="cpu")


def test_prefetcher_serves_the_stream_in_order_and_ends():
    stream = ClassIncrementalImages(ImageStreamConfig(num_tasks=1, image_size=4))
    pf = Prefetcher(lambda cur: stream.batch(0, 2, cur.step), cursor=Cursor(0, 5),
                    convert=torch.as_tensor, limit=3).start()
    try:
        for step in (5, 6, 7):
            cur, batch = pf.next()
            assert cur.step == step
            assert np.array_equal(batch["images"].numpy(),
                                  stream.batch(0, 2, step)["images"])
        with pytest.raises(StopIteration):
            pf.next()
    finally:
        pf.stop()
