"""The mesh backend (``launch.mesh``, ``launch.steps``, the mesh half of
``core.distributed``, ``ContinualTrainer(mesh=...)``) against the JAX
package's pjit route, on the CPU.

  * the layout helpers (``augment_global``, ``global_replay_mask``,
    ``global_batch_rows``) against the reference's for n_dp in {1, 2, 4},
    exactly;
  * ``build_train_step``'s ``meta`` against the reference's at 1x1 for off,
    sync, pipelined, der_pp and tiered, and the reference's error cases;
  * a restart right after a task boundary on a checkpoint step (Queue 3
    F2), on the carry backend and the mesh backend at 1x1, against the
    clean run;
  * the mesh backend at 1x1 with ``exchange='local'`` against the port's
    carry backend: fingerprints and losses bit for bit, flat and tiered (the
    port of ``test_scenario.py::test_pjit_backend_matches_carry_fingerprints``,
    which fails on this jax for the tiered store);
  * two gloo ranks on a 2x1 mesh against JAX's ``build_train_step`` on a
    2-device CPU mesh (a subprocess with ``XLA_FLAGS``), 3 steps of sync,
    pipelined, der_pp and pipelined with ``run.obs`` on, the JAX row vectors
    and exchange picks fed through the ``rows`` seam (``ExchangeRows``); the
    obs gauges are the global store's on every rank (counts exactly, the
    norms within 1e-6 relative). Tolerances of the rest, and why:
    buffer bytes, the pending slot, ``buffer_fill`` and ``rep_checksum``
    exactly (der_pp's stored logits within 1e-4 of their largest value:
    they are the two frameworks' forwards); the loss within 1e-5 of the
    reference's, relative; the AdamW moments after the first step within
    1e-4 of each tensor's largest entry (they are the global gradient, clip
    included); the AdamW update alone, the reference's update applied to
    the port's first-step gradient against the step's own, within 1e-6 of
    its largest entry; the parameters after 2 steps within 1e-4 of their
    largest entry (``tests/test_torch_lm_train.py`` says why not later).

The multi-rank runs meet through a file in the test's ``tmp_path``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import (RehearsalConfig, ResilienceConfig, RunConfig,
                                      ScenarioConfig, TrainConfig)
from repro_torch.core import distributed as tdist
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import build_train_step, shard_host_batch, slots_for_budget
from repro_torch.scenario import ContinualTrainer, TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, S, B = 128, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol, what=""):
    """Within ``rtol`` of the largest reference value (+1e-7)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + 1e-7, (what, err, scale)


# ---------------------------------------------------------------------------
# The mesh itself
# ---------------------------------------------------------------------------


def test_one_worker_mesh_needs_no_group():
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    assert isinstance(mesh, tmesh.SingleDeviceMesh) and mesh.device_type == "cpu"
    assert tmesh.describe(mesh) == "data=1 x model=1"
    assert tmesh.memory_kinds(mesh) == {"device"}
    assert tmesh.memory_kinds(tmesh.SingleDeviceMesh("cuda", ("data", "model"))) == {
        "device", "pinned_host"}
    pod = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    from repro_torch.parallel import dp_axes, dp_index, dp_size

    assert dp_axes(pod) == ("pod", "data") and dp_size(pod) == 1 and dp_index(pod) == 0
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((2, 1), ("data", "model"))


@pytest.mark.parametrize("make", [
    lambda: tmesh.make_mesh((1, 2), ("data", "model")),
    lambda: tmesh.make_mesh((16, 16), ("data", "model")),
    lambda: tmesh.make_mesh((2, 16, 16), ("pod", "data", "model"))])
def test_a_model_axis_raises_naming_item_21(make):
    """A model axis over 1 runs now (item 21's tensor parallelism): like any
    mesh of more than one rank, the reference's production layouts
    included, it needs a process group, and without one it says so."""
    with pytest.raises(RuntimeError, match="process group"):
        make()


def test_slots_for_budget_and_host_shards_match_the_reference():
    from repro.launch.steps import slots_for_budget as jslots

    from repro_torch.buffer.state import ItemSpec

    spec = {"tokens": ItemSpec((S,), torch.int32), "x": ItemSpec((7, 3), torch.float32)}
    jspec = {"tokens": jax.ShapeDtypeStruct((S,), jnp.int32),
             "x": jax.ShapeDtypeStruct((7, 3), jnp.float32)}
    for budget in (1, 4000, 64 << 20, 1 << 40):
        assert slots_for_budget(spec, 3, budget) == jslots(jspec, 3, budget)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    batch = {"x": np.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(shard_host_batch(batch, mesh)["x"], batch["x"])


# ---------------------------------------------------------------------------
# (a) the layout helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_layout_helpers_match_the_reference(n_dp):
    from repro.core import distributed as jdist

    rng = np.random.default_rng(n_dp)
    bg, r = 8, 3
    batch = {"tokens": rng.integers(0, V, (bg, S)).astype(np.int32),
             "labels": rng.integers(0, V, (bg, S)).astype(np.int32),
             "x": rng.normal(size=(bg, 5)).astype(np.float32)}
    reps = {"tokens": rng.integers(0, V, (n_dp, r, S)).astype(np.int32),
            "labels": rng.integers(0, V, (n_dp, r, S)).astype(np.int32),
            "x": rng.normal(size=(n_dp, r, 5)).astype(np.float64)}  # cast to the batch's
    valid = rng.random((n_dp, r)) < 0.6
    jaug = jdist.augment_global({k: jnp.asarray(v) for k, v in batch.items()},
                                {k: jnp.asarray(v) for k, v in reps.items()},
                                jnp.asarray(valid), n_dp, "labels")
    aug = tdist.augment_global({k: torch.from_numpy(v) for k, v in batch.items()},
                               {k: torch.from_numpy(v) for k, v in reps.items()},
                               torch.from_numpy(valid), n_dp, "labels")
    assert set(aug) == set(jaug)
    for k in aug:
        assert aug[k].dtype == torch.from_numpy(np.array(jaug[k])).dtype, k
        np.testing.assert_array_equal(aug[k].numpy(), np.asarray(jaug[k]), err_msg=k)
    mask = tdist.global_replay_mask(bg, n_dp, torch.from_numpy(valid))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jdist.global_replay_mask(bg, n_dp, jnp.asarray(valid))))
    rows = tdist.global_batch_rows(aug, bg, n_dp, r)
    jrows = jdist.global_batch_rows(jaug, bg, n_dp, r)
    for k in rows:
        np.testing.assert_array_equal(rows[k].numpy(), np.asarray(jrows[k]))
        np.testing.assert_array_equal(rows[k].numpy(), batch[k])


# ---------------------------------------------------------------------------
# (b) the builder's meta and guards at 1x1
# ---------------------------------------------------------------------------


def _runs(mode="async", strategy="rehearsal", tiering="off", **rc):
    """The reference's ``_token_run`` (tests/test_scenario.py) in both
    packages: a 2-layer SmolLM over vocab 128, seq 16, batch 8, AdamW f32."""
    from repro.configs import get_reduced as jreduced
    from repro.configs.base import RehearsalConfig as JRehearsal
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import ScenarioConfig as JScenario
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain

    jcfg = dataclasses.replace(jreduced("smollm-135m"), vocab_size=V, num_layers=2)
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
    rcfg = dict(dict(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                     num_candidates=6, mode=mode, tiering=tiering, hot_slots=4, cold_slots=8,
                     label_field="labels"), **rc)
    train = dict(optimizer="adamw", peak_lr=1e-3, warmup_steps=5, linear_scaling=False,
                 compute_dtype="float32")
    sc = dict(name="class_incremental", modality="tokens", strategy=strategy, num_tasks=2,
              epochs_per_task=1, steps_per_epoch=6, batch_size=B, vocab_size=V, seq_len=S,
              auto_defaults=False)
    jrun = JRun(model=jcfg, shape=JShape("parity", S, B, "train"), train=JTrain(**train),
                rehearsal=JRehearsal(**rcfg), scenario=JScenario(**sc))
    run = RunConfig(model=cfg, train=TrainConfig(**train), rehearsal=RehearsalConfig(**rcfg),
                    scenario=ScenarioConfig(**sc))
    return jrun, run


def _jax_built(jrun, **kw):
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.launch.steps import build_train_step as jbuild
    from repro.utils.compat import set_mesh

    mesh = jmake_mesh((1, 1), ("data", "model"))
    with set_mesh(mesh):
        return jbuild(jrun, mesh, donate=False, **kw)


@pytest.mark.parametrize("case", ["off", "sync", "pipelined", "der_pp", "tiered"])
@pytest.mark.parametrize("budget", [None, 64 << 20], ids=["config_slots", "budget"])
def test_builder_meta_matches_the_reference_at_1x1(case, budget):
    mode = {"off": "off", "sync": "sync"}.get(case, "async")
    strategy = {"off": "incremental", "der_pp": "der_pp"}.get(case, "rehearsal")
    jrun, run = _runs(mode, strategy, "host" if case == "tiered" else "off")
    want = _jax_built(jrun, buffer_budget_bytes=budget)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    got = build_train_step(run, mesh, buffer_budget_bytes=budget, device="cpu")
    want_meta = want.meta
    # the memory knobs the reference's builder reads from TrainConfig and
    # does not report: the port names them in meta too
    knobs = {"remat": run.train.remat, "zero1": False, "sequence_parallel": False}
    assert set(got.meta) == set(want_meta) | set(knobs)
    assert {k: got.meta[k] for k in knobs} == knobs
    for k in want_meta:
        if k == "cold_placement" and case == "tiered":
            # the reference's rule on each runtime: this jax's CPU exposes a
            # pinned_host memory kind, a CPU-only torch has none
            assert got.meta[k] == "device" and want_meta[k] in ("pinned_host", "device")
        else:
            assert got.meta[k] == want_meta[k], (k, got.meta[k], want_meta[k])
    if case == "tiered":  # the placement is where the rank puts the cold tier
        cold = materialize_state(got, run, mesh, 0)[2].cold.data
        assert not any(t.is_pinned() for leaf in cold.values() for t in leaf.values())


@pytest.mark.parametrize("strategy,mode,exc", [
    ("from_scratch", "async", NotImplementedError),  # per-task re-init, cumulative data
    ("incremental", "async", ValueError),  # never touches the buffer
    ("der", "off", ValueError),  # would degrade to incremental
    ("der_pp", "sync", ValueError),  # the tap needs the pipelined path
])
def test_builder_refuses_what_the_reference_refuses(strategy, mode, exc):
    jrun, run = _runs(mode, strategy)
    with pytest.raises(exc):
        _jax_built(jrun)
    with pytest.raises(exc):
        build_train_step(run, tmesh.make_mesh((1, 1), ("data", "model")), device="cpu")


class _TwoWorkers(tmesh.SingleDeviceMesh):
    """A 2x1 mesh's shape without its group: the refusals come first."""

    def size(self, mesh_dim=None) -> int:
        return 2 if mesh_dim == 0 else 1


def test_trainer_mesh_checks_the_shape_against_the_schedule():
    """The mesh step's shape is the scenario's schedule: its batch and
    sequence length set the meta's rows and tokens, a batch that does not
    split over the workers raises, and the split form is refused."""
    _, run = _runs()
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    wide = dataclasses.replace(run, scenario=dataclasses.replace(run.scenario,
                                                                 batch_size=2 * B))
    meta = build_train_step(wide, mesh, device="cpu").meta
    assert meta["augmented_global_batch"] == 2 * B + 3
    assert meta["tokens_per_step"] == (2 * B + 3) * S
    odd = dataclasses.replace(run, scenario=dataclasses.replace(run.scenario,
                                                                batch_size=B + 1))
    with pytest.raises(ValueError, match="does not split"):
        ContinualTrainer(odd, device="cpu", mesh=_TwoWorkers("cpu", ("data", "model")))
    with pytest.raises(ValueError, match="split"):
        ContinualTrainer(run, device="cpu", step_form="split", mesh=mesh)


def test_trainer_keeps_resilient_checkpoints_per_rank(tmp_path):
    """On a mesh of more than one worker each rank's ``ResilientLoop`` keeps
    its restart checkpoints under ``ckpt_dir/rank_<dp index>/resilient``
    (the ranks' agreement itself runs on gloo ranks in
    ``tests/test_torch_mesh_ranks.py``)."""
    trainer = ContinualTrainer(_runs()[1], device="cpu",
                               mesh=_TwoWorkers("cpu", ("data", "model")),
                               ckpt_dir=str(tmp_path), resilience=ResilienceConfig())
    loop = trainer._resilient_loop(trainer.mesh_step())
    assert loop.ckpt.dir == os.path.join(str(tmp_path), "rank_0", "resilient")


# ---------------------------------------------------------------------------
# (c) 1x1 against the carry backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiering", ["off", "host"])
def test_mesh_backend_at_1x1_matches_the_carry_backend(tiering):
    """Same seed, same RunConfig, same RNG lineage: ``exchange='local'`` on
    one worker is the carry backend's single-device draw, so the
    fingerprints and (the same arithmetic on one rank) the losses are bit
    for bit; ``exchange='full'`` keeps one representative a step."""
    _, run = _runs(tiering=tiering)
    sc = TokenClassIncremental(run.scenario)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    trainer = ContinualTrainer(run, sc, device="cpu", mesh=mesh, exchange="local")
    got = trainer.fit()
    want = ContinualTrainer(run, sc, device="cpu").fit()
    prints = [(h["rep_checksum"], h["buffer_fill"]) for h in got.history]
    assert prints == [(h["rep_checksum"], h["buffer_fill"]) for h in want.history]
    assert got.losses == want.losses
    assert np.array_equal(got.accuracy_matrix, want.accuracy_matrix)
    assert any(fill > 0 for _, fill in prints) and any(ck != 0 for ck, _ in prints)
    assert trainer.final_state[4].shape == (3,)
    if tiering == "host":
        assert max(fill for _, fill in prints) > 2 * 4
    full = ContinualTrainer(run, sc, device="cpu", mesh=mesh, exchange="full")
    res = full.fit()
    assert full.final_state[4].shape == (1,) and bool(full.final_state[4].all())
    assert np.isfinite(res.losses).all() and res.history[-1]["rep_checksum"] > 0


def test_mesh_backend_restarts_in_the_resilient_loop_bit_for_bit(tmp_path):
    """The ``ResilientLoop`` adapter of the mesh backend (its state tuple
    carries the issue key): a failure before step 9 restores the step-8
    checkpoint and replays, and the run equals the clean one bit for bit;
    the sanitizer, armed, sees a legal schedule through the restore."""
    from repro_torch.runtime import InjectedFailure

    _, run = _runs()
    run = dataclasses.replace(run, sanitize=True)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    res = ResilienceConfig(checkpoint_every=4, max_restarts=2)
    clean = ContinualTrainer(run, device="cpu", mesh=mesh, ckpt_dir=str(tmp_path / "c"),
                             resilience=res)
    assert clean.built.meta["sanitize"] and clean.built.fn._sanitizer is not None
    want = clean.fit()
    fired = []

    def hook(step):
        if step == 9 and not fired:
            fired.append(step)
            raise InjectedFailure("preempted")

    got = ContinualTrainer(run, device="cpu", mesh=mesh, ckpt_dir=str(tmp_path / "x"),
                           resilience=res, overrides={"failure_hook": hook}).fit()
    assert want.restarts == 0 and got.restarts == 1
    assert got.history == want.history and got.losses == want.losses
    assert np.array_equal(got.accuracy_matrix, want.accuracy_matrix)


@pytest.mark.parametrize("backend", ["carry", "mesh"])
def test_restart_right_after_a_task_boundary_on_a_checkpoint_step(backend, tmp_path):
    """Queue 3 F2: with checkpoints every 3 steps, task 1's loop starts on
    step 6, which task 0's loop already saved (its start save is skipped),
    and a failure before step 7 restores it. The loop counts its history
    from its own start, so the run equals the clean one: every history
    entry (loss, ``rep_checksum``, ``buffer_fill``) once, and every loss."""
    from repro_torch.runtime import InjectedFailure

    _, run = _runs()
    mesh = tmesh.make_mesh((1, 1), ("data", "model")) if backend == "mesh" else None
    res = ResilienceConfig(checkpoint_every=3, max_restarts=2)
    want = ContinualTrainer(run, device="cpu", mesh=mesh, ckpt_dir=str(tmp_path / "c"),
                            resilience=res).fit()
    fired = []

    def hook(step):
        if step == 7 and not fired:
            fired.append(step)
            raise InjectedFailure("preempted")

    got = ContinualTrainer(run, device="cpu", mesh=mesh, ckpt_dir=str(tmp_path / "x"),
                           resilience=res, overrides={"failure_hook": hook}).fit()
    assert got.restarts == 1 and fired == [7]
    assert len(got.history) == len(want.history) == 12  # every step of both tasks, once
    for g, w in zip(got.history, want.history):
        assert (g["task"], g["step"]) == (w["task"], w["step"])
        for k in ("loss", "rep_checksum", "buffer_fill"):
            assert g[k] == w[k], (k, g, w)
    assert got.losses == want.losses


# ---------------------------------------------------------------------------
# (d) two gloo ranks against JAX's build_train_step on a 2-device CPU mesh
# ---------------------------------------------------------------------------

CASES = {"sync": ("sync", "rehearsal"), "pipelined": ("async", "rehearsal"),
         "der_pp": ("async", "der_pp"), "pipelined_obs": ("async", "rehearsal")}
STEPS, N = 3, 2

JAX_SIDE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.buffer import state as jstate
from repro.configs import get_reduced
from repro.configs.base import (ObsConfig, RehearsalConfig, RunConfig, ScenarioConfig,
                                ShapeConfig, StrategyConfig, TrainConfig)
from repro.data import TaskTokenStream, TokenStreamConfig
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.scenario.trainer import materialize_state
from repro.utils.compat import set_mesh
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_named_from_tree

V, S, B, N, STEPS, CASES = {V}, {S}, {B}, {N}, {STEPS}, {CASES}
cfg = dataclasses.replace(get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
tcfg = dataclasses.replace(tconfigs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
stream = TaskTokenStream(TokenStreamConfig(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
mesh = make_mesh((N, 1), ("data", "model"))
out, bw = {{}}, B // N

def named(tree):
    return lm_named_from_tree(jax.tree_util.tree_map(np.asarray, tree), tcfg)

for case, (mode, strategy) in CASES.items():
    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                           num_candidates=6, mode=mode, label_field="labels")
    run = RunConfig(model=cfg, shape=ShapeConfig("parity", S, B, "train"),
                    train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                      linear_scaling=False, compute_dtype="float32"),
                    rehearsal=rcfg, strategy=StrategyConfig(),
                    obs=ObsConfig(enabled=case.endswith("_obs")),
                    scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                            strategy=strategy, num_tasks=2, batch_size=B,
                                            vocab_size=V, seq_len=S, auto_defaults=False))
    with set_mesh(mesh):
        built = build_train_step(run, mesh, exchange="full", buffer_budget_bytes=None,
                                 donate=False)
        key = jax.random.PRNGKey(0)
        params, opt, buf, reps, valid = materialize_state(built, run, mesh, key)
        out.update({{f"{{case}}/params0/{{k}}": v for k, v in named(params).items()}})
        issue_key = key
        for s in range(STEPS):
            batch = stream.batch(int(s >= 2), B, s)
            # the row vectors every worker's issue draws (sample_global's split)
            plans = []
            for w in range(N):
                buf_w = jax.tree_util.tree_map(lambda x: x[w], buf)
                k_up, k_samp = jax.random.split(jax.random.fold_in(issue_key, w))
                flat, _, _, _, counts, seen = jstate.local_update_rows(
                    buf_w, jnp.asarray(batch["task"][w * bw:(w + 1) * bw]), k_up, 6)
                k_draw, k_pick = jax.random.split(k_samp)
                samp, sv = jstate.local_sample_rows(buf_w._replace(counts=counts), k_draw, N)
                plans.append((flat, counts, seen, samp, sv, k_pick))
            for w, (flat, counts, seen, samp, sv, k_pick) in enumerate(plans):
                recv_valid = jnp.stack([plans[j][4][w] for j in range(N)])
                scores = jax.random.uniform(k_pick, (N,)) + jnp.where(recv_valid, 0.0, 1e3)
                take = jnp.argsort(scores)[:3]
                for name, a in (("flat", flat), ("counts", counts), ("seen", seen),
                                ("samp", samp), ("sv", sv), ("take", take)):
                    out[f"{{case}}/s{{s}}/w{{w}}/rows/{{name}}"] = np.asarray(a)
            out.update({{f"{{case}}/s{{s}}/batch/{{k}}": v for k, v in batch.items()}})
            params, opt, buf, reps, valid, m = built.fn(
                params, opt, buf, reps, valid, {{k: jnp.asarray(v) for k, v in batch.items()}},
                issue_key)
            issue_key = jax.random.fold_in(key, s)
            for k in ("loss", "rep_checksum", "buffer_fill"):
                out[f"{{case}}/s{{s}}/{{k}}"] = np.asarray(m[k])
            out.update({{f"{{case}}/s{{s}}/{{k}}": np.asarray(v) for k, v in m.items()
                         if k.startswith("obs/")}})
            for w in range(N):
                for k, v in buf.data.items():
                    out[f"{{case}}/s{{s}}/w{{w}}/buffer/{{k}}"] = np.asarray(v)[w]
                out[f"{{case}}/s{{s}}/w{{w}}/counts"] = np.asarray(buf.counts)[w]
                for k, v in reps.items():
                    out[f"{{case}}/s{{s}}/w{{w}}/reps/{{k}}"] = np.asarray(v)[w]
                out[f"{{case}}/s{{s}}/w{{w}}/valid"] = np.asarray(valid)[w]
            if s < 2:
                out.update({{f"{{case}}/params{{s + 1}}/{{k}}": v
                             for k, v in named(params).items()}})
            if s == 0:
                out.update({{f"{{case}}/mu1/{{k}}": v for k, v in named(opt.mu).items()}})
np.savez(sys.argv[1], **out)
"""

PORT_SIDE = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rendezvous, ref_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{{rendezvous}}", rank=rank,
                        world_size=world)
from repro_torch import configs
from repro_torch.buffer.state import UpdateSampleRows
from repro_torch.configs.base import (ObsConfig, RehearsalConfig, RunConfig, ScenarioConfig,
                                      StrategyConfig, TrainConfig)
from repro_torch.convert import load_named
from repro_torch.obs import read_gauges
from repro_torch.core.distributed import ExchangeRows
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step, shard_host_batch
from repro_torch.scenario import TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state

V, S, B, STEPS, CASES = {V}, {S}, {B}, {STEPS}, {CASES}
ref = np.load(ref_path)
cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
mesh = make_mesh((world, 1), ("data", "model"))
out = {{}}
for case, (mode, strategy) in CASES.items():
    run = RunConfig(
        model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                     linear_scaling=False, compute_dtype="float32"),
        rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                                  num_candidates=6, mode=mode, label_field="labels"),
        strategy=StrategyConfig(), obs=ObsConfig(enabled=case.endswith("_obs")),
        scenario=ScenarioConfig(name="class_incremental", modality="tokens", strategy=strategy,
                                num_tasks=2, batch_size=B, vocab_size=V, seq_len=S,
                                auto_defaults=False))
    built = build_train_step(run, mesh, scenario=TokenClassIncremental(run.scenario),
                             exchange="full", buffer_budget_bytes=None, device="cpu")
    params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
    prefix = f"{{case}}/params0/"
    load_named(params, {{k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}})
    for s in range(STEPS):
        p = f"{{case}}/s{{s}}/w{{rank}}/rows/"
        rows = ExchangeRows(
            UpdateSampleRows(*(torch.from_numpy(np.array(ref[p + n]))
                               for n in ("flat", "counts", "seen", "samp", "sv"))),
            torch.from_numpy(np.array(ref[p + "take"])).long())
        batch = shard_host_batch({{k: ref[f"{{case}}/s{{s}}/batch/{{k}}"]
                                  for k in ("tokens", "labels", "task")}}, mesh)
        params, opt, buf, reps, valid, m = built.fn(params, opt, buf, reps, valid, batch, 0,
                                                    rows=rows)
        out.update({{f"{{case}}/s{{s}}/{{k}}": float(m[k])
                    for k in ("loss", "rep_checksum", "buffer_fill")}})
        out.update({{f"{{case}}/s{{s}}/{{k}}": v for k, v in read_gauges(m).items()}})
        out.update({{f"{{case}}/s{{s}}/buffer/{{k}}": v.numpy().copy()
                    for k, v in buf.data.items()}})
        out.update({{f"{{case}}/s{{s}}/reps/{{k}}": v.numpy().copy() for k, v in reps.items()}})
        out[f"{{case}}/s{{s}}/valid"] = valid.numpy().copy()
        if s < 2:
            out.update({{f"{{case}}/params{{s + 1}}/{{k}}": v.detach().numpy().copy()
                        for k, v in params.named_parameters()}})
        if s == 0:
            out.update({{f"{{case}}/mu1/{{k}}": v.numpy().copy() for k, v in opt.mu.items()}})
np.savez(out_path, **out)
del built, params, opt, buf, reps, valid
import gc
gc.collect()
dist.destroy_process_group()
"""


def _run_all(procs, timeout=600):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("worker timed out")
        assert p.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """The JAX route's 3 steps of every case on a 2-device CPU mesh, then the
    port's on 2 gloo ranks fed its rows; ``(reference, [rank 0, rank 1])``."""
    tmp = tmp_path_factory.mktemp("mesh_parity")
    fmt = dict(V=V, S=S, B=B, N=N, STEPS=STEPS, CASES=CASES)
    ref_path = str(tmp / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
    _run_all([subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE.format(**fmt)),
                                ref_path], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    code = textwrap.dedent(PORT_SIDE.format(**fmt))
    rendezvous = str(tmp / "rendezvous")
    _run_all([subprocess.Popen([sys.executable, "-c", code, str(r), str(N), rendezvous,
                                ref_path, str(tmp / f"rank{r}.npz")], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(N)])
    return np.load(ref_path), [np.load(str(tmp / f"rank{r}.npz")) for r in range(N)]


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_pjit_route(case, two_rank_runs):
    from repro.configs.base import TrainConfig as JTrain
    from repro.optim import make_optimizer as jmake_optimizer

    ref, ranks = two_rank_runs
    for s in range(STEPS):
        for got in ranks:  # every rank reports the global metrics
            assert abs(got[f"{case}/s{s}/loss"] - ref[f"{case}/s{s}/loss"]) <= 1e-5 * abs(
                ref[f"{case}/s{s}/loss"]), (s, float(got[f"{case}/s{s}/loss"]))
            for k in ("rep_checksum", "buffer_fill"):
                assert float(got[f"{case}/s{s}/{k}"]) == float(ref[f"{case}/s{s}/{k}"]), (s, k)
        for w, got in enumerate(ranks):
            for part in ("buffer", "reps"):
                names = [f.split("/")[-1] for f in ref.files
                         if f.startswith(f"{case}/s{s}/w{w}/{part}/")]
                assert names and len(names) == len(
                    [f for f in got.files if f.startswith(f"{case}/s{s}/{part}/")])
                for name in names:
                    a, b = got[f"{case}/s{s}/{part}/{name}"], ref[f"{case}/s{s}/w{w}/{part}/{name}"]
                    if name == "logits":  # the two frameworks' forwards
                        _close(a, b, 1e-4, f"{part} {name} step {s} rank {w}")
                    else:
                        np.testing.assert_array_equal(a, b, err_msg=f"{part} {name} {s} {w}")
            np.testing.assert_array_equal(got[f"{case}/s{s}/valid"], ref[f"{case}/s{s}/w{w}/valid"])
    assert float(ref[f"{case}/s{STEPS - 1}/rep_checksum"]) > 0
    got = ranks[0]
    p0 = {f.split("/")[-1]: ref[f] for f in ref.files if f.startswith(f"{case}/params0/")}
    # the first step's moments are the global gradient (clipped); the
    # reference's AdamW on the port's gradient gives the port's update
    _, jupdate = jmake_optimizer(JTrain(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                        linear_scaling=False), n_workers=N)
    grads = {k: got[f"{case}/mu1/{k}"] / np.float32(0.1) for k in p0}
    zeros = {k: np.zeros_like(v) for k, v in p0.items()}
    from repro.optim.optimizers import OptState as JOpt

    new, _, _ = jupdate(grads, JOpt(jnp.zeros((), jnp.int32), zeros, zeros), p0)
    for k in p0:
        _close(got[f"{case}/mu1/{k}"], ref[f"{case}/mu1/{k}"], 1e-4, f"mu {k}")
        _close(got[f"{case}/params1/{k}"] - p0[k], np.asarray(new[k]) - p0[k], 1e-6,
               f"update {k}")
        _close(got[f"{case}/params2/{k}"], ref[f"{case}/params2/{k}"], 1e-4, f"params {k}")
        np.testing.assert_array_equal(got[f"{case}/params2/{k}"], ranks[1][f"{case}/params2/{k}"])


def test_two_ranks_obs_gauges_match_the_jax_pjit_route(two_rank_runs):
    """With ``run.obs`` on, every rank's gauges are the reference's global
    ones (its pjit state is ``[N_dp, K]``, the port's rank holds ``[K]``):
    the same keys, the buffer and replay gauges exactly (counts), and the
    norms within 1e-6 relative; and the case's fingerprints equal the
    obs-off pipelined case's (the parity test above holds the rest)."""
    ref, ranks = two_rank_runs
    keys = sorted(f.split("/", 2)[2] for f in ref.files
                  if f.startswith("pipelined_obs/s0/obs/"))
    assert "obs/fill" in keys and "obs/grad_norm" in keys and "obs/bucket_fill_max" in keys
    for s in range(STEPS):
        for got in ranks:
            assert sorted(f.split("/", 2)[2] for f in got.files
                          if f.startswith(f"pipelined_obs/s{s}/obs/")) == keys
            for k in keys:
                a, b = float(got[f"pipelined_obs/s{s}/{k}"]), float(ref[f"pipelined_obs/s{s}/{k}"])
                if k in ("obs/grad_norm", "obs/param_norm"):
                    assert abs(a - b) <= 1e-6 * abs(b), (s, k, a, b)
                else:
                    assert a == b, (s, k, a, b)
            for k in ("loss", "rep_checksum", "buffer_fill"):
                assert float(got[f"pipelined_obs/s{s}/{k}"]) == float(got[f"pipelined/s{s}/{k}"])
        assert float(ranks[0][f"pipelined_obs/s{s}/obs/fill"]) == float(
            ref[f"pipelined_obs/s{s}/buffer_fill"])
