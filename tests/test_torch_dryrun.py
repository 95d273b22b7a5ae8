"""The dry run (``repro_torch.launch.dryrun``), its roofline
(``repro_torch.analysis.roofline``) and the three ``TrainConfig`` fields
only the dry run sets, against the JAX package on the same inputs.

  * ``SHAPES``, ``cell_applicable`` and the fields' defaults equal the
    reference's;
  * one train step under ``param_dtype="bfloat16"`` against the reference's
    ``build_train_step`` with the same setting on a 1 x 1 mesh;
  * ``attn_impl`` picks the reference's attention path at each length;
  * the roofline's model flops, byte floors and cache bytes equal the
    reference's on every arch x shape (they do not depend on the peaks,
    which are the H100's here and the TPU's there), and its collective
    bytes equal ``parse_collectives`` on the reference's own ``HLO_SAMPLE``;
  * ``rehearsal_buffer_cost`` and ``_affine_scale`` equal the reference's;
  * the two-depth fit is exact at a third depth on the port's own counts;
  * one full-width cell, ``smollm-135m decode_32k single``, end to end;
  * the collectives the dry run records at 1 x 2 (a fake process group)
    are the calls the same step makes on two real gloo ranks.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_dryrun():
    """``repro.launch.dryrun`` imported with ``XLA_FLAGS`` restored (the
    module sets 512 host devices at import)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jd


def test_shapes_and_cell_applicable_equal_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cell_applicable as jcell
    from repro.configs import get_config as jconfig
    from repro_torch import configs

    assert list(configs.SHAPES) == list(JSHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])
    for arch in configs.ARCHS:
        for name in configs.SHAPES:
            assert configs.cell_applicable(configs.get_config(arch), configs.SHAPES[name]) == \
                jcell(jconfig(arch), JSHAPES[name]), (arch, name)


def test_the_three_fields_default_as_the_references():
    from repro.configs.base import TrainConfig as JTrain
    from repro_torch.configs import TrainConfig

    for field in ("param_dtype", "attn_impl", "kv_dtype"):
        assert getattr(TrainConfig(), field) == getattr(JTrain(), field), field


# ---------------------------------------------------------------------------
# param_dtype: one bf16-stored step against the reference's
# ---------------------------------------------------------------------------

PV, PS, PB = 128, 16, 4
LR = 0.1  # one step is 12 or more bf16 ulps of every parameter it moves (all below 2)


def _bf16_runs():
    from repro.configs import get_reduced as jreduced
    from repro.configs.base import RehearsalConfig as JReh
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import ScenarioConfig as JScen
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro_torch import configs
    from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig, TrainConfig

    train = dict(optimizer="adamw", peak_lr=LR, warmup_steps=0, linear_scaling=False,
                 compute_dtype="float32", param_dtype="bfloat16")
    scen = dict(name="class_incremental", modality="tokens", strategy="incremental",
                num_tasks=2, batch_size=PB, vocab_size=PV, seq_len=PS, auto_defaults=False)
    jcfg = dataclasses.replace(jreduced("smollm-135m"), vocab_size=PV, num_layers=2)
    jrun = JRun(model=jcfg, shape=JShape("parity", PS, PB, "train"), train=JTrain(**train),
                rehearsal=JReh(mode="off", label_field="labels"), scenario=JScen(**scen))
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=PV, num_layers=2)
    run = RunConfig(model=cfg, train=TrainConfig(**train),
                    rehearsal=RehearsalConfig(mode="off", label_field="labels"),
                    scenario=ScenarioConfig(**scen))
    return jrun, run


def _update_gap(got, init, want, grad):
    """Largest gap between the port's update (``got - init``) and the
    reference's (``want - init``) over the elements whose reference gradient
    is at least 1e-3 of the leaf's largest: below that an f32 rounding
    difference between the two backward passes can flip the sign of the
    gradient, and with it the sign of AdamW's first step."""
    keep = np.abs(grad) >= 1e-3 * np.abs(grad).max()
    return np.abs((got - init) - (want - init))[keep].max(), keep.mean()


def test_bf16_parameter_storage_steps_as_the_references():
    """``param_dtype="bfloat16"``: the port's ``build_train_step`` keeps the
    floating parameters in bf16 (the moments f32), as the reference's
    abstract state does. One AdamW step (f32 compute, lr 0.1) from the
    reference's initial weights rounded to bf16: the loss within 1e-5
    relative, and each parameter's update within 0.1 lr of the reference's
    update. The first AdamW step moves an element by about lr, so leaving a
    parameter unchanged, taking half the step or the wrong sign misses the
    bound by 0.9 lr or more; the bound still holds the two rounding the same
    f32 value to neighbouring bf16 values, one ulp (at most 2^-7 = 0.078 lr,
    every parameter being below 2). The reference's gradient is its first
    moment over (1 - b1); the elements it checks are at least 90% of each
    leaf, and an unchanged, halved and negated update each fail it."""
    from repro.launch.mesh import make_mesh as jmesh
    from repro.launch.steps import build_train_step as jbuild
    from repro.optim import make_optimizer
    from repro.scenario.trainer import materialize_state as jstate
    from repro.utils.compat import set_mesh
    from repro_torch.convert import load_named, lm_named_from_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.scenario import TokenClassIncremental
    from repro_torch.scenario.trainer import materialize_state

    def f32(tree):
        return lm_named_from_tree(jax.tree_util.tree_map(
            lambda p: np.asarray(p.astype(jnp.float32)), tree), run.model)

    jrun, run = _bf16_runs()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, PV, (PB, PS)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "task": np.zeros((PB,), np.int32)}
    mesh = jmesh((1, 1), ("data", "model"))
    with set_mesh(mesh):
        jbuilt = jbuild(jrun, mesh, exchange="full", donate=False)
        params, opt, _, _, _ = jstate(jbuilt, jrun, mesh, jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(
            lambda p: p.astype(jnp.bfloat16) if jnp.issubdtype(p.dtype, jnp.floating) else p,
            params)
        opt = jax.jit(make_optimizer(jrun.train, n_workers=1)[0])(params)
        init = f32(params)
        jparams, jopt, jm = jbuilt.fn(params, opt, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(1))
        want = f32(jparams)
        grad = {k: mu / (1 - 0.9) for k, mu in f32(jopt.mu).items()}
    assert float(jm["lr"]) == pytest.approx(LR)
    built = build_train_step(run, make_mesh((1, 1), ("data", "model"), "cpu"),
                             scenario=TokenClassIncremental(run.scenario), device="cpu")
    tparams, topt, _, _, _ = materialize_state(built, run, make_mesh((1, 1), ("data", "model"),
                                                                     "cpu"), 0)
    assert all(p.dtype == torch.bfloat16 for p in tparams.parameters())
    assert all(m.dtype == torch.float32 for m in topt.mu.values())
    load_named(tparams, init)
    tparams, _, m = built.fn(tparams, topt, batch, 0)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    bound = 0.1 * LR
    for k, p in tparams.named_parameters():
        got, x0, ref, g = p.detach().float().numpy(), init[k], want[k], grad[k]
        gap, kept = _update_gap(got, x0, ref, g)
        assert kept >= 0.9, (k, kept)
        assert gap <= bound, (k, gap, bound)
        for wrong in (x0, x0 + 0.5 * (ref - x0), x0 - (ref - x0)):  # unchanged, half, negated
            assert _update_gap(wrong, x0, ref, g)[0] > bound, k


@pytest.mark.parametrize("mode", ["auto", "blocked", "naive"])
def test_attn_impl_picks_the_references_path_at_each_length(mode, monkeypatch):
    """``TrainConfig.attn_impl`` set through ``build_prefill_step`` selects
    the blocked online-softmax path exactly where the reference's mode does
    (``auto``: from ``block_threshold`` keys on), at a KV length below and
    one at the threshold (lowered to 16 in both packages)."""
    import repro.models.attention as JA
    import repro_torch.models.attention as TA
    from repro.configs import get_reduced as jreduced
    from repro.models.layers import rope_angles  # noqa: F401  (the reference's module loaded)
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig, TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_prefill_step

    cfg = configs.get_reduced("smollm-135m")
    jcfg = jreduced("smollm-135m")
    calls = {"port": 0, "ref": 0}
    for mod, key in ((TA, "port"), (JA, "ref")):
        real = mod.attend_blocked

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "attend_blocked", spy)
        monkeypatch.setitem(mod.ATTN_IMPL, "block_threshold", 16)
        monkeypatch.setitem(mod.ATTN_IMPL, "block_k", 8)
    build_prefill_step(RunConfig(model=cfg, train=TrainConfig(attn_impl=mode)),
                       make_mesh((1, 1), ("data", "model"), "cpu"))
    assert TA.ATTN_IMPL["mode"] == mode
    monkeypatch.setitem(JA.ATTN_IMPL, "mode", mode)  # the reference's builders' assignment
    jparams = JA.init_attention(jax.random.PRNGKey(0), jcfg)
    tparams = TA.init_attention(torch.Generator().manual_seed(0), cfg)
    for s in (8, 16):
        before = dict(calls)
        x = np.random.default_rng(s).standard_normal((1, s, cfg.d_model)).astype(np.float32)
        JA.attend_full(jparams, jnp.asarray(x), jcfg)
        TA.attend_full(tparams, torch.from_numpy(x), cfg)
        assert calls["port"] - before["port"] == calls["ref"] - before["ref"], (mode, s)
        assert (calls["port"] > before["port"]) == (mode == "blocked" or (
            mode == "auto" and s >= 16))


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------


def test_roofline_counts_equal_the_references_on_every_arch_and_shape():
    """Model flops, byte floors, cache bytes and ideal times (times the
    peaks, which differ by design) on every arch x shape, at 256 and 512
    chips over a model axis of 16."""
    from repro.analysis import roofline as jrl
    from repro.configs import get_config as jconfig
    from repro_torch import configs
    from repro_torch.analysis import roofline as rl

    for arch in configs.ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfig(arch)
        for shape in configs.SHAPES.values():
            tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
            for chips in (256, 512):
                args = (shape.kind, tokens, shape.seq_len)
                assert rl.estimate_model_flops(cfg, *args) == jrl.estimate_model_flops(
                    jcfg, *args)
                cb = rl.cache_bytes_total(cfg, shape.global_batch, shape.seq_len)
                assert cb == jrl.cache_bytes_total(jcfg, shape.global_batch, shape.seq_len)
                assert rl.estimate_min_bytes_per_chip(cfg, *args, chips, 16, cb) == \
                    jrl.estimate_min_bytes_per_chip(jcfg, *args, chips, 16, cb)
                c, m = rl.ideal_seconds(cfg, *args, chips, 16, shape.global_batch)
                jc, jm = jrl.ideal_seconds(jcfg, *args, chips, 16, shape.global_batch)
                assert c * rl.PEAK_FLOPS == pytest.approx(jc * jrl.PEAK_FLOPS, rel=1e-12)
                assert m * rl.HBM_BW == pytest.approx(jm * jrl.HBM_BW, rel=1e-12)


def test_roofline_constants_are_the_h100s():
    from repro_torch.analysis import roofline as rl

    assert (rl.PEAK_FLOPS, rl.PEAK_FLOPS_TF32, rl.PEAK_FLOPS_F32) == (989e12, 495e12, 67e12)
    assert (rl.HBM_BW, rl.LINK_BW) == (3.35e12, 450e9)
    assert rl.peak_flops("float32") == 67e12 and rl.peak_flops("bfloat16") == 989e12


def test_collective_bytes_equal_parse_collectives_on_the_references_sample():
    """The reference's ``HLO_SAMPLE`` (``tests/test_roofline.py``) as the
    recorded calls it holds: each kind's bytes and count equal
    ``parse_collectives``' (collective-permute is the port's send/recv)."""
    from repro.analysis import roofline as jrl
    from repro_torch.analysis import roofline as rl

    spec = importlib.util.spec_from_file_location(
        "reference_roofline_test", os.path.join(REPO, "tests", "test_roofline.py"))
    sample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sample)
    calls = [rl.Collective("all-reduce", 1024 * 512 * 4, 16),
             rl.Collective("all-gather", 2048 * 128 * 2, 4),
             rl.Collective("reduce-scatter", 64 * 64 * 4, 8),
             rl.Collective("all-to-all", 32 * 16 * 4, 32),
             rl.Collective("send/recv", 256 * 2, 2),
             rl.Collective("all-reduce", 8 * 8 * 4, 4)]
    got = rl.collective_bytes(calls)
    want = jrl.parse_collectives(sample.HLO_SAMPLE)
    want["send/recv"] = want.pop("collective-permute")
    assert got == want
    s1, s2 = 1024 * 512 * 4, 8 * 8 * 4
    assert abs(got["all-reduce"]["bytes"] - (2 * s1 * 15 / 16 + 2 * s2 * 3 / 4)) < 1
    assert abs(got["reduce-scatter"]["bytes"] - 64 * 64 * 4 * 7) < 1


def test_rehearsal_buffer_cost_equals_the_references():
    """On ``tests/test_scenario.py``'s inputs (a record of 128 int32 tokens
    and 64 f32 values; flat 4 x 16, tiered 16 hot + 48 cold slots, off):
    every entry equals the reference's but ``cold_placement``, which names
    where this process puts the cold tier (the reference's caveat)."""
    import types

    from repro.configs.base import RehearsalConfig as JReh
    from repro_torch.buffer.state import ItemSpec
    from repro_torch.configs.base import RehearsalConfig
    from repro_torch.launch.dryrun import rehearsal_buffer_cost

    jd = _jax_dryrun()
    reps = {"tokens": jax.ShapeDtypeStruct((2, 7, 128), jnp.int32),
            "x": jax.ShapeDtypeStruct((2, 7, 64), jnp.float32)}
    meta = {"mode": "async", "slots_per_bucket": 16}
    jbuilt = types.SimpleNamespace(meta=meta, args=(0, 0, 0, reps, 0))
    built = types.SimpleNamespace(meta=meta, item_spec={
        "tokens": ItemSpec((128,), torch.int32), "x": ItemSpec((64,), torch.float32)})
    for kw in (dict(num_buckets=4, mode="async"),
               dict(num_buckets=4, mode="async", tiering="host", hot_slots=16, cold_slots=48)):
        got = rehearsal_buffer_cost(built, RehearsalConfig(**kw))
        want = jd.rehearsal_buffer_cost(jbuilt, JReh(**kw))
        got.pop("cold_placement"), want.pop("cold_placement")
        assert got == want, kw
    off = types.SimpleNamespace(meta={"mode": "off"}, args=(), item_spec={})
    assert rehearsal_buffer_cost(off, RehearsalConfig(mode="off")) == \
        jd.rehearsal_buffer_cost(off, JReh(mode="off"))


def test_affine_scale_equals_the_references():
    """The scaled primitives (flops, bytes, collective bytes and counts,
    memory) of ``_affine_scale`` on the same two records equal the
    reference's; the derived times use each package's peaks."""
    from repro_torch.launch.dryrun import _affine_scale

    jd = _jax_dryrun()

    def rec(f, b, c, mem):
        return {"flops_per_chip": f, "bytes_per_chip": b, "collective_bytes_per_chip": c,
                "per_collective": {"all-reduce": {"bytes": c, "count": 3}},
                "memory_analysis": {"argument_bytes": mem, "output_bytes": 8,
                                    "temp_bytes": mem // 2, "peak_bytes": mem * 2},
                "chips": 256, "model_flops": 5e15, "compile_s": 1.0, "run_s": 1.0}

    r1, r2 = rec(1e12, 3e11, 2e9, 1000), rec(1.9e12, 5e11, 3e9, 1600)
    got, want = _affine_scale(r1, r2, 4, 8, 32), jd._affine_scale(r1, r2, 4, 8, 32)
    for k in ("flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
              "per_collective", "memory_analysis", "useful_ratio"):
        assert got[k] == want[k], k


def test_two_depth_fit_is_exact_at_a_third_depth():
    """The port's counts of a reduced SmolLM-135M train step (flops, bytes,
    collective bytes) at 1, 2 and 3 layers on a fake 2 x 2 mesh: the line
    through the first two meets the third exactly. The reference's docstring
    cites a test of the same claim the repo does not have."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_step

    base = configs.get_reduced("smollm-135m")
    shape = ShapeConfig("fit", 32, 8, "train")
    counts = []
    for depth in (1, 2, 3):
        c = count_step(dataclasses.replace(base, num_layers=depth), shape, (2, 2),
                       ("data", "model"), remat="none")
        counts.append((c["flops"], c["bytes"], sum(b for _, b, _ in c["collectives"])))
    for one, two, three in zip(*counts):
        assert three == one + 2 * (two - one), (one, two, three)


def test_one_full_width_cell_runs_end_to_end(tmp_path):
    """``smollm-135m decode_32k single``: rank 0 of the (16, 16) mesh in a
    fake group of 256. Its caches are 8 rows (128 over 16 data ranks) of
    2048 slots (32768 over the 16 model ranks: 3 KV heads do not divide 16)
    of every KV head: 377,487,360 bytes over 30 layers."""
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("smollm-135m", "decode_32k", False, out_dir=str(tmp_path))
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory_analysis"]["arguments"]["caches"] == 377_487_360
    assert rec["meta"]["kv_seq"] == {"k": ["model"]}
    assert rec["flops_per_chip"] > 0 and rec["per_collective"]["all-reduce"]["count"] > 0
    assert json.loads((tmp_path / "smollm-135m__decode_32k__single.json").read_text())[
        "cell"] == "smollm-135m__decode_32k__single"


RANK_SIDE = """
import json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, rendezvous, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=2)
from repro_torch import configs
from repro_torch.configs import ShapeConfig
from repro_torch.launch.dryrun import count_step
out = {}
for kind, (b, s) in {CELLS}.items():
    cfg = configs.get_reduced("smollm-135m")
    c = count_step(cfg, ShapeConfig("x", s, b, kind), (1, 2), ("data", "model"), rank=rank,
                   fake=False)
    out[kind] = c["collectives"]
json.dump(out, open(out_path, "w"))
dist.destroy_process_group()
"""
CELLS = {"decode": (2, 16), "prefill": (2, 16), "train": (4, 16)}


def test_dry_run_records_the_collectives_of_real_ranks(tmp_path):
    """At 1 x 2: the ``c10d`` calls (kind, bytes, group) the dry run records
    for a reduced SmolLM-135M decode, prefill and train step in a fake
    group of 2 equal those the same step makes on two real gloo ranks,
    call for call."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_step

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    code = textwrap.dedent(RANK_SIDE.replace("{CELLS}", repr(CELLS)))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path / "rdv"),
                               str(tmp_path / f"rank{r}.json")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    cfg = configs.get_reduced("smollm-135m")
    for kind, (b, s) in CELLS.items():
        fake = count_step(cfg, ShapeConfig("x", s, b, kind), (1, 2), ("data", "model"))
        want = [list(c) for c in fake["collectives"]]
        assert want, kind
        for r in range(2):
            got = json.loads((tmp_path / f"rank{r}.json").read_text())[kind]
            assert got == want, (kind, r)
