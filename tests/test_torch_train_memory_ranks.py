"""The train step's memory knobs on spawned gloo ranks (a file rendezvous in
the test's temporary directory), against the JAX package and against the
port's own run without the knob.

  * Training: ``build_train_step`` with ``TrainConfig.zero1`` on 2 x 1 and
    2 x 2 meshes, ``sequence_parallel`` on 1 x 2 (the reduced SmolLM-135M
    and Mamba2-370M) and 2 x 2, and both on 2 x 2, 2
    pipelined steps with a flat buffer, against JAX's ``build_train_step``
    with the same ``TrainConfig`` on a CPU mesh of that shape (subprocesses
    with ``XLA_FLAGS``), the JAX row vectors and exchange picks fed through
    the ``rows`` seam. The bounds of ``test_torch_model_axis_ranks.py``'s
    (d): the loss within 1e-5 relative, the buffers, the pending slot,
    ``buffer_fill`` and ``rep_checksum`` exactly, the parameters after 2
    steps within 1e-4 of each tensor's largest entry. ZeRO-1's moments are
    each rank's slice of JAX's (within 1e-4), half of them on D = 2. Each
    knob's parameters are within 1e-6 of each tensor's largest entry of
    the same port run without it, and the replicated parameters (norms,
    router, the ZeRO-1 slices' gathered whole) are bit-equal on every rank.
  * Gradients: one loss with and without ``sequence_parallel`` on 1 x 2
    and 1 x 4 for the blocks the port runs whole, the MoE (its router on
    the gathered tokens) and the hybrid stack. The MoE is not trained
    against JAX here, as in the model axis's (d): its steps already differ
    from JAX's by 1e-5 of the loss without the knob.
  * Prefill: ``build_prefill_step`` with ``sequence_parallel`` on 1 x 2 and
    1 x 4, every family (the reduced configs, heads that split and heads
    that do not, MoE expert- and hidden-sharded, hybrid, VLM), its logits
    against the same step without it: bit for bit at M = 2, within 1e-6 of
    the largest |logit| at M = 4 (routing pinned to the run without).
  * A ZeRO-1 ``ContinualTrainer(mesh=2x1)`` under the ``ResilientLoop``
    whose rank 0 fails before a step restarts and ends bit for bit on the
    clean run's state.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

V, S, B, STEPS = 128, 16, 8, 2
ARCHS = {"dense": "smollm-135m", "ssm": "mamba2-370m"}
KNOBS = {"zero1": dict(zero1=True), "sp": dict(sequence_parallel=True),
         "both": dict(zero1=True, sequence_parallel=True)}
# (knob, case) of each mesh
VARIANTS = {(2, 1): (("zero1", "dense"),),
            (1, 2): (("sp", "dense"), ("sp", "ssm")),
            (2, 2): (("zero1", "dense"), ("sp", "dense"), ("both", "dense"))}
PREFILL = {"smollm": ("smollm-135m", {}), "smollm_6h": ("smollm-135m", dict(num_heads=6,
                                                                            num_kv_heads=3)),
           "mamba2": ("mamba2-370m", {}), "gemma": ("gemma-2b", {}),
           "mixtral_ep": ("mixtral-8x7b", {}), "mixtral_tp": ("mixtral-8x7b",
                                                              dict(num_experts=3)),
           "jamba": ("jamba-v0.1-52b", {}), "qwen2_vl": ("qwen2-vl-72b", {})}
PREFILL_SIZES = (2, 4)
# one loss and its gradients with and without sequence parallelism: the
# blocks the port runs whole and the MoE's router on the gathered tokens
GRADS = {"smollm_6h": ("smollm-135m", dict(num_heads=6, num_kv_heads=3, num_layers=2)),
         "mixtral_ep": ("mixtral-8x7b", dict(num_layers=2)),
         "mixtral_tp": ("mixtral-8x7b", dict(num_experts=3, num_layers=2)),
         "jamba": ("jamba-v0.1-52b", {})}

JAX_SIDE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.buffer import state as jstate
from repro.configs import get_reduced
from repro.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig, ShapeConfig,
                                StrategyConfig, TrainConfig)
from repro.data import TaskTokenStream, TokenStreamConfig
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.scenario.trainer import materialize_state
from repro.utils.compat import set_mesh
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_named_from_tree

V, S, B, D, M, STEPS = {V}, {S}, {B}, {D}, {M}, {STEPS}
ARCHS, KNOBS, VARIANTS = {ARCHS}, {KNOBS}, {VARIANTS}
stream = TaskTokenStream(TokenStreamConfig(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
mesh = make_mesh((D, M), ("data", "model"))
out, bw = {{}}, B // D

for knob, case in VARIANTS:
    pre = f"{{knob}}/{{case}}"
    cfg = dataclasses.replace(get_reduced(ARCHS[case]), vocab_size=V, num_layers=2)
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCHS[case]), vocab_size=V, num_layers=2)

    def named(tree):
        return lm_named_from_tree(jax.tree_util.tree_map(np.asarray, tree), tcfg)

    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                           num_candidates=6, mode="async", label_field="labels")
    run = RunConfig(model=cfg, shape=ShapeConfig("parity", S, B, "train"),
                    train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                      linear_scaling=False, compute_dtype="float32",
                                      **KNOBS[knob]),
                    rehearsal=rcfg, strategy=StrategyConfig(),
                    scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                            strategy="rehearsal", num_tasks=2, batch_size=B,
                                            vocab_size=V, seq_len=S, auto_defaults=False))
    with set_mesh(mesh):
        built = build_train_step(run, mesh, exchange="full", buffer_budget_bytes=None,
                                 donate=False)
        key = jax.random.PRNGKey(0)
        params, opt, buf, reps, valid = materialize_state(built, run, mesh, key)
        out.update({{f"{{pre}}/params0/{{k}}": v for k, v in named(params).items()}})
        issue_key = key
        for s in range(STEPS):
            batch = stream.batch(s % 2, B, s)
            plans = []
            for w in range(D):
                buf_w = jax.tree_util.tree_map(lambda x: x[w], buf)
                k_up, k_samp = jax.random.split(jax.random.fold_in(issue_key, w))
                flat, _, _, _, counts, seen = jstate.local_update_rows(
                    buf_w, jnp.asarray(batch["task"][w * bw:(w + 1) * bw]), k_up, 6)
                k_draw, k_pick = jax.random.split(k_samp)
                samp, sv = jstate.local_sample_rows(buf_w._replace(counts=counts), k_draw, D)
                plans.append((flat, counts, seen, samp, sv, k_pick))
            for w, (flat, counts, seen, samp, sv, k_pick) in enumerate(plans):
                recv_valid = jnp.stack([plans[j][4][w] for j in range(D)])
                scores = jax.random.uniform(k_pick, (D,)) + jnp.where(recv_valid, 0.0, 1e3)
                take = jnp.argsort(scores)[:3]
                for name, a in (("flat", flat), ("counts", counts), ("seen", seen),
                                ("samp", samp), ("sv", sv), ("take", take)):
                    out[f"{{pre}}/s{{s}}/w{{w}}/rows/{{name}}"] = np.asarray(a)
            out.update({{f"{{pre}}/s{{s}}/batch/{{k}}": v for k, v in batch.items()}})
            params, opt, buf, reps, valid, m = built.fn(
                params, opt, buf, reps, valid, {{k: jnp.asarray(v) for k, v in batch.items()}},
                issue_key)
            issue_key = jax.random.fold_in(key, s)
            for k in ("loss", "rep_checksum", "buffer_fill"):
                out[f"{{pre}}/s{{s}}/{{k}}"] = np.asarray(m[k])
            for w in range(D):
                for k, v in buf.data.items():
                    out[f"{{pre}}/s{{s}}/w{{w}}/buffer/{{k}}"] = np.asarray(v)[w]
                for k, v in reps.items():
                    out[f"{{pre}}/s{{s}}/w{{w}}/reps/{{k}}"] = np.asarray(v)[w]
                out[f"{{pre}}/s{{s}}/w{{w}}/valid"] = np.asarray(valid)[w]
        out.update({{f"{{pre}}/params{{STEPS}}/{{k}}": v for k, v in named(params).items()}})
        for mom in ("mu", "nu"):
            out.update({{f"{{pre}}/{{mom}}/{{k}}": v
                        for k, v in named(getattr(opt, mom)).items()}})
np.savez(sys.argv[1], **out)
"""

PORT_SIDE = """
import dataclasses, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rendezvous, ref_path, out_path, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                                                    sys.argv[3], sys.argv[4], sys.argv[5],
                                                    sys.argv[6])
dist.init_process_group("gloo", init_method=f"file://{{rendezvous}}", rank=rank,
                        world_size=world)
from repro_torch import configs
from repro_torch.buffer.state import UpdateSampleRows
from repro_torch.configs.base import (RehearsalConfig, ResilienceConfig, RunConfig,
                                      ScenarioConfig, StrategyConfig, TrainConfig)
from repro_torch.convert import load_named
from repro_torch.core.distributed import ExchangeRows
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_prefill_step, build_train_step, shard_host_batch
from repro_torch.models import StackCtx
from repro_torch.optim.optimizers import zero1_dims
from repro_torch.parallel import (dp_index, model_parallel, param_spec, seq_parallel,
                                  shard_param, zero1_group)
from repro_torch.scenario import ContinualTrainer, TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state
from repro_torch.testdata import family_batch, routing

V, S, B, D, M, STEPS = {V}, {S}, {B}, {D}, {M}, {STEPS}
ARCHS, KNOBS, VARIANTS, PREFILL, GRADS = {ARCHS}, {KNOBS}, {VARIANTS}, {PREFILL}, {GRADS}
ref = dict(np.load(ref_path)) if VARIANTS else {{}}
mesh = make_mesh((D, M), ("data", "model"))
mp, w = model_parallel(mesh), dp_index(mesh)
out = {{}}


def train_run(case, knobs):
    return RunConfig(
        model=dataclasses.replace(configs.get_reduced(ARCHS[case]), vocab_size=V, num_layers=2),
        train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                          linear_scaling=False, compute_dtype="float32", **knobs),
        rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                                  num_candidates=6, mode="async", label_field="labels"),
        strategy=StrategyConfig(),
        scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                strategy="rehearsal", num_tasks=2, batch_size=B, vocab_size=V,
                                seq_len=S, auto_defaults=False))


def steps(pre, run, tag):
    built = build_train_step(run, mesh, scenario=TokenClassIncremental(run.scenario),
                             exchange="full", buffer_budget_bytes=None, device="cpu")
    params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
    prefix = f"{{pre}}/params0/"
    full = {{k[len(prefix):]: ref[k] for k in ref if k.startswith(prefix)}}
    load_named(params, {{k: shard_param(v, param_spec(k, v.shape, run.model, M), mp)
                        for k, v in full.items()}})
    for s in range(STEPS):
        p = f"{{pre}}/s{{s}}/w{{w}}/rows/"
        rows = ExchangeRows(
            UpdateSampleRows(*(torch.from_numpy(np.array(ref[p + n]))
                               for n in ("flat", "counts", "seen", "samp", "sv"))),
            torch.from_numpy(np.array(ref[p + "take"])).long())
        batch = shard_host_batch({{k: ref[f"{{pre}}/s{{s}}/batch/{{k}}"]
                                  for k in ("tokens", "labels", "task")}}, mesh)
        params, opt, buf, reps, valid, m = built.fn(params, opt, buf, reps, valid, batch, 0,
                                                    rows=rows)
        q = f"{{pre}}/{{tag}}/s{{s}}/"
        out.update({{q + k: float(m[k]) for k in ("loss", "rep_checksum", "buffer_fill")}})
        out.update({{q + f"buffer/{{k}}": v.numpy().copy() for k, v in buf.data.items()}})
        out.update({{q + f"reps/{{k}}": v.numpy().copy() for k, v in reps.items()}})
        out[q + "valid"] = valid.numpy().copy()
    out.update({{f"{{pre}}/{{tag}}/params/{{k}}": v.detach().numpy().copy()
                for k, v in params.named_parameters()}})
    out[f"{{pre}}/{{tag}}/meta"] = np.array([built.meta[k] for k in ("zero1",
                                                                    "sequence_parallel")])
    named = dict(params.named_parameters())
    dims = zero1_dims(named, zero1_group(mesh) if run.train.zero1 else None,
                      params.layout_specs)
    for mom in ("mu", "nu"):
        for k, v in getattr(opt, mom).items():
            out[f"{{pre}}/{{tag}}/{{mom}}/{{k}}"] = v.numpy().copy()
    for k, d in dims.items():
        out[f"{{pre}}/{{tag}}/dim/{{k}}"] = np.array(d)
    out[f"{{pre}}/{{tag}}/moment_numel"] = np.array(
        [sum(v.numel() for v in opt.mu.values()), sum(p.numel() for p in named.values())])


def fed(pre):  # what a variant's steps are fed: initial parameters, batches, rows
    return {{k[len(pre):]: v for k, v in ref.items()
            if k.startswith(pre) and ("/params0/" in k or "/batch/" in k or "/rows/" in k)}}


if ref:
    done = {{}}  # the run without a knob, once a case when its feed is the same
    for knob, case in VARIANTS:
        pre = f"{{knob}}/{{case}}"
        steps(pre, train_run(case, KNOBS[knob]), "knob")
        same = done.get(case)
        if same is not None and fed(same + "/").keys() == fed(pre + "/").keys() and all(
                np.array_equal(v, fed(pre + "/")[k]) for k, v in fed(same + "/").items()):
            out.update({{pre + k[len(same):]: v for k, v in list(out.items())
                        if k.startswith(same + "/base/")}})
        else:
            steps(pre, train_run(case, {{}}), "base")
            done[case] = pre

# the prefill with and without sequence parallelism, on a model row of M
if D == 1:
    for case, (arch, over) in PREFILL.items():
        cfg = dataclasses.replace(configs.get_reduced(arch), **over)
        batch = {{k: torch.from_numpy(v) for k, v in family_batch(cfg, 2, S, seed=1).items()
                  if k != "labels"}}
        got = {{}}
        for sp in (False, True):
            run = RunConfig(model=cfg, train=TrainConfig(compute_dtype="float32",
                                                         sequence_parallel=sp),
                            scenario=ScenarioConfig(modality="tokens", batch_size=2,
                                                    seq_len=S))
            built = build_prefill_step(run, mesh)
            params = built.model.init(torch.Generator().manual_seed(0), S, "cpu", built.ctx.mp)
            if not sp:
                with routing() as pins:
                    got[sp] = built.fn(params, batch)
            else:
                with routing(pins):
                    got[sp] = built.fn(params, batch)
        out[f"prefill/{{case}}/off"], out[f"prefill/{{case}}/on"] = got[False].numpy(), \\
            got[True].numpy()
    # one loss and its gradients, the slice-local leaves' parts summed over
    # the row as the train step sums them
    from repro_torch.launch.steps import _sum_over
    from repro_torch.models import build_model
    from repro_torch.parallel import seq_partial
    for case, (arch, over) in GRADS.items():
        cfg = dataclasses.replace(configs.get_reduced(arch), vocab_size=V, **over)
        lm = build_model(cfg)
        batch = {{k: torch.from_numpy(v) for k, v in family_batch(cfg, 4, S, seed=2).items()}}
        for sp in (False, True):
            params = lm.init(torch.Generator().manual_seed(0), S, "cpu", mp)
            loss, metrics = lm.loss(params, batch, StackCtx(cfg=cfg, mp=seq_parallel(mp, sp),
                                                            remat="dots"))
            loss.backward()
            grads = {{k: p.grad for k, p in params.named_parameters()}}
            if sp:
                grads.update(_sum_over({{k: g for k, g in grads.items() if seq_partial(k)}},
                                       mp.group))
            tag = f"grads/{{case}}/{{'on' if sp else 'off'}}"
            out[tag + "/loss"] = np.array([float(loss), float(metrics["aux"])])
            out.update({{f"{{tag}}/{{k}}": g.numpy().copy() for k, g in grads.items()}})

# a ZeRO-1 trainer on 2 x 1 under the ResilientLoop: clean, and rank 0 failing
if D == 2 and M == 1:
    from repro_torch.runtime import InjectedFailure

    run = train_run("dense", KNOBS["zero1"])
    run = dataclasses.replace(run, scenario=dataclasses.replace(run.scenario,
                                                                steps_per_epoch=3))

    def resilient(name, fail_at=None):
        fired = []

        def hook(s):
            if rank == 0 and s == fail_at and not fired:
                fired.append(s)
                raise InjectedFailure(f"rank 0 before step {{s}}")

        trainer = ContinualTrainer(run, device="cpu", mesh=mesh, exchange="full",
                                   ckpt_dir=os.path.join(tmp, name),
                                   resilience=ResilienceConfig(checkpoint_every=2,
                                                               max_restarts=2),
                                   overrides={{"failure_hook": hook}})
        r = trainer.fit()
        params, opt = trainer.final_state[0], trainer.final_state[1]
        state = {{"p/" + k: v.detach().numpy().copy() for k, v in params.named_parameters()}}
        state.update({{f"{{m}}/{{k}}": v.numpy().copy() for m in ("mu", "nu")
                      for k, v in getattr(opt, m).items()}})
        return r, state

    clean, clean_state = resilient("clean")
    failed, failed_state = resilient("failed", fail_at=3)
    out["resilient/restarts"] = np.array(failed.restarts)
    out["resilient/losses_equal"] = np.array(failed.losses == clean.losses)
    out["resilient/state_equal"] = np.array(set(clean_state) == set(failed_state) and all(
        np.array_equal(clean_state[k], failed_state[k]) for k in clean_state))
    out["resilient/sliced"] = np.array(sum(
        clean_state[k].size for k in clean_state if k.startswith("mu/")))
np.savez(out_path, **out)
import gc
gc.collect()
dist.destroy_process_group()
"""


def _spawn(code, args, env):
    return subprocess.Popen([sys.executable, "-c", code] + [str(a) for a in args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _run_all(procs, timeout=600):
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("worker timed out")
        assert p.returncode == 0, err[-4000:]


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX train steps (a subprocess a mesh, on fake devices)
    beside the 1 x 4 prefill and gradient ranks, then the port's 2 x 1, 1 x
    2 and 2 x 2 train ranks at once (1 x 2 also runs the prefill and
    gradient comparisons, 2 x 1 the resilient trainer). Returns ``({mesh:
    JAX reference arrays}, {mesh: [each rank's arrays]})``."""
    tmp = tmp_path_factory.mktemp("train_memory")
    src = os.path.join(REPO, "src")
    fmt = dict(V=V, S=S, B=B, STEPS=STEPS, ARCHS=ARCHS, KNOBS=KNOBS, GRADS=GRADS)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")

    def port_group(dm, variants):
        d, m = dm
        code = textwrap.dedent(PORT_SIDE.format(D=d, M=m, VARIANTS=variants, PREFILL=PREFILL,
                                                **fmt))
        return [_spawn(code, [r, d * m, tmp / f"rdv_{d}x{m}", tmp / f"ref_{d}x{m}.npz",
                              tmp / f"{d}x{m}_{r}.npz", tmp / f"ckpt_{d}x{m}"], env)
                for r in range(d * m)]

    # one JAX process a mesh, beside the 1 x 4 ranks (which need no reference)
    procs = port_group((1, 4), ())
    for (d, m), variants in VARIANTS.items():
        jenv = dict(env, JAX_PLATFORMS="cpu",
                    XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}")
        code = textwrap.dedent(JAX_SIDE.format(D=d, M=m, VARIANTS=variants, **fmt))
        procs.append(_spawn(code, [tmp / f"ref_{d}x{m}.npz"], jenv))
    _run_all(procs)
    _run_all([p for dm, variants in VARIANTS.items() for p in port_group(dm, variants)])
    refs = {(d, m): dict(np.load(tmp / f"ref_{d}x{m}.npz")) for d, m in VARIANTS}
    return (refs, {dm: [np.load(tmp / f"{dm[0]}x{dm[1]}_{r}.npz")
                        for r in range(dm[0] * dm[1])] for dm in list(VARIANTS) + [(1, 4)]})


TRAIN = [(dm, knob, case) for dm, variants in VARIANTS.items() for knob, case in variants]


def _train_ids(t):
    (d, m), knob, case = t
    return f"{d}x{m}-{knob}-{case}"


@pytest.mark.parametrize("dm,knob,case", TRAIN, ids=[_train_ids(t) for t in TRAIN])
def test_knob_matches_jax_build_train_step(dm, knob, case, runs):
    """The knob's run against JAX's ``build_train_step`` under the same
    ``TrainConfig``: the bounds of the model axis's (d)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.parallel import ModelParallel, param_spec, shard_param

    d, m = dm
    ref, ranks = runs[0][dm], runs[1][dm]
    pre = f"{knob}/{case}"
    cfg = dataclasses.replace(configs.get_reduced(ARCHS[case]), vocab_size=V, num_layers=2)
    for r, got in enumerate(ranks):
        want_meta = [KNOBS[knob].get("zero1", False) and d > 1,
                     KNOBS[knob].get("sequence_parallel", False) and m > 1]
        assert got[f"{pre}/knob/meta"].tolist() == want_meta
        w = r // m
        for s in range(STEPS):
            q = f"{pre}/knob/s{s}/"
            want = float(ref[f"{pre}/s{s}/loss"])
            assert abs(got[q + "loss"] - want) <= 1e-5 * abs(want), (s, r, float(got[q + "loss"]))
            for k in ("rep_checksum", "buffer_fill"):
                assert float(got[q + k]) == float(ref[f"{pre}/s{s}/{k}"]), (s, k)
            for part in ("buffer", "reps"):
                names = [f.split("/")[-1] for f in ref
                         if f.startswith(f"{pre}/s{s}/w{w}/{part}/")]
                assert names
                for name in names:
                    np.testing.assert_array_equal(got[q + f"{part}/{name}"],
                                                  ref[f"{pre}/s{s}/w{w}/{part}/{name}"])
            np.testing.assert_array_equal(got[q + "valid"], ref[f"{pre}/s{s}/w{w}/valid"])
        mp = ModelParallel(None, m, r % m)
        for f in ref:
            for part in (f"params{STEPS}", "mu", "nu"):
                if not f.startswith(f"{pre}/{part}/"):
                    continue
                name = f[len(f"{pre}/{part}/"):]
                want = shard_param(ref[f], param_spec(name, ref[f].shape, cfg, m), mp)
                if part in ("mu", "nu") and f"{pre}/knob/dim/{name}" in got.files:
                    dim = int(got[f"{pre}/knob/dim/{name}"])
                    n = want.shape[dim] // d
                    want = np.take(want, range(w * n, (w + 1) * n), axis=dim)
                key = f"{pre}/knob/{'params' if part.startswith('params') else part}/{name}"
                _close(got[key], want, 1e-4, f"{key} rank {r}")


@pytest.mark.parametrize("dm,knob,case", TRAIN, ids=[_train_ids(t) for t in TRAIN])
def test_knob_keeps_the_run_without_it(dm, knob, case, runs):
    """The knob changes where the state lives, not the step: every
    parameter within 1e-6 of its largest entry of the port's run without
    the knob on the same mesh, and the losses within 1e-6 relative. The
    replicated parameters (the rule table's) are bit-equal on every rank.
    Under ZeRO-1 a rank's moment of a parameter it cuts holds 1 / D of
    the parameter's elements, and its moments hold exactly those slices
    and the uncut moments whole."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.parallel import param_spec

    d, m = dm
    ref, ranks = runs[0][dm], runs[1][dm]
    pre = f"{knob}/{case}"
    cfg = dataclasses.replace(configs.get_reduced(ARCHS[case]), vocab_size=V, num_layers=2)
    full = {f[len(f"{pre}/params0/"):]: ref[f].shape for f in ref
            if f.startswith(f"{pre}/params0/")}
    assert full
    replicated = [n for n, shape in full.items() if "model" not in param_spec(n, shape, cfg, m)]
    for r, got in enumerate(ranks):
        for name in full:
            _close(got[f"{pre}/knob/params/{name}"], got[f"{pre}/base/params/{name}"], 1e-6,
                   f"{pre} {name} rank {r}")
        for s in range(STEPS):
            a, b = float(got[f"{pre}/knob/s{s}/loss"]), float(got[f"{pre}/base/s{s}/loss"])
            assert abs(a - b) <= 1e-6 * abs(b), (s, a, b)
        for name in replicated:
            np.testing.assert_array_equal(got[f"{pre}/knob/params/{name}"],
                                          ranks[0][f"{pre}/knob/params/{name}"],
                                          err_msg=f"{pre} {name} rank {r}")
        cut = {f[len(f"{pre}/knob/dim/"):] for f in got.files
               if f.startswith(f"{pre}/knob/dim/")}
        assert bool(cut) == bool(KNOBS[knob].get("zero1"))
        sizes = {n: got[f"{pre}/knob/params/{n}"].size for n in full}
        for name in cut:
            assert got[f"{pre}/knob/mu/{name}"].size * d == sizes[name], name
            assert got[f"{pre}/knob/nu/{name}"].size * d == sizes[name], name
        numel, whole = got[f"{pre}/knob/moment_numel"].tolist()
        assert whole == sum(sizes.values())
        assert numel == sum(sizes[n] // d if n in cut else sizes[n] for n in sizes)


@pytest.mark.parametrize("m", PREFILL_SIZES)
@pytest.mark.parametrize("case", list(GRADS))
def test_sequence_parallel_gradients_match_the_loss_without_it(case, m, runs):
    """One loss (activations checkpointed, ``dots``) and its gradients with
    and without sequence parallelism: the blocks the port runs whole
    (attention whose heads do not split), the MoE expert- and
    hidden-sharded with its router reading the gathered tokens
    (``keep_own_grad``), and the hybrid stack. The loss and aux bit for bit
    at M = 2 and within 1e-6 at M = 4; every gradient within 1e-4 of its
    tensor's largest entry (the bound of the LM gradients against
    ``jax.grad`` in ``test_torch_lm_train.py``), the slice-local leaves'
    (norms) once their parts are summed over the row. The backward's sums
    run in another order (a reduce-scatter where an all-reduce was): the
    readings here are at most 1.2e-6 at M = 2 and 1.5e-5 at M = 4 (Jamba's
    ``D`` of an SSM layer, a sum of many cancelling terms)."""
    for r, got in enumerate(runs[1][(1, m)]):
        on, off = f"grads/{case}/on/", f"grads/{case}/off/"
        names = [f[len(off):] for f in got.files if f.startswith(off) and not
                 f.endswith("/loss")]
        assert names
        if m == 2:
            np.testing.assert_array_equal(got[on + "loss"], got[off + "loss"])
        else:
            _close(got[on + "loss"], got[off + "loss"], 1e-6, f"{case} loss rank {r}")
        for name in names:
            assert np.abs(got[off + name]).max() > 0, name
            _close(got[on + name], got[off + name], 1e-4, f"{case} {name} rank {r}")


@pytest.mark.parametrize("m", PREFILL_SIZES)
@pytest.mark.parametrize("case", list(PREFILL))
def test_sequence_parallel_prefill_matches_the_step_without_it(case, m, runs):
    """``build_prefill_step`` under ``sequence_parallel``: the same logits
    as without it, bit for bit at M = 2 (the reduce-scatter of two partial
    sums is their all-reduce), within 2e-6 of the largest |logit| at M = 4:
    the four partial sums of each block's exit run in another order, and
    through Jamba's 4 layers (8 such sums and an MoE) that reads 1.02e-6
    here; every other family stays under 1e-6."""
    for r, got in enumerate(runs[1][(1, m)]):
        on, off = got[f"prefill/{case}/on"], got[f"prefill/{case}/off"]
        assert on.shape == off.shape and np.isfinite(on).all()
        if m == 2:
            np.testing.assert_array_equal(on, off, err_msg=f"{case} rank {r}")
        else:
            _close(on, off, 1e-6 if case != "jamba" else 2e-6, f"{case} rank {r}")


def test_zero1_trainer_restarts_bit_for_bit(runs):
    """``ContinualTrainer(mesh=2x1)`` with ``zero1`` under the
    ``ResilientLoop`` (restart checkpoints every 2 steps, each rank's moment
    slices in its own directory): rank 0 fails before step 3, both ranks
    restart once and end on the clean run's parameters and moment slices
    bit for bit, with its losses."""
    for got in runs[1][(2, 1)]:
        assert int(got["resilient/restarts"]) == 1
        assert bool(got["resilient/losses_equal"]) and bool(got["resilient/state_equal"])
        assert int(got["resilient/sliced"]) > 0
