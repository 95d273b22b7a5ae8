"""The model axis on spawned gloo ranks (a file rendezvous in the test's
temporary directory), against the JAX package on the same weights.

  * (b) forward: ``launch.steps.build_prefill_step`` on 1 x 2 and 1 x 4
    meshes, f32, for the reduced SmolLM-135M (4 heads, 2 KV: at M = 4 the
    KV projection is replicated and each rank keeps its one KV head),
    SmolLM with 6 heads and 3 KV (heads that do not divide 4: attention
    replicated), Mamba2-370M, Gemma-2B (MQA), Mixtral-8x7B (expert-parallel)
    and with 3 experts (hidden-sharded), Jamba-v0.1, Qwen2-VL-72B
    (patch-stub embeddings, M-RoPE positions) and Whisper-tiny (the
    encoder-decoder: its encoder, decoder and cross-attention sharded by
    heads, at M = 4 its 2 KV heads replicated). Each rank's logits, gathered
    over its model row, are within 1e-4 of the largest |logit| of the JAX
    reference's unsharded forward. Routing is pinned to the rank's own
    unsharded forward (``repro_torch.testdata.routing``), as in every
    comparison of forwards not computed alike.
  * (c) decode: ``DecodeEngine`` driving ``build_decode_step``'s step
    gives the JAX engine's greedy token ids.
  * (d) training: ``build_train_step`` on 1 x 2 and 2 x 2 meshes, 2
    pipelined steps with a flat buffer, against JAX's ``build_train_step``
    on a (1, 2) and a (2, 2) CPU mesh (subprocesses with ``XLA_FLAGS``), the
    JAX row vectors and exchange picks fed through the ``rows`` seam: the
    loss within 1e-5 relative, the buffers, the pending slot,
    ``buffer_fill`` and ``rep_checksum`` exactly, the parameters after 2
    steps within 1e-4 of each tensor's largest entry, and the replicated
    parameters (norms, router) bit-equal on every rank.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {"smollm": ("smollm-135m", {}), "smollm_6h": ("smollm-135m", dict(num_heads=6,
                                                                          num_kv_heads=3)),
         "mamba2": ("mamba2-370m", {}), "gemma": ("gemma-2b", {}),
         "mixtral_ep": ("mixtral-8x7b", {}), "mixtral_tp": ("mixtral-8x7b", dict(num_experts=3)),
         "jamba": ("jamba-v0.1-52b", {}), "qwen2_vl": ("qwen2-vl-72b", {}),
         "whisper": ("whisper-tiny", {})}
DECODE = ("smollm", "mamba2", "gemma", "mixtral_ep", "whisper")
B, S, PROMPT, GEN = 2, 16, 8, 8
FORWARD_SIZES = (2, 4)

FORWARD_SIDE = """
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
from repro_torch.configs.base import RunConfig, ScenarioConfig, TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import StackCtx
from repro_torch.parallel.tensor import gather_vocab
from repro_torch.serving import DecodeEngine
from repro_torch.testdata import routing

CASES, DECODE, B, S, GEN = {CASES}, {DECODE}, {B}, {S}, {GEN}
ref = np.load(ref_path)
mesh = make_mesh((1, world), ("data", "model"), "cpu")
out = {{}}


def tree(case):
    t, pre = {{}}, case + "/tree/"
    for k in ref.files:
        if k.startswith(pre):
            node = t
            *path, leaf = k[len(pre):].split(".")
            for p in path:
                node = node.setdefault(p, {{}})
            node[leaf] = ref[k]
    return t


for case, (arch, over) in CASES.items():
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    run = RunConfig(model=cfg, train=TrainConfig(compute_dtype="float32"),
                    scenario=ScenarioConfig(modality="tokens", batch_size=B, seq_len=S))
    jt = tree(case)
    batch = {{k.split("/")[-1]: torch.from_numpy(ref[k]) for k in ref.files
              if k.startswith(case + "/batch/") and not k.endswith("labels")}}
    built = build_prefill_step(run, mesh)
    params = lm_params_from_jax(jt, cfg, device="cpu", mp=built.ctx.mp)
    with torch.no_grad(), routing() as pins:
        built.model.forward(lm_params_from_jax(jt, cfg, device="cpu"), batch, StackCtx(cfg=cfg))
    with routing(pins):
        logits = built.fn(params, batch)
    out[case + "/local_vocab"] = np.array(logits.shape[-1])
    if logits.shape[-1] != cfg.vocab_size:
        logits = gather_vocab(logits, built.ctx.mp)
    out[case + "/logits"] = logits.numpy()
    out[case + "/sharded"] = np.array(sorted(params.tp_sharded))
    if case in DECODE:
        built = build_decode_step(run, mesh)
        res = DecodeEngine(built.model, built.ctx, step=built.fn).generate(
            params, torch.from_numpy(ref[case + "/prompts"]), GEN)
        out[case + "/tokens"] = res.tokens.numpy()
np.savez(out_path, **out)
import gc
gc.collect()
dist.destroy_process_group()
"""

# ---------------------------------------------------------------------------
# (d) training
# ---------------------------------------------------------------------------

V, TS, TB, STEPS = 128, 16, 8, 2
MESHES = ((1, 2), (2, 2))
TRAIN_CASES = {"dense": "smollm-135m", "ssm": "mamba2-370m"}

JAX_TRAIN_SIDE = """
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

V, S, B, D, M, STEPS, CASES = {V}, {S}, {B}, {D}, {M}, {STEPS}, {CASES}
stream = TaskTokenStream(TokenStreamConfig(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
mesh = make_mesh((D, M), ("data", "model"))
out, bw = {{}}, B // D

for case, arch in CASES.items():
    cfg = dataclasses.replace(get_reduced(arch), vocab_size=V, num_layers=2)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), vocab_size=V, num_layers=2)

    def named(tree):
        return lm_named_from_tree(jax.tree_util.tree_map(np.asarray, tree), tcfg)

    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                           num_candidates=6, mode="async", label_field="labels")
    run = RunConfig(model=cfg, shape=ShapeConfig("parity", S, B, "train"),
                    train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                      linear_scaling=False, compute_dtype="float32"),
                    rehearsal=rcfg, strategy=StrategyConfig(),
                    scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                            strategy="rehearsal", num_tasks=2, batch_size=B,
                                            vocab_size=V, seq_len=S, auto_defaults=False))
    with set_mesh(mesh):
        built = build_train_step(run, mesh, exchange="full", buffer_budget_bytes=None,
                                 donate=False)
        key = jax.random.PRNGKey(0)
        params, opt, buf, reps, valid = materialize_state(built, run, mesh, key)
        out.update({{f"{{case}}/params0/{{k}}": v for k, v in named(params).items()}})
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
                    out[f"{{case}}/s{{s}}/w{{w}}/rows/{{name}}"] = np.asarray(a)
            out.update({{f"{{case}}/s{{s}}/batch/{{k}}": v for k, v in batch.items()}})
            params, opt, buf, reps, valid, m = built.fn(
                params, opt, buf, reps, valid, {{k: jnp.asarray(v) for k, v in batch.items()}},
                issue_key)
            issue_key = jax.random.fold_in(key, s)
            for k in ("loss", "rep_checksum", "buffer_fill"):
                out[f"{{case}}/s{{s}}/{{k}}"] = np.asarray(m[k])
            for w in range(D):
                for k, v in buf.data.items():
                    out[f"{{case}}/s{{s}}/w{{w}}/buffer/{{k}}"] = np.asarray(v)[w]
                for k, v in reps.items():
                    out[f"{{case}}/s{{s}}/w{{w}}/reps/{{k}}"] = np.asarray(v)[w]
                out[f"{{case}}/s{{s}}/w{{w}}/valid"] = np.asarray(valid)[w]
        out.update({{f"{{case}}/params{{STEPS}}/{{k}}": v for k, v in named(params).items()}})
np.savez(sys.argv[1], **out)
"""

PORT_TRAIN_SIDE = """
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
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      StrategyConfig, TrainConfig)
from repro_torch.convert import load_named
from repro_torch.core.distributed import ExchangeRows
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step, shard_host_batch
from repro_torch.parallel import dp_index, model_parallel, param_spec, shard_param
from repro_torch.scenario import TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state

V, S, B, D, M, STEPS, CASES = {V}, {S}, {B}, {D}, {M}, {STEPS}, {CASES}
ref = np.load(ref_path)
mesh = make_mesh((D, M), ("data", "model"))
mp, w = model_parallel(mesh), dp_index(mesh)
out = {{}}
for case, arch in CASES.items():
    cfg = dataclasses.replace(configs.get_reduced(arch), vocab_size=V, num_layers=2)
    run = RunConfig(
        model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                     linear_scaling=False, compute_dtype="float32"),
        rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                                  num_candidates=6, mode="async", label_field="labels"),
        strategy=StrategyConfig(),
        scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                strategy="rehearsal", num_tasks=2, batch_size=B, vocab_size=V,
                                seq_len=S, auto_defaults=False))
    built = build_train_step(run, mesh, scenario=TokenClassIncremental(run.scenario),
                             exchange="full", buffer_budget_bytes=None, device="cpu")
    params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
    prefix = f"{{case}}/params0/"
    full = {{k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}}
    load_named(params, {{k: shard_param(v, param_spec(k, v.shape, cfg, M), mp)
                        for k, v in full.items()}})
    for s in range(STEPS):
        p = f"{{case}}/s{{s}}/w{{w}}/rows/"
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
        out.update({{f"{{case}}/s{{s}}/buffer/{{k}}": v.numpy().copy()
                    for k, v in buf.data.items()}})
        out.update({{f"{{case}}/s{{s}}/reps/{{k}}": v.numpy().copy() for k, v in reps.items()}})
        out[f"{{case}}/s{{s}}/valid"] = valid.numpy().copy()
    out.update({{f"{{case}}/params{{STEPS}}/{{k}}": v.detach().numpy().copy()
                for k, v in params.named_parameters()}})
    out[f"{{case}}/sharded"] = np.array(sorted(params.tp_sharded))
np.savez(out_path, **out)
del built, params, opt, buf, reps, valid
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


def _forward_refs(path):
    """The JAX reference's f32 forward (and for ``DECODE`` its engine's
    greedy ids) of every case, its weights named as the JAX tree's leaves."""
    import dataclasses

    from repro.configs import get_reduced as jax_reduced
    from repro.models import StackCtx as JaxCtx
    from repro.models import build_model as jax_build
    from repro.serving import DecodeEngine as JaxEngine
    from repro_torch import testdata
    from repro_torch.convert import _walk

    out = {}
    for case, (arch, over) in CASES.items():
        jcfg = dataclasses.replace(jax_reduced(arch), **over)
        jmodel = jax_build(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=S)
        ctx = JaxCtx(cfg=jcfg, compute_dtype=jnp.float32, remat="none", scan_layers=False)
        batch = testdata.family_batch(jcfg, B, S, seed=1)
        logits = jax.jit(lambda p, b: jmodel.forward(p, b, ctx)[0])(
            jparams, {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"})
        out[case + "/logits"] = np.asarray(logits)
        out.update({f"{case}/batch/{k}": v for k, v in batch.items()})
        out.update({f"{case}/tree/{k}": v for k, v in _walk(jax.tree_util.tree_map(
            np.asarray, jparams))})
        if case in DECODE:
            prompts = np.random.default_rng(3).integers(
                0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
            want = JaxEngine(jmodel, ctx).generate(jparams, jnp.asarray(prompts), GEN)
            out[case + "/prompts"] = prompts
            out[case + "/tokens"] = np.asarray(want.tokens)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank group at once: the JAX train steps on (1, 2) and (2, 2)
    fake-device meshes (subprocesses) while this process computes the
    forward references, then the port's 1 x 2 and 1 x 4 forward ranks and
    1 x 2 and 2 x 2 train ranks. Returns ``(forward ref, {m: [ranks]},
    train refs {mesh}, {mesh: [ranks]})``."""
    tmp = tmp_path_factory.mktemp("model_axis")
    src = os.path.join(REPO, "src")
    jax_procs = []
    for d, m in MESHES:
        env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={d * m}")
        code = textwrap.dedent(JAX_TRAIN_SIDE.format(V=V, S=TS, B=TB, D=d, M=m, STEPS=STEPS,
                                                     CASES=TRAIN_CASES))
        jax_procs.append(_spawn(code, [tmp / f"train_ref_{d}x{m}.npz"], env))
    fwd_ref = tmp / "forward_ref.npz"
    _forward_refs(fwd_ref)
    _run_all(jax_procs)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    procs = []
    fwd_code = textwrap.dedent(FORWARD_SIDE.format(CASES=CASES, DECODE=DECODE, B=B, S=S,
                                                   GEN=GEN))
    for m in FORWARD_SIZES:
        rdv = tmp / f"rdv_fwd_{m}"
        procs += [_spawn(fwd_code, [r, m, rdv, fwd_ref, tmp / f"fwd_{m}_{r}.npz"], env)
                  for r in range(m)]
    for d, m in MESHES:
        code = textwrap.dedent(PORT_TRAIN_SIDE.format(V=V, S=TS, B=TB, D=d, M=m, STEPS=STEPS,
                                                      CASES=TRAIN_CASES))
        rdv = tmp / f"rdv_train_{d}x{m}"
        procs += [_spawn(code, [r, d * m, rdv, tmp / f"train_ref_{d}x{m}.npz",
                                tmp / f"train_{d}x{m}_{r}.npz"], env) for r in range(d * m)]
    _run_all(procs)
    return (np.load(fwd_ref),
            {m: [np.load(tmp / f"fwd_{m}_{r}.npz") for r in range(m)] for m in FORWARD_SIZES},
            {dm: np.load(tmp / f"train_ref_{dm[0]}x{dm[1]}.npz") for dm in MESHES},
            {dm: [np.load(tmp / f"train_{dm[0]}x{dm[1]}_{r}.npz")
                  for r in range(dm[0] * dm[1])] for dm in MESHES})


@pytest.mark.parametrize("m", FORWARD_SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_forward_matches_the_jax_reference(case, m, runs):
    import dataclasses

    from repro_torch import configs
    from repro_torch.parallel import attention_plan, moe_layout, ssm_sharded

    ref, ranks = runs[0], runs[1][m]
    arch, over = CASES[case]
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    want = ref[case + "/logits"]
    for r, got in enumerate(ranks):
        _close(got[case + "/logits"], want, 1e-4, f"{case} M={m} rank {r}")
        assert int(got[case + "/local_vocab"]) == cfg.vocab_size // m  # vocab-sharded head
        sharded = set(got[case + "/sharded"].tolist())
        # the blocks whose heads / experts split over M run sharded, the rest whole
        layer0 = "layers.0.attn.wq" if cfg.layer_kind(0) == "attn" else "layers.0.ssm.w_x"
        if cfg.family == "encdec":
            layer0 = "dec_layers.0.cross.wq"
        split = (attention_plan(cfg, m) is not None if cfg.layer_kind(0) == "attn"
                 else ssm_sharded(cfg, m))
        assert (layer0 in sharded) == split, (layer0, sorted(sharded))
        moe = [n for n in sharded if ".moe." in n]
        assert bool(moe) == (moe_layout(cfg, m) is not None)
    assert case != "smollm" or m != 4 or "layers.0.attn.wk" not in sharded  # KV replicated


@pytest.mark.parametrize("m", FORWARD_SIZES)
@pytest.mark.parametrize("case", DECODE)
def test_decode_through_build_decode_step_gives_the_references_ids(case, m, runs):
    ref, ranks = runs[0], runs[1][m]
    for got in ranks:
        assert got[case + "/tokens"].shape == (B, GEN)
        np.testing.assert_array_equal(got[case + "/tokens"], ref[case + "/tokens"])


@pytest.mark.parametrize("case", list(TRAIN_CASES))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
def test_train_step_on_the_model_axis_matches_jax(mesh, case, runs):
    import dataclasses

    from repro_torch import configs
    from repro_torch.parallel import ModelParallel, param_spec, shard_param

    d, m = mesh
    ref, ranks = runs[2][mesh], runs[3][mesh]
    cfg = dataclasses.replace(configs.get_reduced(TRAIN_CASES[case]), vocab_size=V,
                              num_layers=2)
    for s in range(STEPS):
        for r, got in enumerate(ranks):
            w = r // m
            assert abs(got[f"{case}/s{s}/loss"] - ref[f"{case}/s{s}/loss"]) <= 1e-5 * abs(
                ref[f"{case}/s{s}/loss"]), (s, r, float(got[f"{case}/s{s}/loss"]))
            for k in ("rep_checksum", "buffer_fill"):
                assert float(got[f"{case}/s{s}/{k}"]) == float(ref[f"{case}/s{s}/{k}"]), (s, k)
            for part in ("buffer", "reps"):
                names = [f.split("/")[-1] for f in ref.files
                         if f.startswith(f"{case}/s{s}/w{w}/{part}/")]
                assert names
                for name in names:
                    np.testing.assert_array_equal(got[f"{case}/s{s}/{part}/{name}"],
                                                  ref[f"{case}/s{s}/w{w}/{part}/{name}"])
            np.testing.assert_array_equal(got[f"{case}/s{s}/valid"],
                                          ref[f"{case}/s{s}/w{w}/valid"])
    pre = f"{case}/params{STEPS}/"
    sharded = set(ranks[0][f"{case}/sharded"].tolist())
    assert sharded and any(".attn." in n or ".ssm." in n for n in sharded)
    for r, got in enumerate(ranks):
        mp = ModelParallel(None, m, r % m)
        for f in ref.files:
            if not f.startswith(pre):
                continue
            name = f[len(pre):]
            full = ref[f]
            want = shard_param(full, param_spec(name, full.shape, cfg, m), mp)
            _close(got[f], want, 1e-4, f"{name} rank {r}")
            if name not in sharded:  # replicated: the same bits on every rank
                np.testing.assert_array_equal(got[f], ranks[0][f], err_msg=f"{name} {r}")
