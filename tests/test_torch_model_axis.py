"""The model axis in one process: the port's rule table against the
reference's ``repro.parallel.sharding.param_spec`` on every leaf of every
registered arch (full configs, built on ``torch.device("meta")``), the
shard-aware init (each rank's model is exactly the unsharded model's
slices, the encoder-decoder's included), the head plans, the converter's
shards, and the elastic reshard of tensor-parallel carries between D x M
meshes. A ``ModelParallel`` here has no group: init and slicing issue no
collective.

One module-scoped spawn (``row_of_two``: a JAX subprocess on a (1, 2)
fake-device mesh, then two gloo ranks) holds the tap strategies through
``build_train_step`` against JAX's, the shards' top-k merge, and Whisper
served on a 1 x 2 mesh. The rest of the collectives run in
``tests/test_torch_model_axis_ranks.py``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.parallel.sharding import param_spec as jax_param_spec
from repro.parallel.sharding import stacked_param_spec as jax_stacked_spec
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.parallel import ModelParallel, attention_plan, param_spec, shard_param

ARCHS = configs.ARCHS
SIZES = (2, 4, 16)
ATTN = ("wq", "wk", "wv", "wo")
SSM_HEAD = ("w_z", "w_x", "w_dt", "conv_x", "conv_bias_x", "norm_scale", "A_log", "D",
            "dt_bias", "out_proj")


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """``(port name, ref spec, shape)`` of every leaf of the reference's
    full-config tree (``jax.eval_shape``: nothing allocated); a stacked
    leaf's spec is its per-layer part, named after its first layer."""
    jcfg = jax_config(arch)
    tree = jax.eval_shape(lambda k: jax_build(jcfg).init(k, 64), jax.random.PRNGKey(0))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        pstr = jax.tree_util.keystr(path)
        if keys[0] == "units":
            name = f"layers.{int(keys[1][len('layer'):])}." + ".".join(keys[2:])
        elif keys[0] in ("enc_layers", "dec_layers"):
            name = f"{keys[0]}.0." + ".".join(keys[1:])
        else:
            out.append((".".join(keys), pstr, tuple(leaf.shape), False))
            continue
        out.append((name, pstr, tuple(leaf.shape), True))
    return jcfg, out


def _norm(spec, ndim):
    parts = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(p if p is None else str(p) for p in parts)


@functools.lru_cache(maxsize=None)
def _full_shapes(arch):
    """Every parameter's full shape in the port's model of ``arch``, built
    on ``torch.device("meta")`` (Mixtral's 187 GB is never allocated)."""
    cfg = configs.get_config(arch)
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        model = (tf.EncDec if cfg.family == "encdec" else tf.Decoder)(gen, cfg, 64)
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _heads_split(cfg, leaf, parent, m):
    """Whether the leaf's heads split whole over ``m`` ranks (the port's
    head-granular rule); None for a leaf without heads."""
    if parent in ("attn", "cross") and leaf in ATTN:
        plan = attention_plan(cfg, m)
        if leaf in ("wk", "wv"):
            return plan is not None and plan.kv_sharded
        return plan is not None
    if parent == "ssm" and leaf in SSM_HEAD:
        return (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) % m == 0
    return None


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_table_matches_the_reference_but_for_split_heads(arch, m):
    """Every leaf's spec is the reference's, except where the reference
    splits a head across ranks: there (and only there) the port replicates.
    The list of such leaves is exactly the head leaves whose heads do not
    split whole over M and that the reference shards."""
    cfg = configs.get_config(arch)
    jcfg, leaves = _ref_leaves(arch)
    full = _full_shapes(arch)
    differs, expected = [], []
    for name, pstr, shape, stacked in leaves:
        inner = shape[1:] if stacked else shape
        assert name in full and full[name] == inner, name
        want = _norm((jax_stacked_spec(pstr, shape, jcfg, m) if stacked
                      else jax_param_spec(pstr, shape, jcfg, m)), len(shape))
        want = want[1:] if stacked else want
        got = param_spec(name, inner, cfg, m)
        parts = name.split(".")
        split = _heads_split(cfg, parts[-1], parts[-2] if len(parts) > 1 else "", m)
        if got != want:
            differs.append(name)
            assert got == (None,) * len(inner), (name, got, want)
        if split is False and "model" in want:
            expected.append(name)
        if split is False:
            assert "model" not in got, name
    assert differs == expected, (sorted(set(differs) ^ set(expected)))


@pytest.mark.parametrize("h,kv,m,want", [
    (8, 1, 2, (4, 1, [0, 0], False)),    # Gemma-2B MQA: the one KV head on both ranks
    (32, 8, 16, (2, 1, [0, 0, 1, 1, 2], False)),  # one KV head a rank, not all 8
    (32, 8, 4, (8, 2, [0, 2, 4, 6], True)),
    (4, 2, 4, (1, 1, [0, 0, 1, 1], False)),  # reduced SmolLM at M = 4
    (6, 3, 4, None),                        # heads do not divide: replicated
    (12, 3, 2, None),                       # local heads would span 1.5 KV heads
    (9, 3, 2, None),                        # SmolLM-135M
])
def test_head_plans_keep_whole_heads_and_their_kv_head(h, kv, m, want):
    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), num_heads=h, num_kv_heads=kv)
    plans = [attention_plan(cfg, m, i) for i in range(m)]
    if want is None:
        assert all(p is None for p in plans)
        return
    heads, nkv, firsts, sharded = want
    assert all(p.heads == heads and p.kv == nkv and p.kv_sharded == sharded for p in plans)
    assert [p.kv_first for p in plans][:len(firsts)] == firsts
    for i, p in enumerate(plans):  # query head g reads KV head g // (H / KV)
        for g in range(i * heads, (i + 1) * heads):
            assert p.kv_first <= g // (h // kv) < p.kv_first + p.kv


CASES = {"smollm": ("smollm-135m", {}), "smollm_6h": ("smollm-135m", dict(num_heads=6,
                                                                          num_kv_heads=3)),
         "mamba2": ("mamba2-370m", {}), "gemma": ("gemma-2b", {}),
         "mixtral_ep": ("mixtral-8x7b", {}), "mixtral_tp": ("mixtral-8x7b", dict(num_experts=3)),
         "jamba": ("jamba-v0.1-52b", {}), "qwen2_vl": ("qwen2-vl-72b", {})}


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_init_is_the_unsharded_models_slices(case, m):
    """Each rank draws every full tensor in the unsharded order and keeps
    its slice: the union of the ranks' models is the unsharded model, and
    ``tp_sharded`` names exactly the leaves the rule table shards."""
    arch, over = CASES[case]
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    full = dict(tf.Decoder(torch.Generator().manual_seed(3), cfg, 16).named_parameters())
    for i in range(m):
        mp = ModelParallel(None, m, i)
        model = tf.Decoder(torch.Generator().manual_seed(3), cfg, 16, mp)
        got = dict(model.named_parameters())
        assert list(got) == list(full)
        for name, p in got.items():
            spec = param_spec(name, tuple(full[name].shape), cfg, m)
            assert (name in model.tp_sharded) == ("model" in spec), name
            assert torch.equal(p, shard_param(full[name], spec, mp)), name


def test_the_unsharded_model_is_unchanged_and_names_no_shard():
    cfg = configs.get_reduced("jamba-v0.1-52b")
    a = tf.Decoder(torch.Generator().manual_seed(0), cfg, 16)
    b = tf.Decoder(torch.Generator().manual_seed(0), cfg, 16, None)
    assert a.tp_sharded == frozenset() and all(
        torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_converter_keeps_this_ranks_shards_of_the_jax_tree():
    from repro.configs import get_reduced as jax_reduced

    from repro_torch.convert import lm_named_from_tree, lm_params_from_jax

    jcfg, cfg = jax_reduced("mixtral-8x7b"), configs.get_reduced("mixtral-8x7b")
    tree = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0), 16))
    full = lm_named_from_tree(tree, cfg)
    for i in range(2):
        mp = ModelParallel(None, 2, i)
        model = lm_params_from_jax(tree, cfg, device="cpu", mp=mp)
        for name, p in model.named_parameters():
            want = shard_param(full[name], param_spec(name, full[name].shape, cfg, 2), mp)
            np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=name)
    assert model.layers[0].moe.wi.shape[0] == cfg.num_experts // 2  # expert-parallel


@pytest.mark.parametrize("m", [2, 4])
def test_encdec_on_a_model_axis_raises_naming_item_21(m):
    """Item 21's encoder-decoder on a model axis: each rank's ``EncDec`` is
    exactly the unsharded model's slices under the rule table (the
    encoder's and decoder's self-attention, the cross-attention and the
    MLPs; the reduced vocabulary of 512 by rows), the converter's shards of
    a JAX tree are the same, and at M = 4 the reduced 2 KV heads keep the
    cross K/V projections replicated. Whisper-tiny's published vocabulary
    (51865) does not divide 2, so its embedding and head stay whole; its 6
    heads do not divide 4, so its attention is replicated there. Named for
    the refusal it asserted before this path ran."""
    from repro.configs import get_reduced as jax_reduced
    from repro_torch.convert import encdec_named_from_tree, encdec_params_from_jax

    cfg = configs.get_reduced("whisper-tiny")
    full = dict(tf.init_encdec(torch.Generator().manual_seed(0), cfg, 16, "cpu")
                .named_parameters())
    jtree = jax.tree_util.tree_map(
        np.asarray, jax_build(jax_reduced("whisper-tiny")).init(jax.random.PRNGKey(0), 16))
    jfull = encdec_named_from_tree(jtree)
    for i in range(m):
        mp = ModelParallel(None, m, i)
        model = tf.init_encdec(torch.Generator().manual_seed(0), cfg, 16, "cpu", mp)
        conv = dict(encdec_params_from_jax(jtree, cfg, "cpu", mp).named_parameters())
        for name, p in model.named_parameters():
            spec = param_spec(name, tuple(full[name].shape), cfg, m)
            np.testing.assert_array_equal(p.detach().numpy(),
                                          shard_param(full[name].detach(), spec, mp).numpy())
            np.testing.assert_array_equal(conv[name].detach().numpy(),
                                          shard_param(jfull[name], spec, mp), err_msg=name)
            assert (name in model.tp_sharded) == ("model" in spec), name
    assert {"embed", "lm_head", "dec_layers.0.cross.wq", "dec_layers.0.cross.wo",
            "enc_layers.0.attn.wq", "enc_layers.0.mlp.wi"} <= model.tp_sharded
    assert ("dec_layers.0.cross.wk" in model.tp_sharded) == (m == 2)
    whisper = configs.get_config("whisper-tiny")
    assert param_spec("embed", (whisper.vocab_size, whisper.d_model), whisper, 2) == (None, None)
    assert attention_plan(whisper, 2) is not None and attention_plan(whisper, 4) is None


# ---------------------------------------------------------------------------
# Elastic reshard of tensor-parallel carries, in one process
# ---------------------------------------------------------------------------

RESHARD_CFG = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=64,
                                  num_layers=2)


def _tp_carries(d, m, zero1, seed=0):
    """The D x M ranks' carries (mesh order) of one run: each rank's shards
    of one model, AdamW moments cut from whole random ones (the rank's
    ZeRO-1 slice under ``zero1``), a buffer and pending slot a data rank,
    the same on its row. Returns ``(carries, whole params, whole moments,
    data-rank buffers)``."""
    from repro_torch.buffer.state import BufferState
    from repro_torch.optim.optimizers import OptState
    from repro_torch.parallel import Zero1
    from repro_torch.strategy.step import PipelinedRehearsalCarry, TrainCarry

    cfg = RESHARD_CFG
    whole = {k: p.detach() for k, p in tf.Decoder(torch.Generator().manual_seed(seed), cfg,
                                                  16).named_parameters()}
    g = torch.Generator().manual_seed(seed + 1)
    moments = [{k: torch.randn(t.shape, generator=g) for k, t in whole.items()}
               for _ in range(2)]
    buffers, pipes = [], []
    for w in range(d):
        counts = torch.randint(0, 5, (2,), generator=g, dtype=torch.int32)
        buffers.append(BufferState(
            {"tokens": torch.randint(0, 64, (2, 4, 8), generator=g, dtype=torch.int32),
             "logits": torch.randn(2, 4, 8, 64, generator=g)},
            counts, counts + torch.randint(0, 3, (2,), generator=g, dtype=torch.int32)))
        pipes.append(PipelinedRehearsalCarry(
            {"tokens": torch.randint(0, 64, (3, 8), generator=g, dtype=torch.int32)},
            torch.rand(3, generator=g) > 0.5, 11 + w))
    carries = []
    for w in range(d):
        for j in range(m):
            mp = ModelParallel(None, m, j) if m > 1 else None
            model = tf.Decoder(torch.Generator().manual_seed(seed), cfg, 16, mp)
            cut = Zero1(None, d, w) if zero1 and d > 1 else None

            def local(t, k, model=model, mp=mp, cut=cut):
                spec = model.layout_specs[k]
                if k in model.tp_sharded:
                    t = shard_param(t, spec, mp)
                dim = None if cut is None else cut.dim(tuple(t.shape), spec)
                return (t if dim is None else cut.shard(t, dim)).clone()

            opt = OptState(5, *({k: local(t, k) for k, t in mom.items()} for mom in moments))
            buf = BufferState({k: v.clone() for k, v in buffers[w].data.items()},
                              buffers[w].counts.clone(), buffers[w].seen.clone())
            carries.append(TrainCarry(model, opt, buf, pipes[w]))
    return carries, whole, moments, buffers


def _joined(carries, d, m, zero1):
    """The whole parameters and moments the D x M carries hold."""
    from repro_torch.runtime.elastic import _whole_moments, whole_params

    rows = [carries[w * m:(w + 1) * m] for w in range(d)]
    return whole_params([c.params for c in rows[0]]), _whole_moments(rows, zero1 and d > 1)


@pytest.mark.parametrize("zero1", [False, True], ids=["whole", "zero1"])
@pytest.mark.parametrize("target", [(1, 2), (2, 1), (1, 1), (1, 4)],
                         ids=lambda t: f"to{t[0]}x{t[1]}")
def test_elastic_reshard_of_sharded_carries_raises_naming_item_21(target, zero1):
    """Item 21's elastic reshard: ``reshard_carry`` takes a 2 x 2 run's
    tensor-parallel carries to ``target`` and back. The whole parameters and
    AdamW moments are bit for bit before and after each way; each new
    rank's tensors have the shapes its own init (``Decoder`` at M', the
    optimizer's ZeRO-1 init at D') allocates; the buffers are what the M = 1
    reshard of the data ranks' buffers gives, the same on the M' ranks of a
    row; and back at 2 x 2 every rank's carry is the original's. At M' = 4
    the reduced model's 2 KV heads do not split: ``wk``/``wv`` come back
    replicated, as the head-granular rule has them. Named for the refusal
    it asserted before this path ran."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import Zero1
    from repro_torch.runtime.elastic import reshard_carry

    d2, m2 = target
    two, whole, moments, buffers = _tp_carries(2, 2, zero1)
    new = reshard_carry(two, d2, zero1=zero1, model_size=2, new_model_size=m2)
    assert len(new) == d2 * m2
    params, moms = _joined(new, d2, m2, zero1)
    for k, t in whole.items():
        assert torch.equal(params[k], t), k
        for got, want in zip(moms, moments):
            assert torch.equal(got[k], want[k]), k
    flat = reshard_carry([c._replace(params=None, opt=None) for c in two[::2]], d2)
    for w in range(d2):
        for i in range(m2):
            c = new[w * m2 + i]
            mp = ModelParallel(None, m2, i) if m2 > 1 else None
            fresh = tf.Decoder(torch.Generator().manual_seed(3), RESHARD_CFG, 16, mp)
            assert c.params.tp_sharded == fresh.tp_sharded
            assert c.params.layout_specs == fresh.layout_specs
            init_opt, _ = make_optimizer(TrainConfig(optimizer="adamw"), mp=mp,
                                         zero1=Zero1(None, d2, w) if zero1 and d2 > 1 else None)
            want_opt = init_opt(dict(fresh.named_parameters()), fresh.layout_specs)
            for k, p in fresh.named_parameters():
                assert c.params.get_parameter(k).shape == p.shape, k
                assert c.opt.mu[k].shape == want_opt.mu[k].shape, k
            for k, t in flat[w].buffer.data.items():
                assert torch.equal(c.buffer.data[k], t), k
            assert torch.equal(c.buffer.counts, flat[w].buffer.counts)
            assert torch.equal(c.pipe.reps["tokens"], flat[w].pipe.reps["tokens"])
    back = reshard_carry(new, 2, zero1=zero1, model_size=m2, new_model_size=2)
    for got, want in zip(back, two):
        for k, p in want.params.named_parameters():
            assert torch.equal(got.params.get_parameter(k), p), k
        for which in ("mu", "nu"):
            for k, t in getattr(want.opt, which).items():
                assert torch.equal(getattr(got.opt, which)[k], t), (which, k)
    # the same buffers re-dealt at M = 1 and here
    for w in range(2):
        assert torch.equal(back[2 * w].buffer.data["logits"], back[2 * w + 1].buffer.data["logits"])


def test_scale_carry_and_a_row_that_disagrees():
    """``scale_carry`` takes a model axis too (2 x 2 -> 2 x 1, zero1), as
    ``reshard_carry`` does; a row whose ranks hold different buffers is not
    one run's and raises, as do shards passed without their model axis."""
    from repro_torch.runtime import scale_carry
    from repro_torch.runtime.elastic import reshard_carry

    two, *_ = _tp_carries(2, 2, True)
    got, seconds = scale_carry(two, 2, zero1=True, model_size=2, new_model_size=1)
    want = reshard_carry(two, 2, zero1=True, model_size=2, new_model_size=1)
    assert seconds >= 0.0 and len(got) == 2
    for a, b in zip(got, want):
        for k, t in b.opt.mu.items():
            assert torch.equal(a.opt.mu[k], t), k
    two[1].buffer.counts[0] += 1
    with pytest.raises(ValueError, match="model rank 1"):
        reshard_carry(two, 1, model_size=2)
    with pytest.raises(ValueError, match="model_size"):
        reshard_carry(two[:1], 1)


def test_production_meshes_need_their_process_group():
    from repro_torch.launch.mesh import make_production_mesh

    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="process group"):
            make_production_mesh(multi_pod)


# ---------------------------------------------------------------------------
# A row of two gloo ranks: the tap strategies against JAX, Whisper served
# ---------------------------------------------------------------------------

V, TS, TB, STEPS = 128, 16, 4, 2
# name -> (strategy, top_k, sequence_parallel): DER and DER++ with dense and
# top-k records, and grasp_embed's embeddings, also under sequence
# parallelism (the hidden state gathered before its mean)
TAPS = {"der": ("der", 0, False), "der_topk": ("der", 8, False),
        "der_pp": ("der_pp", 0, False), "der_pp_topk": ("der_pp", 8, False),
        "grasp_embed": ("grasp_embed", 0, False), "grasp_embed_sp": ("grasp_embed", 0, True)}

_TAP_RUN = """
rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                       num_candidates=6, mode="async", label_field="labels")
def tap_run(cfg, strategy, top_k, sp, **kw):
    return RunConfig(
        model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                     linear_scaling=False, compute_dtype="float32",
                                     sequence_parallel=sp),
        rehearsal=rcfg, strategy=StrategyConfig(alpha=0.5, beta=0.5, top_k=top_k),
        scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                strategy=strategy, num_tasks=2, batch_size=B, vocab_size=V,
                                seq_len=S, auto_defaults=False), **kw)
"""

TAP_JAX_SIDE = """
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

V, S, B, STEPS, TAPS = {V}, {S}, {B}, {STEPS}, {TAPS}
{TAP_RUN}
stream = TaskTokenStream(TokenStreamConfig(num_tasks=2, vocab_size=V, seq_len=S, seed=0))
mesh = make_mesh((1, 2), ("data", "model"))
cfg = dataclasses.replace(get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
tcfg = dataclasses.replace(tconfigs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
out = {{}}
for case, (strategy, top_k, sp) in TAPS.items():
    run = tap_run(cfg, strategy, top_k, sp, shape=ShapeConfig("parity", S, B, "train"))
    with set_mesh(mesh):
        built = build_train_step(run, mesh, exchange="full", buffer_budget_bytes=None,
                                 donate=False)
        key = jax.random.PRNGKey(0)
        params, opt, buf, reps, valid = materialize_state(built, run, mesh, key)
        if case == "der":
            out.update({{f"params0/{{k}}": v for k, v in lm_named_from_tree(
                jax.tree_util.tree_map(np.asarray, params), tcfg).items()}})
        issue_key = key
        for s in range(STEPS):
            batch = stream.batch(s % 2, B, s)
            buf0 = jax.tree_util.tree_map(lambda x: x[0], buf)
            k_up, k_samp = jax.random.split(jax.random.fold_in(issue_key, 0))
            flat, _, _, _, counts, seen = jstate.local_update_rows(
                buf0, jnp.asarray(batch["task"]), k_up, 6)
            k_draw, k_pick = jax.random.split(k_samp)
            samp, sv = jstate.local_sample_rows(buf0._replace(counts=counts), k_draw, 1)
            scores = jax.random.uniform(k_pick, (1,)) + jnp.where(sv[None, 0], 0.0, 1e3)
            take = jnp.argsort(scores)[:3]
            for name, a in (("flat", flat), ("counts", counts), ("seen", seen),
                            ("samp", samp), ("sv", sv), ("take", take)):
                out[f"{{case}}/s{{s}}/rows/{{name}}"] = np.asarray(a)
            out.update({{f"s{{s}}/batch/{{k}}": v for k, v in batch.items()}})
            params, opt, buf, reps, valid, m = built.fn(
                params, opt, buf, reps, valid, {{k: jnp.asarray(v) for k, v in batch.items()}},
                issue_key)
            issue_key = jax.random.fold_in(key, s)
            out[f"{{case}}/s{{s}}/loss"] = np.asarray(m["loss"])
            for k, v in buf.data.items():
                out[f"{{case}}/s{{s}}/buffer/{{k}}"] = np.asarray(v)[0]
            for k, v in reps.items():
                out[f"{{case}}/s{{s}}/reps/{{k}}"] = np.asarray(v)[0]
            out[f"{{case}}/s{{s}}/valid"] = np.asarray(valid)[0]
np.savez(sys.argv[1], **out)
"""

# The sequence-sharded decode cache at 1 x 2 (KV % 2 != 0): name -> (arch,
# overrides of its reduced config, kv_dtype). kv3: 6 heads over 3 KV heads
# (attention replicated, every rank attends with every head); kv1: Gemma's
# MQA (each rank's 2 query heads; the row's heads gathered); ring: a
# sliding window of 8 slots over 16 positions, one KV head. Their caches
# store f32, so the comparison sees the split and nothing of a storage
# rounding; fp8: kv3 with float8_e4m3fn storage on both sides.
DECODE_CASES = {"kv3": ("smollm-135m", dict(num_heads=6, num_kv_heads=3), "float32"),
                "kv1": ("gemma-2b", {}, "float32"),
                "ring": ("h2o-danube-1.8b", dict(num_kv_heads=1, sliding_window=8), "float32"),
                "fp8": ("smollm-135m", dict(num_heads=6, num_kv_heads=3), "float8_e4m3fn")}
# the logits' bound, of the largest |logit|: f32 caches 1e-5; the fp8 cache
# 1e-4 (K/V rounded to 3 mantissa bits: an f32 rounding difference between
# the packages at a rounding boundary lands a value on the other side,
# an O(1e-2) change that the bound would still catch)
DECODE_TOL = {"float32": 1e-5, "float8_e4m3fn": 1e-4}
DB, DP, DG = 2, 8, 8  # batch, prompt, generated tokens


def _decode_refs(path):
    """The reference's f32 decode of every ``DECODE_CASES`` case, token by
    token (the prompt, then greedy): each step's logits, the ids, and the
    weights as the JAX tree's leaves."""
    import dataclasses

    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_reduced
    from repro.models import StackCtx as JaxCtx
    from repro.models import build_model as jax_build
    from repro_torch.convert import _walk

    out = {}
    for case, (arch, over, kv_dtype) in DECODE_CASES.items():
        cfg = dataclasses.replace(jax_reduced(arch), **over)
        model = jax_build(cfg)
        params = model.init(jax.random.PRNGKey(4), max_seq=DP + DG)
        ctx = JaxCtx(cfg=cfg, compute_dtype=jnp.float32, remat="none", scan_layers=False)
        prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (DB, DP)).astype(np.int32)
        caches = model.init_cache(None, DB, DP + DG, dtype=jnp.dtype(kv_dtype))
        step = jax.jit(lambda p, c, tok, i: model.decode(p, {"token": tok}, c, i, ctx))
        feed, logits = list(prompts.T[:, :, None]), []
        for t in range(DP + DG - 1):
            lg, caches = step(params, caches, jnp.asarray(feed[t]), t)
            logits.append(np.asarray(lg))
            if t >= DP - 1:
                feed.append(np.asarray(jnp.argmax(lg[:, -1], axis=-1))[:, None].astype(np.int32))
        out[case + "/prompts"] = prompts
        out[case + "/feed"] = np.concatenate(feed, axis=1)
        out[case + "/logits"] = np.stack(logits)
        out[case + "/tokens"] = np.concatenate(feed[DP:], axis=1)
        out.update({f"{case}/tree/{k}": v for k, v in _walk(jax.tree_util.tree_map(
            np.asarray, params))})
    np.savez(path, **out)


_DECODE_PART = """
# the sequence-sharded decode cache on the row: each step's logits teacher-
# forced on the reference's ids, then the engine's greedy ids, each rank's
# cache bytes and the cache's shards
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_decode_step
from repro_torch.serving import DecodeEngine

dref = np.load(decode_ref_path)
for case, (arch, over, kv_dtype) in DECODE_CASES.items():
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    run = RunConfig(model=cfg, train=TrainConfig(compute_dtype="float32", kv_dtype=kv_dtype),
                    scenario=ScenarioConfig(modality="tokens", batch_size=DB, seq_len=DP + DG))
    built = build_decode_step(run, mesh)
    tree = {}
    for k in dref.files:
        if k.startswith(case + "/tree/"):
            node = tree
            *path, leaf = k[len(case + "/tree/"):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = dref[k]
    params = lm_params_from_jax(tree, cfg, device="cpu", mp=built.ctx.mp)
    caches = built.model.init_cache(params, DB, DP + DG, dtype=built.cache_dtype,
                                    mp=built.ctx.mp, seq=built.ctx.kv_seq)
    out[case + "/cache_bytes"] = np.array(sum(t.numel() * t.element_size()
                                              for c in caches for t in c.values()))
    out[case + "/cache_shape"] = np.array(caches[0]["k"].shape)
    out[case + "/cache_dtype"] = np.array(str(caches[0]["k"].dtype))
    out[case + "/split"] = np.array(sorted((built.ctx.kv_seq or {}).keys()))
    feed = torch.from_numpy(dref[case + "/feed"])
    logits = []
    for t in range(DP + DG - 1):
        lg, caches = built.fn(params, caches, {"token": feed[:, t:t + 1]}, t)
        if lg.shape[-1] != cfg.vocab_size:
            lg = gather_vocab(lg, built.ctx.mp)
        logits.append(lg.numpy())
    out[case + "/logits"] = np.stack(logits)
    res = DecodeEngine(built.model, built.ctx, cache_dtype=built.cache_dtype,
                       step=built.fn).generate(params, torch.from_numpy(dref[case + "/prompts"]),
                                               DG)
    out[case + "/tokens"] = res.tokens.numpy()
"""


ROW_SIDE = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, rendezvous, ref_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5])
decode_ref_path = sys.argv[6]
dist.init_process_group("gloo", init_method=f"file://{{rendezvous}}", rank=rank,
                        world_size=world)
from repro_torch import configs
from repro_torch.buffer.state import UpdateSampleRows
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      StrategyConfig, TrainConfig)
from repro_torch.convert import load_named
from repro_torch.core.distributed import ExchangeRows
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.parallel import model_parallel, param_spec, shard_param
from repro_torch.parallel.tensor import gather_vocab, vocab_topk
from repro_torch.scenario import TokenClassIncremental
from repro_torch.scenario.trainer import materialize_state

V, S, B, STEPS, TAPS = {V}, {S}, {B}, {STEPS}, {TAPS}
DECODE_CASES, DB, DP, DG = {DECODE_CASES}, {DB}, {DP}, {DG}
{TAP_RUN}
ref = np.load(ref_path)
mesh = make_mesh((1, 2), ("data", "model"))
mp = model_parallel(mesh)
cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=V, num_layers=2)
full = {{k[len("params0/"):]: ref[k] for k in ref.files if k.startswith("params0/")}}
out = {{}}
for case, (strategy, top_k, sp) in TAPS.items():
    run = tap_run(cfg, strategy, top_k, sp)
    built = build_train_step(run, mesh, scenario=TokenClassIncremental(run.scenario),
                             exchange="full", buffer_budget_bytes=None, device="cpu")
    params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
    load_named(params, {{k: shard_param(v, param_spec(k, v.shape, cfg, 2), mp)
                        for k, v in full.items()}})
    for s in range(STEPS):
        p = f"{{case}}/s{{s}}/rows/"
        rows = ExchangeRows(
            UpdateSampleRows(*(torch.from_numpy(np.array(ref[p + n]))
                               for n in ("flat", "counts", "seen", "samp", "sv"))),
            torch.from_numpy(np.array(ref[p + "take"])).long())
        batch = {{k: ref[f"s{{s}}/batch/{{k}}"] for k in ("tokens", "labels", "task")}}
        params, opt, buf, reps, valid, m = built.fn(params, opt, buf, reps, valid, batch, 0,
                                                    rows=rows)
        out[f"{{case}}/s{{s}}/loss"] = float(m["loss"])
        out.update({{f"{{case}}/s{{s}}/buffer/{{k}}": v.numpy().copy()
                    for k, v in buf.data.items()}})
        out.update({{f"{{case}}/s{{s}}/reps/{{k}}": v.numpy().copy() for k, v in reps.items()}})
        out[f"{{case}}/s{{s}}/valid"] = valid.numpy().copy()
    out[f"{{case}}/aux_fields"] = np.array(sorted(built.meta["aux_fields"]))

# the shards' top-k merge against the whole vocabulary's: random rows (no
# ties), then rows whose equal values straddle the shards
g = torch.Generator().manual_seed(7)
whole = torch.randn(5, 3, 40, generator=g)
# each shard a permutation of the same 20 values: distinct within a shard,
# every value on both
tied = torch.cat([0.5 * torch.argsort(torch.rand(15, 20, generator=g)).float().reshape(5, 3, 20)
                  for _ in range(2)], dim=-1)
for name, x in (("random", whole), ("tied", tied)):
    for k in (1, 7, 20, 33):
        mine = x[..., rank * 20:(rank + 1) * 20]
        vals, idx = vocab_topk(mine, k, mp)
        out[f"topk/{{name}}/{{k}}/vals"] = vals.numpy()
        out[f"topk/{{name}}/{{k}}/idx"] = idx.numpy()
    out[f"topk/{{name}}/x"] = x.numpy()
    out[f"topk/{{name}}/gathered"] = gather_vocab(x[..., rank * 20:(rank + 1) * 20], mp).numpy()

# Whisper reduced served on the row: the serve CLI's tokens
res = serve.main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu", "--mesh", "1x2",
                  "--batch", "2", "--prompt-len", "6", "--gen-len", "5"])
out["whisper/tokens"] = res.tokens.numpy()
{DECODE_PART}
np.savez(out_path, **out)
import gc
gc.collect()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def row_of_two(tmp_path_factory):
    """JAX's ``build_train_step`` of every tap case on a (1, 2) fake-device
    mesh (a subprocess), then two gloo ranks of a 1 x 2 mesh running the
    port's on the JAX step's weights, rows and picks (the ``rows`` seam),
    the shards' top-k merge and ``serve --arch whisper-tiny --mesh 1x2``.
    Returns ``(JAX ref, [rank outputs])``."""
    import os
    import subprocess
    import sys
    import textwrap

    tmp = tmp_path_factory.mktemp("row_of_two")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "src")
    fmt = dict(V=V, S=TS, B=TB, STEPS=STEPS, TAPS=TAPS, TAP_RUN=_TAP_RUN,
               DECODE_PART=_DECODE_PART, DECODE_CASES=DECODE_CASES, DB=DB, DP=DP, DG=DG)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref_path = tmp / "taps_ref.npz"
    jp = subprocess.run([sys.executable, "-c", textwrap.dedent(TAP_JAX_SIDE.format(**fmt)),
                         str(ref_path)], env=env, capture_output=True, text=True,
                        timeout=600)
    assert jp.returncode == 0, jp.stderr[-4000:]
    decode_ref = tmp / "decode_ref.npz"
    _decode_refs(decode_ref)
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    code = textwrap.dedent(ROW_SIDE.format(**fmt))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), "2", str(tmp / "rdv"),
                               str(ref_path), str(tmp / f"row_{r}.npz"), str(decode_ref)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("worker timed out")
        assert p.returncode == 0, err[-4000:]
    return (np.load(ref_path), [np.load(tmp / f"row_{r}.npz") for r in range(2)],
            np.load(decode_ref))


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


@pytest.mark.parametrize("case", list(TAPS))
def test_tap_strategies_refuse_a_model_axis_naming_item_21(case, row_of_two):
    """Item 21's tap strategies on a model axis of 2: each case through
    ``build_train_step`` on two gloo ranks (the logits vocab-sharded) against
    JAX's at 1 x 2 on the same weights and rows. The records hold the whole
    vocabulary's logits (dense [S, V], or the top-8 pairs with global
    indices), as the reference's do: every integer leaf (tokens, labels,
    task, ``logit_idx``) of the buffer and the pending slot equal to
    JAX's (grasp_embed also under ``sequence_parallel``, its embedding the
    whole sequence's), every float leaf (logits, values, embeddings) within 1e-5 of its
    largest entry, and both ranks' records the same bits. The loss within
    1e-5 (relative). Named for the refusal it asserted before this path
    ran."""
    ref, ranks, _ = row_of_two
    strategy, top_k, _ = TAPS[case]
    want_fields = {"der": ["logit_idx", "logit_vals"] if top_k else ["logits"],
                   "grasp_embed": ["embed"]}[strategy.replace("_pp", "")]
    for got in ranks:
        assert sorted(got[f"{case}/aux_fields"].tolist()) == want_fields
    for s in range(STEPS):
        want_loss = float(ref[f"{case}/s{s}/loss"])
        for r, got in enumerate(ranks):
            assert abs(float(got[f"{case}/s{s}/loss"]) - want_loss) <= 1e-5 * abs(want_loss), (
                s, r, float(got[f"{case}/s{s}/loss"]), want_loss)
            np.testing.assert_array_equal(got[f"{case}/s{s}/valid"], ref[f"{case}/s{s}/valid"])
            for part in ("buffer", "reps"):
                names = [f.split("/")[-1] for f in ref.files
                         if f.startswith(f"{case}/s{s}/{part}/")]
                assert set(want_fields) <= set(names)
                for name in names:
                    a, b = got[f"{case}/s{s}/{part}/{name}"], ref[f"{case}/s{s}/{part}/{name}"]
                    np.testing.assert_array_equal(a, ranks[0][f"{case}/s{s}/{part}/{name}"])
                    if np.issubdtype(b.dtype, np.floating):
                        _close(a, b, 1e-5, f"{case} s{s} {part}/{name}")
                    else:
                        np.testing.assert_array_equal(a, b, err_msg=f"{case} {part}/{name}")


@pytest.mark.parametrize("k", [1, 7, 20, 33])
def test_vocab_topk_merges_the_shards_into_the_whole_vocabularys(k, row_of_two):
    """The shards' top-k merged over the row: on rows without ties, bit for
    bit ``torch.topk`` of the gathered logits (the set and the value order);
    on rows whose equal values straddle the shards (each value once on
    each), the reference's ``lax.top_k`` (equal values to the lowest
    index). Ties inside one shard follow that shard's ``torch.topk``, whose
    order among equal values torch does not define on the CPU. ``gather_vocab`` gives
    the whole row bit for bit."""
    import jax.numpy as jnp

    _, ranks, _ = row_of_two
    for got in ranks:
        for name in ("random", "tied"):
            x = got[f"topk/{name}/x"]
            np.testing.assert_array_equal(got[f"topk/{name}/gathered"], x)
            vals, idx = got[f"topk/{name}/{k}/vals"], got[f"topk/{name}/{k}/idx"]
            np.testing.assert_array_equal(np.take_along_axis(x, idx, -1), vals)
            if name == "random":
                tv, ti = torch.topk(torch.from_numpy(x), k)
                np.testing.assert_array_equal(vals, tv.numpy())
                np.testing.assert_array_equal(idx, ti.numpy())
            else:
                jv, ji = jax.lax.top_k(jnp.asarray(x), k)
                np.testing.assert_array_equal(vals, np.asarray(jv))
                np.testing.assert_array_equal(idx, np.asarray(ji))


def test_serve_refuses_the_encdec_on_a_model_axis(row_of_two):
    """Item 21's encoder-decoder served on a model axis: ``serve --arch
    whisper-tiny --reduced --mesh 1x2`` on two gloo ranks gives the 1 x 1
    run's token ids on both. Named for the refusal it asserted before this
    path ran."""
    from repro_torch.launch import serve

    want = serve.main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--gen-len", "5"]).tokens.numpy()
    for got in row_of_two[1]:
        np.testing.assert_array_equal(got["whisper/tokens"], want)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_sequence_sharded_decode_matches_the_reference(case, row_of_two):
    """Decode through ``build_decode_step`` on a 1 x 2 row whose KV heads do
    not split (``parallel.kv_seq_axes``: the cache's sequence over
    ``model``): each rank holds half of the slots and every KV head, the
    new token is written by the slot's owner, and the partial softmaxes are
    combined over the row (flash-decode). Teacher-forced on the reference's
    ids, every step's logits are within ``DECODE_TOL`` of the largest
    |logit| of the reference's f32 decode with the same ``kv_dtype``
    storage, and ``DecodeEngine``'s greedy ids equal the reference's, on
    both ranks. The ring case wraps its 8-slot window over 16 positions."""
    arch, over, kv_dtype = DECODE_CASES[case]
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    dref = row_of_two[2]
    slots = cfg.sliding_window or DP + DG
    for got in row_of_two[1]:
        assert got[case + "/split"].tolist() == ["k"]
        assert tuple(got[case + "/cache_shape"]) == (DB, slots // 2, cfg.num_kv_heads,
                                                     cfg.head_dim)
        assert str(got[case + "/cache_dtype"]) == f"torch.{kv_dtype}"
        _close(got[case + "/logits"], dref[case + "/logits"], DECODE_TOL[kv_dtype],
               f"{case} logits")
        np.testing.assert_array_equal(got[case + "/tokens"], dref[case + "/tokens"])


def test_each_rank_holds_half_of_the_cache_and_fp8_a_byte_a_value(row_of_two):
    """Each rank's cache bytes: the kv3 case's are half of the whole f32
    cache (4 layers of [2, 16, 3, 32] K and V), the fp8 cache's a quarter
    of those (one byte a value)."""
    whole = 4 * 2 * DB * (DP + DG) * 3 * 32 * 4
    for got in row_of_two[1]:
        assert int(got["kv3/cache_bytes"]) * 2 == whole
        assert int(got["fp8/cache_bytes"]) * 8 == whole


# ---------------------------------------------------------------------------
# The decode caches' layout against the reference's cache_shardings
# ---------------------------------------------------------------------------

CACHE_MESHES = {"1x2": ((1, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
                "16x16": ((16, 16), ("data", "model")),
                "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (global batch, context): decode_32k's, its batch 1, and long_500k's
CACHE_CELLS = ((128, 32768), (1, 32768), (1, 524288))

CACHE_RULE_SIDE = """
import functools, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import ARCHS, get_config, SHAPES, cell_applicable
from repro.models import build_model
from repro.parallel.sharding import cache_shardings

MESHES, CELLS = {MESHES}, {CELLS}
out = {{}}
for arch in ARCHS:
    cfg = get_config(arch)
    model = build_model(cfg)
    for b, length in CELLS:
        if length > 32768 and not cfg.subquadratic:
            continue
        if cfg.family == "encdec":
            params = jax.eval_shape(lambda k: model.init(k, length), jax.random.PRNGKey(0))
            caches = jax.eval_shape(lambda p: model.init_cache(p, b, length), params)
        else:
            caches = jax.eval_shape(functools.partial(model.init_cache, None, b, length))
        for name, (shape, axes) in MESHES.items():
            n = int(np.prod(shape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
            sh = cache_shardings(caches, mesh, cfg, b)
            for path, leaf in jax.tree_util.tree_flatten_with_path(caches)[0]:
                keys = [p.key for p in path]
                s = jax.tree_util.tree_map(lambda x: x, sh)
                for k in keys:
                    s = s[k]
                out[f"{{arch}}|{{b}}|{{length}}|{{name}}|{{'.'.join(keys)}}"] = list(
                    s.shard_shape(leaf.shape))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def cache_rule_ref(tmp_path_factory):
    """The reference's per-device shapes of every cache leaf (``NamedSharding
    .shard_shape`` of ``cache_shardings``), from a JAX subprocess with 512
    fake devices (``jax.eval_shape``: nothing allocated)."""
    import json
    import os
    import subprocess
    import sys
    import textwrap

    path = tmp_path_factory.mktemp("cache_rule") / "ref.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = textwrap.dedent(CACHE_RULE_SIDE.format(MESHES=CACHE_MESHES, CELLS=CACHE_CELLS))
    p = subprocess.run([sys.executable, "-c", code, str(path)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(path.read_text())


def _port_caches(cfg, b, length, shape, axes):
    """Rank 0's caches of ``cfg`` on a mesh of ``shape`` over ``axes`` for a
    global batch ``b`` and context ``length``, built on the meta device:
    the rank's batch slice (the whole batch when it does not divide the
    data-parallel ranks), its model shard and its ``SeqShard``s."""
    import types

    from repro_torch.parallel import ModelParallel, seq_split

    sizes = dict(zip(axes, shape))
    coord = {a: 0 for a in axes}
    m = sizes.get("model", 1)
    mp = None if m == 1 else ModelParallel(None, m, 0)
    n_dp = sizes.get("pod", 1) * sizes.get("data", 1)
    b_local = b // n_dp if b % n_dp == 0 else b
    ring = min(cfg.sliding_window, length) if cfg.sliding_window else length
    seq = {"k": seq_split(cfg, sizes, coord, b, ring)} if cfg.num_kv_heads else None
    if cfg.family == "encdec":
        seq["cross_k"] = seq_split(cfg, sizes, coord, b, length)
        stub = types.SimpleNamespace(embed=torch.empty(0, device="meta"),
                                     dec_layers=[None] * cfg.num_layers)
        return tf.init_encdec_cache(stub, cfg, b_local, length, mp=mp, seq=seq)
    return [tf.init_layer_cache(cfg, i, b_local, length, torch.bfloat16, torch.device("meta"),
                                mp, seq) for i in range(cfg.num_layers)]


@pytest.mark.parametrize("mesh", list(CACHE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_the_references_cache_shardings(arch, mesh, cache_rule_ref):
    """Every leaf of rank 0's decode caches (built by the port's
    ``init_cache`` chain with the rule's ``SeqShard``s) has the shape of the
    reference's per-device shard under ``cache_shardings``, for decode_32k's
    batch, a batch of 1 and long_500k's (subquadratic archs): KV heads over
    ``model`` when they divide M, else the sequence (and over ``data`` too
    when the batch does not divide the data-parallel ranks), SSM heads and
    ``conv_x`` over ``model``."""
    from repro_torch.models.transformer import unit_period

    cfg = configs.get_config(arch)
    shape, axes = CACHE_MESHES[mesh]
    checked = 0
    for b, length in CACHE_CELLS:
        if length > 32768 and not cfg.subquadratic:
            continue
        caches = _port_caches(cfg, b, length, shape, axes)
        for key, want in cache_rule_ref.items():
            a, kb, kl, km, path = key.split("|")
            if (a, int(kb), int(kl), km) != (arch, b, length, mesh):
                continue
            parts = path.split(".")
            if cfg.family == "encdec":  # [L, B, ...] a leaf
                layers, leaf = range(cfg.num_layers), parts[0]
            else:  # [U, B, ...] a unit's layer
                j = int(parts[0][len("layer"):])
                layers, leaf = range(j, cfg.num_layers, unit_period(cfg)), parts[1]
            for i in layers:
                got = tuple(caches[i][leaf].shape)
                assert got == tuple(want[1:]), (arch, b, length, mesh, i, leaf, got, want)
                checked += 1
    assert checked
