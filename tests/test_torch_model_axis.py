"""The model axis in one process: the port's rule table against the
reference's ``repro.parallel.sharding.param_spec`` on every leaf of every
registered arch (full configs, built on ``torch.device("meta")``), the
shard-aware init (each rank's model is exactly the unsharded model's
slices), the head plans, the converter's shards, and the options that still
refuse a model axis over 1, naming ROADMAP Queue 1 item 21.

The collectives run in ``tests/test_torch_model_axis_ranks.py`` (gloo
ranks). A ``ModelParallel`` here has no group: init and slicing issue no
collective.
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


def test_encdec_on_a_model_axis_raises_naming_item_21():
    from repro_torch.models import StackCtx, build_model

    cfg = configs.get_reduced("whisper-tiny")
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match="item 21"):
        model.init(torch.Generator().manual_seed(0), 16, "cpu", ModelParallel(None, 2, 0))
    params = model.init(torch.Generator().manual_seed(0), 16, "cpu")
    batch = {"frames": torch.zeros(1, 4, cfg.d_model), "tokens": torch.zeros(1, 4).long()}
    with pytest.raises(NotImplementedError, match="item 21"):
        model.forward(params, batch, StackCtx(cfg=cfg, mp=ModelParallel(None, 2, 0)))


def test_elastic_reshard_of_sharded_carries_raises_naming_item_21():
    from repro_torch.runtime.elastic import reshard_carry
    from repro_torch.strategy.step import TrainCarry

    cfg = configs.get_reduced("smollm-135m")
    model = tf.Decoder(torch.Generator().manual_seed(0), cfg, 16, ModelParallel(None, 2, 0))
    with pytest.raises(NotImplementedError, match="item 21"):
        reshard_carry([TrainCarry(model, None, None, None, None)], 2)


def test_production_meshes_need_their_process_group():
    from repro_torch.launch.mesh import make_production_mesh

    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="process group"):
            make_production_mesh(multi_pod)


def test_serve_refuses_the_encdec_on_a_model_axis():
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match="item 21"):
        serve.main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu", "--mesh", "1x2"])


def test_tap_strategies_refuse_a_model_axis_naming_item_21():
    from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                          TrainConfig)
    from repro_torch.launch.steps import build_train_step

    class _RowOfTwo:
        """A one-worker mesh whose model axis is 2 (rank 0), no group."""

        device_type, mesh_dim_names = "cpu", ("data", "model")

        def size(self, mesh_dim=None):
            return (1, 2)[mesh_dim]

        def get_group(self, mesh_dim=None):
            return None

        def get_coordinate(self):
            return [0, 0]

    cfg = dataclasses.replace(configs.get_reduced("smollm-135m"), vocab_size=64, num_layers=1)
    run = RunConfig(model=cfg, train=TrainConfig(optimizer="adamw", compute_dtype="float32"),
                    rehearsal=RehearsalConfig(num_buckets=2, mode="async"),
                    scenario=ScenarioConfig(modality="tokens", strategy="der_pp", num_tasks=2,
                                            batch_size=2, vocab_size=64, seq_len=8,
                                            auto_defaults=False))
    with pytest.raises(NotImplementedError, match="item 21"):
        build_train_step(run, _RowOfTwo(), device="cpu")
