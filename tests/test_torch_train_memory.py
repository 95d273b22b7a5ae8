"""The train step's memory knobs in one process: activation checkpointing
(``TrainConfig.remat``), the ZeRO-1 rule (``parallel.zero1_spec``) and the
resharding of ZeRO-1 moments, the sequence-parallel refusals, and the carry
backend, which reads neither ``zero1`` nor ``sequence_parallel``.

  * remat: one loss and every gradient bit for bit across ``none``,
    ``dots``, ``dots_no_batch`` and ``full`` on the reduced dense, SSM, MoE
    (routing as chosen, then pinned, the recomputation replaying its
    layer's pins) and hybrid decoders, f32, ``full`` running every unit
    twice (its forward, then its recomputation) and the two ``dots``
    policies each layer's mixer stretch; ``dots`` against
    ``jax.value_and_grad`` under the reference's ``StackCtx(remat="dots")``
    within ``test_torch_lm_train.py``'s bounds (loss 1e-5 relative, each
    gradient 1e-4 of its largest entry); an unknown policy raises.
  * ZeRO-1: the port's ``zero1_spec`` of every leaf of every registered
    arch (full configs) on D x M = 2 x 1, 4 x 1, 2 x 2 and 4 x 2 against the
    reference's ``_opt_shardings(..., zero1=True)`` (a JAX subprocess with 8
    fake devices) on the same leaves one layer at a time (the reference's
    stacked scan axis, which the port has not, left out). They differ
    exactly on the head leaves the reference shards and the port
    replicates (its whole-head rule, ``test_torch_model_axis.py``).
  * ``reshard_carry`` of a 2-rank ZeRO-1 carry to 1 and back to 2 gives
    back the whole moments and every rank's slices exactly.
"""
import dataclasses
import functools
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

import repro.models.moe as JM
from repro.configs import get_reduced as jax_reduced
from repro.models import StackCtx as JaxCtx
from repro.models import build_model as jax_build
from repro_torch import configs
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig,
                                      TrainConfig)
from repro_torch.convert import lm_named_from_tree, lm_params_from_jax
from repro_torch.models import StackCtx, build_model
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import OptState
from repro_torch.parallel import ModelParallel, Zero1, attention_plan, param_spec, zero1_spec
from repro_torch.testdata import moved_pairs, routing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, S, B = 128, 16, 8
POLICIES = ("none", "dots", "dots_no_batch", "full")
# the reduced decoders, 2 layers (Jamba's unit of 4)
STACKS = {"dense": ("smollm-135m", 2), "ssm": ("mamba2-370m", 2), "moe": ("mixtral-8x7b", 2),
          "hybrid": ("jamba-v0.1-52b", 4)}


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


def _cfgs(case):
    arch, layers = STACKS[case]
    over = dict(vocab_size=V, num_layers=layers)
    return (dataclasses.replace(jax_reduced(arch), **over),
            dataclasses.replace(configs.get_reduced(arch), **over))


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32)}


class _LayerCalls:
    """Counts ``transformer.apply_layer`` calls (``n``) and the mixers'
    stretches run (``mixers``: the attention's mask, softmax and weighted
    sum, the plain SSD scan) while installed."""

    def __init__(self, monkeypatch):
        self.n = self.mixers = 0
        inner = tf.apply_layer

        def counted(*a, **kw):
            self.n += 1
            return inner(*a, **kw)

        monkeypatch.setattr(tf, "apply_layer", counted)
        for module, name in ((attn_lib, "_softmax_out"), (ssm_lib, "_scan")):
            monkeypatch.setattr(module, name, self._mixer(getattr(module, name)))

    def _mixer(self, fn):
        def counted(*a, **kw):
            self.mixers += 1
            return fn(*a, **kw)

        return counted


@pytest.mark.parametrize("case", list(STACKS))
def test_remat_policies_give_the_same_loss_and_gradients_bit_for_bit(case, monkeypatch):
    _, cfg = _cfgs(case)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), S, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.no_grad(), routing() as pins:
        model.loss(params, batch, StackCtx(cfg=cfg))
    calls = _LayerCalls(monkeypatch)
    # the MoE's routing as each run chooses it (the router's gradient flows
    # through its gates), then pinned (the recomputation replaying its
    # unit's pins)
    for pinned in ((False, True) if pins else (False,)):
        got = {}
        for policy in POLICIES:
            params.zero_grad(set_to_none=True)
            calls.n = calls.mixers = 0
            with routing(pins if pinned else None) as seen:
                loss, metrics = model.loss(params, batch, StackCtx(cfg=cfg, remat=policy))
                loss.backward()
            assert len(seen) == len(pins) and moved_pairs(seen, pins) == 0
            # full: the backward recomputes each unit once; dots and
            # dots_no_batch: each layer's mixer stretch, never a layer
            assert calls.n == cfg.num_layers * (2 if policy == "full" else 1), (policy, calls.n)
            assert calls.mixers == cfg.num_layers * (1 if policy == "none" else 2), (
                policy, calls.mixers)
            got[policy] = (loss.detach(), metrics["aux"].detach(),
                           {k: p.grad.clone() for k, p in params.named_parameters()})
        want = got["none"]
        assert (float(want[1]) > 0) == (case in ("moe", "hybrid"))
        for policy in POLICIES[1:]:
            loss, aux, grads = got[policy]
            assert torch.equal(loss, want[0]) and torch.equal(aux, want[1]), policy
            for name, g in grads.items():
                assert torch.equal(g, want[2][name]), (pinned, policy, name)


def _jax_routing(jmodel, jparams, jbatch, jcfg, monkeypatch):
    """The experts the reference's forward chooses at each MoE layer."""
    calls, route = [], JM.route

    def recording(params, x, cfg):
        gates, experts, aux = route(params, x, cfg)
        calls.append((torch.from_numpy(np.array(gates)), torch.from_numpy(np.array(experts))))
        return gates, experts, aux

    monkeypatch.setattr(JM, "route", recording)
    jmodel.forward(jparams, jbatch, JaxCtx(cfg=jcfg, remat="none", scan_layers=False))
    monkeypatch.setattr(JM, "route", route)
    return calls


@pytest.mark.parametrize("case", ["dense", "ssm", "moe"])
def test_dots_matches_jax_value_and_grad_under_dots(case, monkeypatch):
    jcfg, cfg = _cfgs(case)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=S)
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_routing = (_jax_routing(jmodel, jparams, jbatch, jcfg, monkeypatch)
                    if case == "moe" else [])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, JaxCtx(cfg=jcfg, remat="dots")), has_aux=True))(jparams)
    with routing() as calls:
        loss, _ = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                             StackCtx(cfg=cfg, remat="dots"))
        loss.backward()
    # the same experts as the reference's, each MoE layer recorded once
    assert len(calls) == len(want_routing) and moved_pairs(calls, want_routing) == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = lm_named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want) == {n for n, _ in params.named_parameters()}
    for name, p in params.named_parameters():
        assert float(np.abs(want[name]).max()) > 0, name
        _close(p.grad.numpy(), want[name], 1e-4, name)


@pytest.mark.parametrize("where", ["ctx", "remat_call", "train_config"])
def test_unknown_remat_policy_raises(where):
    _, cfg = _cfgs("dense")
    with pytest.raises(ValueError, match="remat policy 'offload'"):
        if where == "ctx":
            StackCtx(cfg=cfg, remat="offload")
        elif where == "remat_call":
            tf.remat_call(lambda x: x, "offload", torch.zeros(1))
        else:
            from repro_torch.scenario.scenarios import build_token_lm

            build_token_lm(RunConfig(model=cfg, train=TrainConfig(remat="offload")), V)


def test_train_contexts_carry_remat_and_eval_runs_without():
    from repro_torch.scenario.scenarios import build_token_lm

    _, cfg = _cfgs("dense")
    _, ctx, eval_ctx = build_token_lm(RunConfig(model=cfg), V)
    assert TrainConfig().remat == "dots" and ctx.remat == "dots"
    assert eval_ctx.remat == "none" and not eval_ctx.sequence_parallel
    mp = ModelParallel(None, 2, 0)
    _, ctx, eval_ctx = build_token_lm(RunConfig(model=cfg, train=TrainConfig(
        remat="full", sequence_parallel=True)), V, mp)
    assert ctx.remat == "full" and ctx.sequence_parallel and ctx.mp.sequence_parallel
    assert eval_ctx.remat == "none" and not eval_ctx.sequence_parallel
    # without a model row there is nothing to split
    _, ctx, _ = build_token_lm(RunConfig(model=cfg, train=TrainConfig(sequence_parallel=True)), V)
    assert ctx.mp is None and not ctx.sequence_parallel


@pytest.mark.parametrize("s,m", [(15, 2), (18, 4)])
def test_sequence_parallel_refuses_a_sequence_the_row_does_not_split(s, m):
    """The reference lets GSPMD pad; the port raises, naming S and M (no
    collective is issued before the check)."""
    _, cfg = _cfgs("dense")
    model = build_model(cfg)
    mp = ModelParallel(None, m, 0, sequence_parallel=True)
    params = model.init(torch.Generator().manual_seed(0), s, "cpu", mp)
    tokens = torch.zeros((2, s), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"S = {s} .* M = {m}"):
        model.forward(params, {"tokens": tokens}, StackCtx(cfg=cfg, mp=mp))


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

MESHES = ((2, 1), (4, 1), (2, 2), (4, 2))
ATTN = ("wq", "wk", "wv", "wo")
SSM_HEAD = ("w_z", "w_x", "w_dt", "conv_x", "conv_bias_x", "norm_scale", "A_log", "D",
            "dt_bias", "out_proj")

REF_SIDE = """
import json, sys
import jax
from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.launch.mesh import make_mesh
from repro.launch.steps import _opt_shardings
from repro.models import build_model, transformer
from repro.optim import make_optimizer

ARCHS, MESHES = {ARCHS}, {MESHES}
out = {{}}
for arch in ARCHS:
    cfg = get_config(arch)
    tree = jax.eval_shape(lambda k: build_model(cfg).init(k, 64), jax.random.PRNGKey(0))
    p = transformer.unit_period(cfg)
    layers = {{}}  # the port's names, one layer at a time (the scan axis left out)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] == "units":
            name, shape = [f"layers.{{int(keys[1][len('layer'):])}}"] + keys[2:], leaf.shape[1:]
        elif keys[0] in ("enc_layers", "dec_layers"):
            name, shape = [f"{{keys[0]}}.0"] + keys[1:], leaf.shape[1:]
        else:
            name, shape = keys, leaf.shape
        node = layers
        for k in name[:-1]:
            node = node.setdefault(k, {{}})
        node[name[-1]] = jax.ShapeDtypeStruct(shape, leaf.dtype)
    opt_s = jax.eval_shape(make_optimizer(TrainConfig(optimizer="adamw"))[0], layers)
    out[arch] = {{}}
    for d, m in MESHES:
        mesh = make_mesh((d, m), ("data", "model"))
        sh = _opt_shardings(opt_s, layers, cfg, mesh, zero1=True)
        out[arch][f"{{d}}x{{m}}"] = {{
            ".".join(k.key for k in path): [list(leaf.shape), [
                a if a is None else str(a) for a in
                tuple(s.spec) + (None,) * (len(leaf.shape) - len(s.spec))]]
            for (path, s), leaf in zip(jax.tree_util.tree_flatten_with_path(sh.mu)[0],
                                       jax.tree_util.tree_leaves(opt_s.mu))}}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _reference_zero1():
    """{arch: {"DxM": {port name: [shape, spec]}}} of the reference's
    ``_opt_shardings(..., zero1=True)`` (AdamW's ``mu``)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(REF_SIDE.format(ARCHS=list(configs.ARCHS), MESHES=MESHES))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _heads_split(cfg, name, m):
    """Whether a head leaf's heads split whole over ``m`` ranks (None for a
    leaf without heads): the port's rule, ``test_torch_model_axis.py``'s."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if parent in ("attn", "cross") and leaf in ATTN:
        plan = attention_plan(cfg, m)
        if leaf in ("wk", "wv"):
            return plan is not None and plan.kv_sharded
        return plan is not None
    if parent == "ssm" and leaf in SSM_HEAD:
        return (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) % m == 0
    return None


@pytest.mark.parametrize("mesh", MESHES, ids=lambda dm: f"{dm[0]}x{dm[1]}")
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_zero1_spec_matches_the_reference_but_for_split_heads(arch, mesh):
    d, m = mesh
    cfg = configs.get_config(arch)
    ref = _reference_zero1()[arch][f"{d}x{m}"]
    assert ref
    differs, expected, cut = [], [], 0
    for name, (shape, want) in sorted(ref.items()):
        shape, want = tuple(shape), tuple(want)
        got = zero1_spec(param_spec(name, shape, cfg, m, axis_of_one=True), shape, d)
        cut += "data" in got
        if got != want:
            differs.append(name)
        if _heads_split(cfg, name, m) is False and "model" in want:
            expected.append(name)
    assert differs == expected, sorted(set(differs) ^ set(expected))
    assert cut  # the rule cuts something on every arch


@pytest.mark.parametrize("spec,shape,d,want", [
    ((None, None), (576, 1536), 2, (None, "data")),
    (("model", None), (576, 1536), 2, ("model", "data")),
    ((None,), (9,), 2, (None,)),  # nothing divides: whole
    ((None, None), (8, 8), 4, ("data", None)),  # the first of equal dims
    ((None, None, "model"), (8, 4096, 7168), 4, (None, "data", "model")),
])
def test_zero1_spec_rule(spec, shape, d, want):
    assert zero1_spec(spec, shape, d) == want
    z = Zero1(None, d, d - 1)
    dim = z.dim(shape, spec)
    assert dim == (want.index("data") if "data" in want else None)
    if dim is not None:
        t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        n = shape[dim] // d
        assert torch.equal(z.shard(t, dim), t.narrow(dim, (d - 1) * n, n))


def _zero1_carries(n):
    """``n`` ranks' ZeRO-1 carries of one trained state: the reduced SmolLM
    whole on each, AdamW moments made distinct, each rank's slices of them
    (``make_optimizer(zero1=...)``'s init, filled from the whole ones)."""
    from repro_torch.strategy.step import TrainCarry

    _, cfg = _cfgs("dense")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), S, "cpu")
    named = dict(params.named_parameters())
    gen = torch.Generator().manual_seed(3)
    whole = [{k: torch.randn(p.shape, generator=gen) for k, p in named.items()}
             for _ in range(2)]
    carries = []
    for w in range(n):
        zero1 = Zero1(None, n, w) if n > 1 else None
        opt = make_optimizer(TrainConfig(optimizer="adamw"), zero1=zero1)[0](
            named, params.layout_specs)
        for mom, full in zip((opt.mu, opt.nu), whole):
            for k, t in mom.items():
                dim = zero1.dim(tuple(named[k].shape), params.layout_specs[k]) if zero1 else None
                t.copy_(full[k] if dim is None else zero1.shard(full[k], dim))
        carries.append(TrainCarry(params, OptState(5, opt.mu, opt.nu), None, None))
    return carries, whole


def test_reshard_carry_keeps_every_ranks_zero1_moments():
    """2 -> 1 joins each moment whole, exactly; 1 -> 2 cuts it again into
    the slices the 2 ranks held (the first leaf cut on another dim than 0
    included)."""
    from repro_torch.runtime.elastic import reshard_carry

    two, whole = _zero1_carries(2)
    assert any(m.shape != p.shape for m, p in zip(two[0].opt.mu.values(),
                                                  two[0].params.parameters()))
    (one,) = reshard_carry(two, 1, zero1=True)
    assert one.opt.step == 5
    for mom, full in zip((one.opt.mu, one.opt.nu), whole):
        assert set(mom) == set(full)
        for k in full:
            assert torch.equal(mom[k], full[k]), k
    back = reshard_carry([one], 2, zero1=True)
    for got, want in zip(back, two):
        for mom in ("mu", "nu"):
            for k, t in getattr(want.opt, mom).items():
                assert torch.equal(getattr(got.opt, mom)[k], t), (mom, k)
    assert reshard_carry([one], 2)[0].opt is one.opt  # whole moments stay whole


def test_scale_carry_grows_a_zero1_run_from_one_worker():
    """``scale_carry`` 1 -> 2 of a ZeRO-1 run (``zero1`` from its
    ``TrainConfig``): at one worker the moments are whole, and each new rank
    gets the slices its optimizer's init allocates, the whole moments' cut."""
    from repro_torch.runtime import scale_carry

    (one,), _ = _zero1_carries(1)
    two, _ = _zero1_carries(2)
    got, _ = scale_carry([one], 2, zero1=TrainConfig(zero1=True).zero1)
    for w in range(2):
        for mom in ("mu", "nu"):
            for k, t in getattr(two[w].opt, mom).items():
                assert torch.equal(getattr(got[w].opt, mom)[k], t), (w, mom, k)


def test_carry_backend_ignores_zero1_and_sequence_parallel():
    """Without a mesh the trainer is one process: the reference's carry
    backend never reads the two knobs, and the port's history and final
    state are those of the run without them, bit for bit, its moments
    whole."""
    from repro_torch.scenario import ContinualTrainer

    _, cfg = _cfgs("dense")

    def fit(**knobs):
        run = RunConfig(
            model=cfg, train=TrainConfig(optimizer="adamw", peak_lr=1e-3, warmup_steps=5,
                                         linear_scaling=False, compute_dtype="float32",
                                         **knobs),
            rehearsal=RehearsalConfig(num_buckets=2, slots_per_bucket=4,
                                      num_representatives=3, num_candidates=6,
                                      label_field="labels", task_field="task"),
            scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                    strategy="rehearsal", num_tasks=2, epochs_per_task=1,
                                    steps_per_epoch=3, batch_size=B, vocab_size=V, seq_len=S,
                                    auto_defaults=False))
        trainer = ContinualTrainer(run, device="cpu")
        made, init = [], trainer._init
        trainer._init = lambda seed: made.append(init(seed)) or made[-1]
        return trainer.fit(), made[0]  # the carry's model is trained in place

    base, base_carry = fit()
    got, carry = fit(zero1=True, sequence_parallel=True)
    assert got.losses == base.losses and got.history == base.history
    assert got.accuracy_matrix.tolist() == base.accuracy_matrix.tolist()
    want = dict(base_carry.params.named_parameters())
    for k, p in carry.params.named_parameters():
        assert torch.equal(p, want[k]), k
        assert carry.opt.mu[k].shape == carry.opt.nu[k].shape == p.shape, k
