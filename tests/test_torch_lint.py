"""The port's replint (``repro_torch.analysis.lint``) held against the JAX
package's (``repro.analysis.lint``).

Every case of ``tests/test_lint.py`` has a torch fixture here with the same
line layout: the JAX fixture goes through the reference's ``lint_source``,
the torch fixture through the port's, each with ``select`` pinned to the
rule, and the two ``(code, line)`` lists must be equal (and equal to what
``tests/test_lint.py`` expects). The plumbing (suppressions, the JSON
schema, the CLI's exit codes, the file walk) gets the same inputs on both
sides. Then the cases the reference has no counterpart for, and the gate:
the port's own tree lints clean.
"""
import ast
import glob
import importlib
import json
import os
import textwrap

import pytest
import torch

import repro.analysis.lint as jlint
from repro.analysis.lint.__main__ import main as jlint_main
from repro.analysis.lint.common import int_literals as jint_literals
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.lint.__main__ import main as tlint_main
from repro_torch.analysis.lint.common import int_literals as tint_literals
from repro_torch.analysis.lint.rules_inplace import WRITERS
from repro_torch.analysis.lint.rules_obs import OBS_READS, STATE_SINKS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = ["RPL001", "RPL002", "RPL010", "RPL020", "RPL021", "RPL030", "RPL031", "RPL032",
         "RPL040", "RPL041"]


def run(pkg, src, select, path="fixture.py"):
    return pkg.lint_source(textwrap.dedent(src), path, select=select)


def pairs(result):
    return [(f.code, f.line) for f in result.findings]


# ---------------------------------------------------------------------------
# Rule cases: (test of tests/test_lint.py, rule, expected codes, JAX fixture,
# torch fixture, a word the torch message must hold)
# ---------------------------------------------------------------------------

RULE_CASES = [
    # -- RPL001 ------------------------------------------------------------
    ("rpl001_flags_key_reuse", "RPL001", ["RPL001"], """
        import jax

        def f(key):
            a = jax.random.normal(key, (4,))
            b = jax.random.normal(key, (4,))
            return a + b
    """, """
        import torch
        from repro_torch.rng import generator
        def f(key):
            a = torch.randn(4, generator=generator(key, "cpu"))
            b = torch.randn(4, generator=generator(key, "cpu"))
            return a + b
    """, "key"),
    ("rpl001_split_and_fold_in_are_clean", "RPL001", [], """
        import jax

        def f(key):
            k1, k2 = jax.random.split(key)
            a = jax.random.normal(k1, (4,))
            return a + jax.random.normal(k2, (4,))

        def g(key):
            out = 0.0
            for i in range(3):
                out = out + jax.random.normal(jax.random.fold_in(key, i), ())
            return out
    """, """
        import torch
        from repro_torch.rng import fold_in, generator
        def f(key):
            k1, k2 = fold_in(key, 1), fold_in(key, 2)
            a = torch.randn(4, generator=generator(k1, "cpu"))
            return a + torch.randn(4, generator=generator(k2, "cpu"))

        def g(key):
            out = 0.0
            for i in range(3):
                out = out + torch.randn((), generator=generator(fold_in(key, i), "cpu"))
            return out
    """, None),
    ("rpl001_loop_carried_reuse", "RPL001", ["RPL001"], """
        import jax

        def f(key):
            out = 0.0
            for i in range(3):
                out = out + jax.random.normal(key, ())
            return out
    """, """
        import torch
        from repro_torch.rng import generator
        def f(key):
            out = 0.0
            for i in range(3):
                out = out + torch.randn((), generator=generator(key, "cpu"))
            return out
    """, "key"),
    ("rpl001_early_return_branch_does_not_leak", "RPL001", [], """
        import jax

        def f(key, fast):
            if fast:
                return jax.random.normal(key, ())
            return jax.random.uniform(key, ())
    """, """
        import torch
        from repro_torch.rng import generator
        def f(key, fast):
            if fast:
                return torch.randn((), generator=generator(key, "cpu"))
            return torch.rand((), generator=generator(key, "cpu"))
    """, None),
    ("rpl001_root_key_may_fan_out_until_split", "RPL001", [], """
        import jax

        def setup(init_fn, derive_fn):
            key = jax.random.PRNGKey(0)
            params = init_fn(key)
            step_key = derive_fn(key)
            return params, step_key
    """, """
        import torch

        def setup(init_fn, derive_fn):
            key = 0
            params = init_fn(key)
            step_key = derive_fn(key)
            return params, step_key
    """, None),
    ("rpl001_derived_key_single_owner_across_calls", "RPL001", ["RPL001"], """
        import jax

        def f(key, init_fn, derive_fn):
            params = init_fn(key)
            other = derive_fn(key)
            return params, other
    """, """
        import torch

        def f(key, init_fn, derive_fn):
            params = init_fn(key)
            other = derive_fn(key)
            return params, other
    """, "key"),
    # -- RPL002 ------------------------------------------------------------
    ("rpl002_flags_fold_in_product_stored_in_slot", "RPL002", ["RPL002"], """
        import jax
        from repro.strategy import PipelinedRehearsalCarry

        def issue(buffer, pipe, batch, key, sample):
            k_issue = jax.random.fold_in(pipe.key, 0)
            reps, valid = sample(buffer, k_issue)
            return PipelinedRehearsalCarry(reps, valid, k_issue)
    """, """
        from repro_torch.rng import fold_in, generator
        from repro_torch.strategy import PipelinedRehearsalCarry

        def issue(buffer, pipe, batch, key, sample):
            k_issue = fold_in(pipe.key, 0)
            reps, valid = sample(buffer, generator(k_issue, "cpu"))
            return PipelinedRehearsalCarry(reps, valid, k_issue)
    """, "fold_in"),
    ("rpl002_flags_frozen_pipe_key", "RPL002", ["RPL002"], """
        from repro.strategy import PipelinedRehearsalCarry

        def issue(pipe, new_reps, new_valid):
            return PipelinedRehearsalCarry(new_reps, new_valid, pipe.key)
    """, """
        from repro_torch.strategy import PipelinedRehearsalCarry

        def issue(pipe, new_reps, new_valid):
            return PipelinedRehearsalCarry(new_reps, new_valid, pipe.key)
    """, "pipe.key"),
    ("rpl002_fresh_incoming_key_is_clean", "RPL002", [], """
        from repro.strategy import PipelinedRehearsalCarry

        def issue(pending, key):
            return PipelinedRehearsalCarry(pending.reps, pending.valid, key)
    """, """
        from repro_torch.strategy import PipelinedRehearsalCarry

        def issue(pending, key):
            return PipelinedRehearsalCarry(pending.reps, pending.valid, key)
    """, None),
    ("rpl002_wholesale_relayout_is_exempt", "RPL002", [], """
        from repro.strategy import PipelinedRehearsalCarry

        def relayout(pipe, shard):
            return PipelinedRehearsalCarry(
                shard(pipe.reps), shard(pipe.valid), pipe.key)
    """, """
        from repro_torch.strategy import PipelinedRehearsalCarry

        def relayout(pipe, shard):
            return PipelinedRehearsalCarry(
                shard(pipe.reps), shard(pipe.valid), pipe.key)
    """, None),
    # -- RPL010: the carry form mirrors donation, the kernel form aliasing --
    ("rpl010_flags_read_after_donating_call", "RPL010", ["RPL010"], """
        import jax

        def body(carry, batch):
            return carry, 0.0

        step = jax.jit(body, donate_argnums=(0,))

        def loop(carry, batch, history):
            new_carry, m = step(carry, batch)
            history.append(carry["loss"])
            return new_carry
    """, """
        from repro_torch.strategy import make_cl_step

        def loss_fn(model, batch):
            return model(batch["x"]).sum(), {}

        step = make_cl_step(loss_fn, opt_update, rcfg)

        def loop(carry, batch, key, history):
            new_carry, m = step(carry, batch, key)
            history.append(carry.buffer)
            return new_carry
    """, "in place"),
    ("rpl010_rebinding_the_carry_is_clean", "RPL010", [], """
        import jax

        def body(carry, batch):
            return carry, 0.0

        step = jax.jit(body, donate_argnums=(0,))

        def loop(carry, batch):
            carry, m = step(carry, batch)
            return carry["loss"]
    """, """
        from repro_torch.strategy import make_cl_step

        def loss_fn(model, batch):
            return model(batch["x"]).sum(), {}

        step = make_cl_step(loss_fn, opt_update, rcfg)

        def loop(carry, batch, key):
            carry, m = step(carry, batch, key)
            return carry.buffer
    """, None),
    ("rpl010_conditional_donate_argnums_resolves_literals", "RPL010", ["RPL010"], """
        import functools
        import jax

        donate = True

        @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
        def step(carry, batch):
            return carry, 0.0

        def loop(carry, batch):
            out, m = step(carry, batch)
            return carry, out
    """, """
        from repro_torch.strategy import make_cl_step, make_stale_step


        stale = True

        step = (make_stale_step(loss_fn, opt_update, rcfg) if stale
                else make_cl_step(loss_fn, opt_update, rcfg))


        def loop(carry, batch, key):
            out, m = step(carry, batch, key)
            return carry, out
    """, "in place"),
    ("rpl010_flags_read_after_aliased_pallas_call", "RPL010", ["RPL010"], """
        import jax
        from jax.experimental import pallas as pl

        def wrapper(rows, samp, buffer, cands, kernel, shapes):
            new_buffer, reps = pl.pallas_call(
                kernel,
                out_shape=shapes,
                input_output_aliases={2: 0},
            )(rows, samp, buffer, cands)
            stale = buffer[0]
            fresh = rows[0] + cands[0]
            return new_buffer, reps, stale, fresh
    """, """
        import torch
        from repro_torch.kernels import rehearsal_ops

        def wrapper(rows, samp, buffer, cands, kernel, shapes):
            head = buffer[0]
            new_buffer, reps = rehearsal_ops.rehearsal_update_sample(
                buffer,
                cands,
                rows, samp)
            stale = head + 0
            fresh = rows[0] + cands[0]
            return new_buffer, reps, stale, fresh
    """, "buffer"),
    ("rpl010_flags_read_after_name_bound_aliased_pallas_call", "RPL010", ["RPL010"], """
        import jax
        from jax.experimental import pallas as pl

        def make(kernel, shapes):
            op = pl.pallas_call(kernel, out_shape=shapes,
                                input_output_aliases={0: 0})

            def apply(table, x):
                out = op(table, x)
                return out, table.shape
            return apply
    """, """
        import torch
        from repro_torch.kernels import rehearsal_ops

        def make(kernel, shapes):
            op = rehearsal_ops.rehearsal_update_sample

            def apply(table, x, rows):
                head = table.view(-1)
                out = op(table, x, rows, rows)
                return out, head.shape
            return apply
    """, "table"),
    ("rpl010_unaliased_pallas_call_is_clean", "RPL010", [], """
        import jax
        from jax.experimental import pallas as pl

        def wrapper(x, kernel, shapes):
            out = pl.pallas_call(kernel, out_shape=shapes)(x)
            return out + x[0]
    """, """
        import torch
        from repro_torch.kernels import rehearsal_ops

        def wrapper(x, scales, rows):
            head, scale = x[0].clone(), scales[0]
            read = rehearsal_ops.gather_dequant_rows(x, scales, rows)
            out = rehearsal_ops.rehearsal_update_sample(x, head[None], rows, rows)
            return out, read, head, x[0], scale
    """, None),
    # -- RPL020 / RPL021 ---------------------------------------------------
    ("rpl020_flags_host_effects_in_jit", "RPL020", ["RPL020", "RPL020"], """
        import time

        import jax

        @jax.jit
        def step(x):
            t = time.time()
            print("stepping")
            return x * t
    """, """
        import time

        import torch

        @torch.compile
        def step(x):
            t = time.time()
            print("stepping")
            return x * t
    """, "capture"),
    ("rpl020_host_effects_outside_jit_are_fine", "RPL020", [], """
        import time

        def wall_clock():
            return time.time()
    """, """
        import time

        def wall_clock():
            return time.time()
    """, None),
    ("rpl020_follows_the_call_graph", "RPL020", ["RPL020"], """
        import jax

        def helper(x):
            print(x)
            return x

        @jax.jit
        def step(x):
            return helper(x)
    """, """
        import torch

        def helper(x):
            print(x)
            return x

        @torch.compile
        def step(x):
            return helper(x)
    """, "helper"),
    ("rpl021_flags_traced_truthiness", "RPL021", ["RPL021"], """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x):
            if jnp.any(x > 0):
                return x
            return -x
    """, """
        import torch


        @torch.compile
        def f(x):
            if torch.any(x > 0):
                return x
            return -x
    """, "torch.any"),
    ("rpl021_config_flags_are_fine", "RPL021", [], """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x, donate=False):
            if donate:
                return x
            return jnp.where(x > 0, x, -x)
    """, """
        import torch


        @torch.compile
        def f(x, pipelined=False):
            if pipelined:
                return x
            return torch.where(x > 0, x, -x)
    """, None),
    # -- RPL030 / RPL031 / RPL032 ------------------------------------------
    ("rpl030_policy_with_aux_must_reshard", "RPL030", ["RPL030"], """
        from repro.buffer import Policy

        class Fifo(Policy):
            def init_aux(self, spec):
                return {"cursor": 0}
    """, """
        from repro_torch.buffer import Policy

        class Fifo(Policy):
            def init_aux(self, item_spec, num_buckets, slots, device=None):
                return {"cursor": 0}
    """, "reshard_aux"),
    ("rpl030_reshard_aux_override_is_clean", "RPL030", [], """
        from repro.buffer import Policy

        class Fifo(Policy):
            def init_aux(self, spec):
                return {"cursor": 0}

            def reshard_aux(self, aux, plan):
                return aux
    """, """
        from repro_torch.buffer import Policy

        class Fifo(Policy):
            def init_aux(self, item_spec, num_buckets, slots, device=None):
                return {"cursor": 0}

            def reshard_aux(self, data, counts):
                return {"cursor": 0}
    """, None),
    ("rpl030_stateless_policy_needs_no_reshard", "RPL030", [], """
        from repro.buffer import Policy

        class Reservoir(Policy):
            def init_aux(self, spec):
                return {}
    """, """
        from repro_torch.buffer import Policy

        class Reservoir(Policy):
            def init_aux(self, item_spec, num_buckets, slots, device=None):
                return ()
    """, None),
    ("rpl031_params_only_checkpoint_in_rehearsal_module", "RPL031", ["RPL031"], """
        from repro.strategy import init_carry

        def save_ckpt(mgr, params):
            spec = {"params": params}
            mgr.save(0, spec)
    """, """
        from repro_torch.strategy import init_carry

        def save_ckpt(mgr, params):
            spec = {"params": params}
            mgr.save(0, spec)
    """, "buffer"),
    ("rpl031_buffer_in_spec_or_update_is_clean", "RPL031", [], """
        from repro.strategy import init_carry

        def save_full(mgr, params, buffer):
            spec = {"params": params, "buffer": buffer}
            mgr.save(0, spec)

        def save_augmented(mgr, params, carry):
            spec = {"params": params}
            spec.update(buffer=carry.buffer, reps=carry.pipe.reps)
            mgr.save(0, spec)
    """, """
        from repro_torch.strategy import init_carry

        def save_full(mgr, params, buffer):
            spec = {"params": params, "buffer": buffer}
            mgr.save(0, spec)

        def save_augmented(mgr, params, carry):
            spec = {"params": params}
            spec.update(buffer=carry.buffer, reps=carry.pipe.reps)
            mgr.save(0, spec)
    """, None),
    ("rpl031_silent_outside_rehearsal_modules", "RPL031", [], """
        def save_ckpt(mgr, params):
            mgr.save(0, {"params": params})
    """, """
        def save_ckpt(mgr, params):
            mgr.save(0, {"params": params})
    """, None),
    ("rpl032_declared_fields_need_on_store", "RPL032", ["RPL032"], """
        from repro.strategy import Strategy

        class Der(Strategy):
            def record_fields(self, item_spec, outputs_spec, scfg):
                return {"logits": outputs_spec["logits"]}
    """, """
        from repro_torch.strategy import Strategy

        class Der(Strategy):
            def record_fields(self, item_spec, outputs_spec, scfg):
                return {"logits": outputs_spec["logits"]}
    """, "on_store"),
    ("rpl032_on_store_override_is_clean", "RPL032", [], """
        from repro.strategy import Strategy

        class Der(Strategy):
            def record_fields(self, item_spec, outputs_spec, scfg):
                return {"logits": outputs_spec["logits"]}

            def on_store(self, batch, outputs):
                return {"logits": outputs["logits"]}
    """, """
        from repro_torch.strategy import Strategy

        class Der(Strategy):
            def record_fields(self, item_spec, outputs_spec, scfg):
                return {"logits": outputs_spec["logits"]}

            def on_store(self, batch, outputs, scfg, mp=None):
                return dict(batch, logits=outputs["logits"])
    """, None),
    # -- RPL040 / RPL041 ---------------------------------------------------
    ("rpl040_obs_value_into_state_constructor", "RPL040", ["RPL040"], """
        from repro.obs.metrics import step_metrics
        from repro.strategy import TrainCarry

        def step(carry, batch):
            gauges = step_metrics(carry)
            return TrainCarry(carry.params, gauges), gauges
    """, """
        from repro_torch.obs.metrics import step_metrics
        from repro_torch.strategy import TrainCarry

        def step(carry, batch):
            gauges = step_metrics(buffer=carry.buffer)
            return TrainCarry(carry.params, gauges, None, None), gauges
    """, "TrainCarry"),
    ("rpl040_obs_into_metrics_output_is_clean", "RPL040", [], """
        from repro.obs.metrics import step_metrics
        from repro.strategy import TrainCarry

        def step(carry, batch, new_params):
            gauges = step_metrics(carry)
            metrics = {"loss": 0.0, **gauges}
            return TrainCarry(new_params, carry.opt), metrics
    """, """
        from repro_torch.obs.metrics import step_metrics
        from repro_torch.strategy import TrainCarry

        def step(carry, batch, new_params):
            gauges = step_metrics(buffer=carry.buffer)
            metrics = {"loss": 0.0, **gauges}
            return TrainCarry(new_params, carry.opt, carry.buffer, carry.pipe), metrics
    """, None),
    ("rpl041_rng_in_obs_function", "RPL041", ["RPL041"], """
        import jax

        def obs_gauges(state, key):
            noise = jax.random.uniform(key)
            return {"fill": noise}
    """, """
        import torch

        def obs_gauges(state, gen):
            noise = torch.rand((), generator=gen)
            return {"fill": noise}
    """, "torch.rand"),
    ("rpl041_prngkey_and_non_obs_functions_are_fine", "RPL041", [], """
        import jax

        def obs_gauges(state):
            base = jax.random.PRNGKey(0)
            return {"fill": 0.0}

        def sample(key):
            return jax.random.uniform(key)
    """, """
        import torch
        from repro_torch.rng import fold_in, generator
        def obs_gauges(state):
            base = fold_in(0, 1)
            return {"fill": 0.0}

        def sample(key):
            return torch.rand((), generator=generator(key, "cpu"))
    """, None),
]


@pytest.mark.parametrize("name,code,expected,jax_src,torch_src,needle", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rule_case_matches_reference(name, code, expected, jax_src, torch_src, needle):
    want = run(jlint, jax_src, [code])
    got = run(tlint, torch_src, [code])
    assert [c for c, _ in pairs(want)] == expected, f"the reference's {name} moved"
    assert pairs(got) == pairs(want)
    assert not got.errors and not want.errors
    if needle:
        assert all(needle in f.message for f in got.findings), got.findings


def test_every_reference_case_has_a_torch_fixture():
    src = open(os.path.join(REPO, "tests", "test_lint.py")).read()
    rule_tests = {line.split("(")[0][len("def test_"):] for line in src.splitlines()
                  if line.startswith("def test_rpl0")}
    assert rule_tests == {c[0] for c in RULE_CASES}


# ---------------------------------------------------------------------------
# Suppressions: the same directive, the same counts
# ---------------------------------------------------------------------------

_VIOLATION = {
    jlint: """
import jax


def f(key):
    a = jax.random.normal(key, (4,))
    b = jax.random.normal(key, (4,)){trailer}
    return a + b
""",
    tlint: """
import torch
from repro_torch.rng import generator

def f(key):
    a = torch.randn(4, generator=generator(key, "cpu"))
    b = torch.randn(4, generator=generator(key, "cpu")){trailer}
    return a + b
""",
}
_SECOND = {
    jlint: """
def g(rng):
    x = jax.random.normal(rng, ())
    y = jax.random.normal(rng, ())  # replint: disable=RPL001
    return x + y + jax.random.normal(rng, ())
""",
    tlint: """
def g(rng):
    x = torch.randn((), generator=generator(rng, "cpu"))
    y = torch.randn((), generator=generator(rng, "cpu"))  # replint: disable=RPL001
    return x + y + torch.randn((), generator=generator(rng, "cpu"))
""",
}


def _suppression_source(pkg, case):
    v = _VIOLATION[pkg]
    if case == "line":
        return v.format(trailer="  # replint: disable=RPL001")
    if case == "only_its_line":
        return v.format(trailer="") + textwrap.dedent(_SECOND[pkg])
    return ("# replint: disable=RPL001\n" + v.format(trailer="")
            + v.format(trailer="").replace("def f", "def f2"))


@pytest.mark.parametrize("case,n_findings,n_suppressed",
                         [("line", 0, 1), ("only_its_line", 2, 1), ("file", 0, 2)])
def test_suppressions_match_reference(case, n_findings, n_suppressed):
    want = jlint.lint_source(_suppression_source(jlint, case), "fixture.py", select=["RPL001"])
    got = tlint.lint_source(_suppression_source(tlint, case), "fixture.py", select=["RPL001"])
    assert (len(want.findings), want.suppressed) == (n_findings, n_suppressed)
    assert pairs(got) == pairs(want) and got.suppressed == want.suppressed


def test_parse_suppressions_matches_reference():
    lines = ["# replint: disable=RPL001, RPL020", "x = f(key)  # replint: disable=RPL002",
             "y = 1", "   # replint: disable=rpl041", "z = g()  #replint:disable=RPL010,RPL021"]
    assert tlint.parse_suppressions(lines) == jlint.parse_suppressions(lines)
    assert tlint.parse_suppressions(lines[:3]) == ({"RPL001", "RPL020"}, {2: {"RPL002"}})


# ---------------------------------------------------------------------------
# Output schema / lint_paths / CLI, fed the same inputs
# ---------------------------------------------------------------------------


def _without_text(doc):
    """The report less what differs with the fixture's text (message, column)."""
    return dict(doc, findings=[{k: v for k, v in f.items() if k not in ("message", "col")}
                               for f in doc["findings"]])


def test_json_matches_reference():
    want = jlint.lint_source(_VIOLATION[jlint].format(trailer=""), "fixture.py",
                             select=["RPL001"]).to_json()
    got = tlint.lint_source(_VIOLATION[tlint].format(trailer=""), "fixture.py",
                            select=["RPL001"]).to_json()
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    assert _without_text(got) == _without_text(want)
    assert got["version"] == 1 and got["counts"] == {"RPL001": 1}
    assert set(got["findings"][0]) == {"path", "line", "col", "code", "rule", "message"}


def test_finding_format_matches_reference():
    kw = dict(code="RPL001", message="msg", path="a.py", line=3, col=7, rule="r")
    assert tlint.Finding(**kw).format() == jlint.Finding(**kw).format() == "a.py:3:7: RPL001 msg"
    assert tlint.Finding(**kw).to_json() == jlint.Finding(**kw).to_json()


def test_syntax_error_matches_reference():
    got, want = (pkg.lint_source("def f(:\n", "broken.py") for pkg in (tlint, jlint))
    assert got.findings == [] and got.errors == want.errors and len(got.errors) == 1
    assert (got.files_checked, got.suppressed) == (want.files_checked, want.suppressed)


@pytest.mark.parametrize("pkg", [tlint, jlint], ids=["port", "reference"])
def test_unknown_rule_code_raises(pkg):
    with pytest.raises(ValueError, match="RPL999"):
        pkg.lint_source("x = 1\n", select=["RPL999"])


def test_int_literals_match_reference():
    node = ast.parse("(0, 2) if flag else {3: (1, True)}").body[0].value
    assert tint_literals(node) == jint_literals(node) == {0, 1, 2, 3}


_DIRTY_BOTH = """
class Fifo(Policy):
    def init_aux(self, *args):
        return {"cursor": 0}
"""


def test_cli_exit_codes_match_reference(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text(_DIRTY_BOTH)  # RPL030 reads the class by name in both lints
    for argv, code in (([str(clean)], 0), ([str(tmp_path)], 1),
                       ([str(clean), "--select", "RPL999"], 2), (["--list-rules"], 0),
                       ([str(clean), "--json"], 0)):
        assert tlint_main(argv) == jlint_main(argv) == code, argv
    out = capsys.readouterr().out
    assert "dirty.py" in out and "RPL030" in out
    res = tlint.lint_paths([str(tmp_path)])
    assert res.files_checked == 2 and pairs(res) == pairs(jlint.lint_paths([str(tmp_path)]))


def test_cli_json_and_listing(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert tlint_main([str(clean), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert jlint_main([str(clean), "--json"]) == 0
    assert doc == json.loads(capsys.readouterr().out)
    assert tlint_main(["--list-rules"]) == 0
    listing = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in listing] == CODES


def test_iter_python_files_matches_reference(tmp_path):
    for rel in ("b/z.py", "b/a.py", "a.py", "c/__pycache__/x.py", "c/d/e.py", "n.txt",
                "b/c/y.py"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("x = 1\n")
    roots = [str(tmp_path), str(tmp_path / "a.py"), str(tmp_path / "n.txt")]
    got = list(tlint.iter_python_files(roots))
    assert got == list(jlint.iter_python_files(roots)) and len(got) == 6


def test_rule_catalog_is_torch():
    tlint.lint_source("x = 1\n")  # force registration
    assert sorted(tlint.RULES) == CODES
    for code in CODES:
        rationale = tlint.RULES[code].rationale
        assert rationale and rationale != jlint.RULES[code].rationale
    messages = []  # every string a rule passes to Rule.finding
    for path in glob.glob(os.path.join(REPO, "src", "repro_torch", "analysis", "lint",
                                       "rules_*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "finding":
                messages += [c.value for arg in node.args for c in ast.walk(arg)
                             if isinstance(c, ast.Constant) and isinstance(c.value, str)]
    assert len(messages) > 20
    for word in ("jit", "jnp", "donate_argnums"):
        assert not [r for r in tlint.RULES.values() if word in r.rationale]
        assert not [m for m in messages if word in m]


# ---------------------------------------------------------------------------
# Port-only cases: the torch idiom the reference has no counterpart for
# ---------------------------------------------------------------------------

PORT_CASES = [
    ("rng_two_generators_from_one_key", "RPL001", [8], """
        import torch
        from repro_torch.rng import fold_in, generator

        def issue(pipe, device):
            key = fold_in(pipe.key, 0)
            g_update = generator(key, device)
            g_sample = generator(key, device)
            return g_update, g_sample
    """),
    ("rng_manual_seed_consumes", "RPL001", [6], """
        import torch

        def draw(key):
            a = torch.Generator().manual_seed(key)
            b = torch.Generator().manual_seed(key)
            return a, b
    """),
    ("rng_one_generator_many_samplers", "RPL001", [], """
        import torch
        from repro_torch.rng import fold_in, generator

        def draw(key, rng, n):
            gen = generator(fold_in(key, 1), "cpu")
            a = torch.rand(n, generator=gen) + torch.randn(n, generator=gen)
            b = torch.randint(0, n, (n,), generator=rng) + torch.randperm(n, generator=rng)
            return a, b, generator(fold_in(key, 2), "cpu")
    """),
    ("carry_real_make_cl_step_binding", "RPL010", [9], """
        from repro_torch.strategy.step import make_cl_step


        def fit(loss_fn, opt_update, rcfg, carry, batches):
            step = make_cl_step(loss_fn, opt_update, rcfg, device="cpu")
            for s, batch in enumerate(batches):
                new, m = step(carry, batch, s)
                fill = carry.buffer.counts
            return new, fill
    """),
    ("carry_real_make_cl_step_rebound", "RPL010", [], """
        from repro_torch.strategy.step import make_cl_step


        def fit(loss_fn, opt_update, rcfg, carry, batches):
            step = make_cl_step(loss_fn, opt_update, rcfg, device="cpu")
            for s, batch in enumerate(batches):
                carry, m = step(carry, batch, s)
                fill = carry.buffer.counts
            return carry, fill
    """),
    ("carry_built_step_arity", "RPL010", [11, 13], """
        from repro_torch.launch.steps import build_train_step

        def fit(run, mesh, params, opt, buffer, reps, valid, batch, key):
            built = build_train_step(run, mesh)
            step = built.fn
            out = built.fn(params, opt, buffer, reps, valid, batch, key)
            flat = build_train_step(run, mesh).fn
            p2, o2, m = flat(out[0], out[1], batch, key)
            # the built step hands back the same model object: params is the new model
            seen = (params, reps, valid, batch, buffer)
            p3, o3, m3 = step(p2, o2, batch, key)
            return seen, o2, p3, o3
    """),
    ("carry_split_halves", "RPL010", [9], """
        from repro_torch.strategy import make_pipelined_halves

        def fit(loss_fn, opt_update, rcfg, model, opt, buffer, pipe, batch, key):
            train_half, issue_half = make_pipelined_halves(loss_fn, opt_update, rcfg)
            model, opt2, m = train_half(model, opt, pipe, batch)
            buffer2, pipe2 = issue_half(buffer, pipe, batch, key)
            seen = (model, pipe, batch)
            return seen, buffer, opt2, buffer2, pipe2
    """),
    ("kernel_method_writer_and_views", "RPL010", [8, 10], """
        import torch
        from repro_torch.kernels import ref

        def write(buf, x, q, scales, rows):
            flat, row, copy = buf.view(-1), buf[0], buf[1].clone()
            buf.copy_(x)
            total = flat.sum() + copy.sum()
            ref.encode_scatter_rows_ref(q, scales, x, rows)
            return total + row.sum(), q, scales
    """),
    ("host_reads_in_make_cl_step_closure", "RPL020", [7, 8, 9], """
        import torch

        def make_cl_step(loss_fn, opt_update):
            def step(carry, batch, key):
                loss, aux = loss_fn(carry.params, batch)
                print("loss", loss.item())
                rows = batch["label"].tolist()
                norm = float(torch.linalg.vector_norm(loss))
                return carry, {"loss": loss, "rows": rows, "norm": norm}
            return step
    """),
    ("host_loop_named_step_is_quiet", "RPL020", [], """
        import torch

        class Trainer:
            def step(self, carry, batch, key):
                carry, m = self._step_fn(carry, batch, key)
                print("loss", m["loss"].item(), float(torch.mean(m["loss"])))
                return carry, m

        def step(carry, batch):
            return carry, batch["x"].cpu().numpy()
    """),
    ("host_reads_in_autograd_function_and_checkpoint", "RPL020", [8, 12, 13], """
        import torch
        from torch.utils.checkpoint import checkpoint

        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * x.abs().max().item()

        def block(x):
            if torch.is_grad_enabled():
                torch.cuda.synchronize()
            print("recomputed in the backward")
            return x

        def run(x):
            return checkpoint(block, x, use_reentrant=False)
    """),
    ("truthiness_on_python_values_is_quiet", "RPL021", [11], """
        import torch
        import torch.distributed as dist

        def make_cl_step(loss_fn, group):
            def step(carry, batch, key):
                if dist.get_world_size(group) > 1 and torch.is_tensor(batch["x"]):
                    loss = loss_fn(carry, batch)
                while torch.cuda.is_available() and not torch.is_grad_enabled():
                    break
                assert not torch.isnan(loss).any()
                return carry, {"loss": loss}
            return step
    """),
]


@pytest.mark.parametrize("name,code,lines,src", PORT_CASES, ids=[c[0] for c in PORT_CASES])
def test_port_only_case(name, code, lines, src):
    got = run(tlint, src, [code])
    assert [line for _, line in pairs(got)] == lines, [f.format() for f in got.findings]


@pytest.mark.parametrize("path,lines", [("src/repro_torch/obs/gauges.py", [7, 8, 11]),
                                        ("src/repro_torch/buffer/gauges.py", [11])])
def test_rng_generator_inside_obs(path, lines):
    src = """
        import torch
        from repro_torch import rng

        def fill_gauge(buffer, key):
            child = rng.fold_in(key, 3)
            gen = rng.generator(child, "cpu")
            return buffer.counts.float().uniform_(generator=gen), gen

        def obs_noise(n, gen):
            return torch.randn(n, generator=gen)
    """
    got = run(tlint, src, ["RPL041"], path=path)
    assert [line for _, line in pairs(got)] == lines


@pytest.mark.parametrize("table", ["writers", "obs_reads", "state_sinks"])
def test_the_rules_name_functions_of_the_port(table):
    """Every writer of RPL010 and every obs read and state sink of RPL040 is
    a function (or class) that the port has, at the path the table gives."""
    paths = {"writers": list(WRITERS), "obs_reads": list(OBS_READS),
             "state_sinks": list(STATE_SINKS)}[table]
    for path in paths:
        parts = path.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:cut]))
                break
            except ImportError:
                continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        assert callable(obj), path


def test_a_carry_read_after_the_step_is_half_stale():
    """What RPL010's carry form guards: make_cl_step writes the buffer's rows
    in place and returns new counts, so the carry it was handed holds the new
    rows beside the old counts."""
    from repro_torch.buffer.state import ItemSpec
    from repro_torch.configs.base import RehearsalConfig
    from repro_torch.strategy import init_carry, make_cl_step

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(4, 2))

    def loss_fn(model, batch):
        return (batch["x"] @ model.w).square().mean(), {}

    def sgd(grads, opt, params):
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(0.1 * grads[k])
        return params, opt, {}

    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=2,
                           num_candidates=8, mode="async", label_field="label")
    spec = {"x": ItemSpec((4,), torch.float32), "label": ItemSpec((), torch.int32),
            "task": ItemSpec((), torch.int32)}
    carry = init_carry(Linear(), None, spec, rcfg, label_field="label", seed=1, device="cpu")
    step = make_cl_step(loss_fn, sgd, rcfg, exchange="local", label_field="label",
                        device="cpu")
    gen = torch.Generator().manual_seed(0)
    labels = torch.arange(8, dtype=torch.int32) % 2
    batch = {"x": torch.randn(8, 4, generator=gen), "label": labels, "task": labels}
    # the old carry is read after the step on purpose: that it is half stale
    # is what this test shows
    old = carry
    old_counts = old.buffer.counts.clone()
    new, _ = step(old, batch, 5)
    assert int(new.buffer.counts.sum()) == 8 and int(old_counts.sum()) == 0
    for k in spec:  # the rows: written in place, shared
        assert old.buffer.data[k] is new.buffer.data[k]  # replint: disable=RPL010
    assert int(old.buffer.counts.sum()) == 0  # replint: disable=RPL010
    assert old.pipe.key != new.pipe.key == 5  # replint: disable=RPL010
    src = textwrap.dedent("""
        def fit(carry, batch):
            new, _ = step(carry, batch, 5)
            return carry.buffer
    """)
    bound = "from repro_torch.strategy import make_cl_step\nstep = make_cl_step(f, g, r)\n"
    assert [f.line for f in tlint.lint_source(bound + src, select=["RPL010"]).findings] == [6]


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_port_source_tree_is_clean():
    """The port's shipping gate: its package, the smoke and its tests lint
    clean under the port's rules (suppressions allowed, each with its why)."""
    paths = [os.path.join(REPO, "src", "repro_torch"), os.path.join(REPO, "chip_smoke.py")]
    paths += sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    res = tlint.lint_paths(paths)
    assert res.errors == []
    assert pairs(res) == [], "\n".join(f.format() for f in res.findings)
    assert res.files_checked > 100
