"""Obs neutrality rules — telemetry observes, it never participates.

The obs contract (DESIGN.md §11) is that fingerprints are bit-identical obs
on/off: gauges ride the step's metrics as *reads* of training state and
nothing flows back. Two ways code could break that contract:

RPL040 — obs feedback: a value produced by one of the port's obs reads
(``OBS_READS``: ``obs.metrics.step_metrics``, ``buffer_obs``, ``tiered_obs``,
``Policy.obs_aux``) is passed into one of its state constructors or
state-writing calls (``STATE_SINKS``: ``TrainCarry``,
``PipelinedRehearsalCarry``, ``BufferState``, ``TieredState``,
``issue_sample``, ``local_update``, ``buffer_update_sample``,
``tiered_update_sample`` and the in-place kernel writers of RPL010).
Metrics dicts may be merged into the *metrics* output, never into the carry.

RPL041 — RNG in obs: any RNG consumption inside an obs module (``obs/``
path) or an obs-named function: ``repro_torch.rng.generator``,
``torch.Generator``, ``manual_seed``, torch's samplers (``torch.rand``,
``randn``, ``randint``, ``randperm``, ``multinomial``, ``bernoulli``,
``normal``, ...) and the in-place samplers (``uniform_``, ``normal_``,
``random_``, ``exponential_``, ...). Telemetry drawing from a generator
shifts every later draw and breaks obs-on/off parity. ``rng.fold_in``
alone derives a key and consumes nothing.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Set

from repro_torch.analysis.lint import FileContext, Finding, Rule, register_rule
from repro_torch.analysis.lint.common import last_part
from repro_torch.analysis.lint.rules_inplace import SELF, WRITERS

# The port's obs reads and state sinks, by full path (tests resolve each);
# the rules match a call by the last part.
OBS_READS = (
    "repro_torch.obs.metrics.step_metrics",
    "repro_torch.buffer.api.buffer_obs",
    "repro_torch.buffer.tiered.tiered_obs",
    "repro_torch.buffer.policies.Policy.obs_aux",
)
STATE_SINKS = (
    "repro_torch.strategy.step.TrainCarry",
    "repro_torch.strategy.step.PipelinedRehearsalCarry",
    "repro_torch.buffer.state.BufferState",
    "repro_torch.buffer.tiered.TieredState",
    "repro_torch.core.distributed.issue_sample",
    "repro_torch.buffer.state.local_update",
    "repro_torch.buffer.api.buffer_update_sample",
    "repro_torch.buffer.tiered.tiered_update_sample",
) + tuple(p for p, pos in WRITERS.items() if SELF not in pos)
OBS_READ_FUNCS = {last_part(p) for p in OBS_READS}
STATE_SINK_FUNCS = {last_part(p) for p in STATE_SINKS}

RNG_QUALS = {"repro_torch.rng.generator", "torch.Generator"}
TORCH_SAMPLERS = {"rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
                  "randperm", "multinomial", "bernoulli", "normal", "poisson"}
RNG_METHODS = {"manual_seed", "manual_seed_all", "uniform_", "normal_", "random_",
               "exponential_", "bernoulli_", "geometric_", "log_normal_", "cauchy_"}


class ObsFeedback(Rule):
    code = "RPL040"
    name = "obs-feedback"
    rationale = ("Gauges fed back into the carry break the bit-identical "
                 "obs-on/off fingerprints.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        if not any(isinstance(n, ast.Call) and last_part(ctx.qual(n.func)) in OBS_READ_FUNCS
                   for n in ctx.nodes):
            return
        for fn in ctx.defs:
            obs_names = self._obs_valued_names(fn, ctx)
            if not obs_names:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                last = last_part(ctx.qual(node.func))
                if last not in STATE_SINK_FUNCS:
                    continue
                # direct: state_sink(..., obs_read(...), ...)
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    hit = self._mentions_obs(arg, obs_names, ctx)
                    if hit:
                        yield self.finding(
                            ctx, arg,
                            f"obs-derived value `{hit}` flows into state "
                            f"constructor `{last}`; telemetry must not "
                            "feed back into fingerprinted state")

    @staticmethod
    def _obs_valued_names(fn: ast.AST, ctx: FileContext) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and last_part(ctx.qual(node.value.func)) in OBS_READ_FUNCS:
                out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        return out

    @staticmethod
    def _mentions_obs(arg: ast.expr, obs_names: Set[str], ctx: FileContext) -> str:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Name) and sub.id in obs_names:
                return sub.id
            if isinstance(sub, ast.Call):
                fq = ctx.qual(sub.func)
                if last_part(fq) in OBS_READ_FUNCS:
                    return fq
        return ""


def _draws(call: ast.Call, ctx: FileContext) -> str:
    """The RNG-consuming call's name, or ""."""
    fq = ctx.qual(call.func)
    if fq in RNG_QUALS or (fq.startswith("torch.") and fq.count(".") == 1
                           and last_part(fq) in TORCH_SAMPLERS):
        return fq
    if isinstance(call.func, ast.Attribute) and call.func.attr in RNG_METHODS:
        return f".{call.func.attr}"
    return ""


class RngInObs(Rule):
    code = "RPL041"
    name = "rng-in-obs"
    rationale = ("Telemetry consuming RNG shifts every later draw and breaks "
                 "obs-on/off parity.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        parts = ctx.path.replace(os.sep, "/").split("/")
        obs_module = "obs" in parts[:-1]
        for fn in ctx.defs:
            obs_fn = obs_module or "obs" in fn.name.split("_") or \
                fn.name in OBS_READ_FUNCS
            if not obs_fn:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    what = _draws(node, ctx)
                    if what:
                        yield self.finding(
                            ctx, node,
                            f"`{what}(...)` inside obs code `{fn.name}`; "
                            "telemetry must not consume RNG")


register_rule(ObsFeedback())
register_rule(RngInObs())
