"""Aux-field rideability rules — cross-module structural checks, read
against the port's ``Policy`` (``buffer/policies.py``) and ``Strategy``
(``strategy/base.py``) classes.

Aux state (policy per-slot metadata, strategy record fields) must ride every
transport path or it silently goes stale on exactly one of them. Two
regressions of the reference motivate these rules: a policy's aux cloned,
not resharded, after an elastic resize, and a restore that dropped the
buffer and pipe halves of the carry.

RPL030 — a ``Policy`` subclass that defines non-trivial ``init_aux`` (it owns
per-slot aux state) must override ``reshard_aux``; the base class returns
``()``, which drops the aux on ``runtime.elastic``'s reshard.

RPL031 — a checkpoint spec (a dict literal with a ``"params"`` key handed to
a ``.save(...)`` call) in a module that imports rehearsal machinery must also
carry the buffer and pipeline slot (``buffer``/``pipe``/``reps`` keys,
counting later ``spec.update(...)``/``spec[...] = `` additions in the same
function); params-only checkpoints restart rehearsal from an empty buffer.

RPL032 — a ``Strategy`` subclass that declares extra ``record_fields`` must
override ``on_store`` to populate them; otherwise stored records carry the
placeholder zeros of ``placeholder_fields`` and the loss reads garbage.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from repro_torch.analysis.lint import FileContext, Finding, Rule, register_rule
from repro_torch.analysis.lint.common import qualname

REHEARSAL_IMPORT_MARKERS = ("repro_torch.buffer", "repro_torch.strategy", "repro_torch.core",
                            "init_carry", "TrainCarry")
CKPT_STATE_KEYS = {"buffer", "pipe", "reps"}


def _base_names(cls: ast.ClassDef, ctx: FileContext) -> Set[str]:
    out: Set[str] = set()
    for base in cls.bases:
        fq = qualname(base, ctx.imports)
        if fq:
            out.add(fq.rsplit(".", 1)[-1])
    return out


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name == name:
            return node
    return None


def _trivial_body(fn: ast.FunctionDef) -> bool:
    """True for `pass`, docstring-only, `return ()/{}/None/[]` bodies."""
    stmts = [s for s in fn.body
             if not (isinstance(s, ast.Expr)
                     and isinstance(s.value, ast.Constant)
                     and isinstance(s.value.value, str))]
    if not stmts:
        return True
    if len(stmts) == 1:
        s = stmts[0]
        if isinstance(s, ast.Pass):
            return True
        if isinstance(s, ast.Return):
            v = s.value
            if v is None:
                return True
            if isinstance(v, ast.Constant) and v.value is None:
                return True
            if isinstance(v, (ast.Tuple, ast.List)) and not v.elts:
                return True
            if isinstance(v, ast.Dict) and not v.keys:
                return True
    return False


class PolicyAuxReshard(Rule):
    code = "RPL030"
    name = "policy-aux-reshard"
    rationale = ("A policy's per-slot aux that reshard_aux does not rebuild "
                 "is lost on runtime.elastic's reshard.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            bases = _base_names(node, ctx)
            if not (bases & {"Policy"} or any(b.endswith("Policy")
                                              for b in bases)):
                continue
            init_aux = _method(node, "init_aux")
            if init_aux is None or _trivial_body(init_aux):
                continue
            if _method(node, "reshard_aux") is None:
                yield self.finding(
                    ctx, node,
                    f"policy `{node.name}` owns aux state (non-trivial "
                    "init_aux) but does not override reshard_aux; its aux "
                    "is lost on elastic resharding")


class CheckpointSpecComplete(Rule):
    code = "RPL031"
    name = "checkpoint-spec-complete"
    rationale = ("A checkpoint of the model alone restarts rehearsal from an "
                 "empty buffer and an invalid pipeline slot.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        if not self._rehearsal_module(ctx):
            return
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "save"):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                spec = self._resolve_dict(arg, ctx.enclosing.get(node))
                if spec is None:
                    continue
                keys = self._dict_keys(spec)
                if "params" not in keys:
                    continue
                fn = ctx.enclosing.get(node)
                if fn is not None and isinstance(arg, ast.Name):
                    keys |= self._augmented_keys(fn, arg.id)
                if not (keys & CKPT_STATE_KEYS):
                    yield self.finding(
                        ctx, node,
                        "checkpoint spec saves `params` but no rehearsal "
                        "state (`buffer`/`pipe`/`reps`); restore will restart "
                        "from an empty buffer")

    @staticmethod
    def _rehearsal_module(ctx: FileContext) -> bool:
        return any(any(marker in v for marker in REHEARSAL_IMPORT_MARKERS)
                   for v in ctx.imports.values())

    @staticmethod
    def _resolve_dict(arg: ast.expr, fn: Optional[ast.AST]) -> Optional[ast.Dict]:
        if isinstance(arg, ast.Dict):
            return arg
        if isinstance(arg, ast.Name) and fn is not None:
            found: Optional[ast.Dict] = None
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Dict):
                    for target in node.targets:
                        if isinstance(target, ast.Name) and \
                                target.id == arg.id:
                            found = node.value
            return found
        return None

    @staticmethod
    def _dict_keys(spec: ast.Dict) -> Set[str]:
        return {k.value for k in spec.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}

    @staticmethod
    def _augmented_keys(fn: ast.AST, name: str) -> Set[str]:
        """Keys added via `name.update(k=...)` / `name["k"] = ...` later on."""
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "update" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == name:
                out |= {kw.arg for kw in node.keywords if kw.arg}
                for sub in node.args:
                    if isinstance(sub, ast.Dict):
                        out |= CheckpointSpecComplete._dict_keys(sub)
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id == name and \
                            isinstance(target.slice, ast.Constant) and \
                            isinstance(target.slice.value, str):
                        out.add(target.slice.value)
        return out


class StrategyFieldsStored(Rule):
    code = "RPL032"
    name = "strategy-fields-stored"
    rationale = ("Record fields a strategy declares but on_store never fills "
                 "are stored as placeholder_fields' zeros.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            bases = _base_names(node, ctx)
            if not (bases & {"Strategy"} or any(b.endswith("Strategy")
                                                for b in bases)):
                continue
            record_fields = _method(node, "record_fields")
            if record_fields is None or _trivial_body(record_fields):
                continue
            if _method(node, "on_store") is None:
                yield self.finding(
                    ctx, node,
                    f"strategy `{node.name}` declares record_fields but does "
                    "not override on_store; the declared aux fields are "
                    "stored as placeholders")


register_rule(PolicyAuxReshard())
register_rule(CheckpointSpecComplete())
register_rule(StrategyFieldsStored())
