"""RNG discipline rules, read against the port's integer keys.

RPL001 — a key seeds one stream. The port threads plain integer keys
(``repro_torch.rng``): ``fold_in(key, data)`` derives a child key and
``generator(key, device)`` turns a key into a ``torch.Generator``. Two
generators seeded from one key draw the same numbers, so the discipline the
reference's parity rests on (the sync and pipelined steps drawing the same
sequence, one step apart) is:

  * ``repro_torch.rng.generator`` consumes the key it is given, and so do
    ``.manual_seed(k)`` calls (``torch.Generator(...).manual_seed(k)``,
    ``torch.manual_seed(k)``) — any later read of that name (before
    reassignment) is flagged.
  * a *derived* key (a ``fold_in`` product, or a key received as a function
    parameter) is single-owner: passing it into any call outside torch
    transfers ownership, so a second use is flagged.
  * a *root* key (an int literal) may be handed to several components (a
    model's init, the step-key deriver) — only consumption arms the check
    for roots.
  * ``fold_in`` is the derivation op: it never consumes its key and is the
    only call that may read a consumed key. ``fold_in(key, step)`` in a loop
    is canonical.
  * torch's own calls take generators, not keys: a ``torch.Generator``
    object handed to several samplers is one stream and is not flagged.

Loop bodies are scanned twice, so re-seeding from a loop-invariant key
inside a loop is flagged on the second pass.

RPL002 — issue-key lineage. The pipeline slot's ``key`` field
(``PipelinedRehearsalCarry(reps, valid, key)``) must be the step's *fresh
incoming* key: the issue half draws from ``generator(fold_in(pipe.key,
rank))``, then the new slot stores this step's untouched ``key`` for the
*next* issue. Storing the consumed issue key (a ``fold_in`` product) or
freezing ``pipe.key`` forward makes the fused, split and mesh steps draw
apart. Wholesale relayouts — ``PipelinedRehearsalCarry(f(p.reps),
g(p.valid), p.key)`` with all three fields off the same pipe — are
pass-throughs and exempt.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.lint import FileContext, Finding, Rule, register_rule

# bare `k` is excluded: it is as often an integer (top-k, num-buckets) as a
# key; keys received as params are recognized by the conventional names below,
# and locally-derived keys get provenance from their assignment anyway.
KEY_PARAM_RE = re.compile(r"^(key\d*|rng|k_\w+|\w+_key|\w+_rng)$")

RNG_MODULE = "repro_torch.rng"
SEED_METHODS = {"manual_seed", "manual_seed_all"}


class _KeyState:
    __slots__ = ("provenance", "consumed", "site")

    def __init__(self, provenance: str, consumed: bool = False, site: int = 0):
        self.provenance = provenance  # "root" | "derived"
        self.consumed = consumed
        self.site = site  # line of the consuming use

    def copy(self) -> "_KeyState":
        return _KeyState(self.provenance, self.consumed, self.site)


def _call_kind(call: ast.Call, ctx: FileContext) -> str:
    """'fold_in' | 'consume' | 'torch' | 'other'."""
    qual = ctx.qual(call.func)
    if qual == f"{RNG_MODULE}.fold_in":
        return "fold_in"
    if qual == f"{RNG_MODULE}.generator" or (
            isinstance(call.func, ast.Attribute) and call.func.attr in SEED_METHODS):
        return "consume"
    if qual.startswith("torch."):
        return "torch"
    return "other"


class _FunctionScan:
    """Flow-sensitive single-pass scan of one function body (nested function
    defs are scanned separately; loop bodies get a second pass to catch
    loop-carried reuse, with findings deduped by site)."""

    def __init__(self, rule: "RngKeyReuse", fn: ast.AST, ctx: FileContext):
        self.rule = rule
        self.fn = fn
        self.ctx = ctx
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[int, int, str]] = set()

    def run(self) -> List[Finding]:
        state: Dict[str, _KeyState] = {}
        args = self.fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if KEY_PARAM_RE.match(a.arg):
                state[a.arg] = _KeyState("derived")
        self._stmts(self.fn.body, state)
        return self.findings

    # -- statements ---------------------------------------------------------

    def _stmts(self, body, state: Dict[str, _KeyState]) -> bool:
        """Process a statement list; True if it always terminates the flow
        (return/raise/break/continue), so its state must not merge onward."""
        for stmt in body:
            if self._stmt(stmt, state):
                return True
        return False

    def _stmt(self, stmt: ast.stmt, state: Dict[str, _KeyState]) -> bool:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return False  # separate scope, scanned on its own
        if isinstance(stmt, (ast.Return, ast.Raise)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, state)
            return True
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return True
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is not None:
                self._expr(value, state)
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            self._bind(targets, value, state)
        elif isinstance(stmt, ast.If):
            self._expr(stmt.test, state)
            s_then = {k: v.copy() for k, v in state.items()}
            s_else = {k: v.copy() for k, v in state.items()}
            t_then = self._stmts(stmt.body, s_then)
            t_else = self._stmts(stmt.orelse, s_else)
            if t_then and t_else:
                return True
            state.clear()
            if t_then:  # only the else branch flows onward
                state.update(s_else)
                return False
            if t_else:
                state.update(s_then)
                return False
            for name in set(s_then) | set(s_else):
                a, b = s_then.get(name), s_else.get(name)
                if a is None or b is None:
                    state[name] = (a or b).copy()
                else:
                    merged = a.copy()
                    if b.consumed and not merged.consumed:
                        merged.consumed, merged.site = True, b.site
                    if a.provenance != b.provenance:
                        merged.provenance = "derived"
                    state[name] = merged
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, state)
            # two passes: the second catches seed-at-bottom /
            # seed-again-at-top loop-carried reuse; findings dedupe by site
            self._stmts(stmt.body, state)
            self._stmts(stmt.body, state)
            self._stmts(stmt.orelse, state)
        elif isinstance(stmt, ast.While):
            self._expr(stmt.test, state)
            self._stmts(stmt.body, state)
            self._stmts(stmt.body, state)
            self._stmts(stmt.orelse, state)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr, state)
            self._stmts(stmt.body, state)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body, state)
            for handler in stmt.handlers:
                self._stmts(handler.body, state)
            self._stmts(stmt.orelse, state)
            self._stmts(stmt.finalbody, state)
        elif isinstance(stmt, ast.Expr):
            self._expr(stmt.value, state)
        elif isinstance(stmt, (ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, state)
        return False

    def _bind(self, targets, value, state: Dict[str, _KeyState]) -> None:
        prov: Optional[str] = None
        if isinstance(value, ast.Constant) and isinstance(value.value, int) \
                and not isinstance(value.value, bool):
            prov = "root"
        elif isinstance(value, ast.Call) and _call_kind(value, self.ctx) == "fold_in":
            prov = "derived"
        for target in targets:
            names: List[str] = []
            if isinstance(target, ast.Name):
                names = [target.id]
            elif isinstance(target, (ast.Tuple, ast.List)):
                names = [e.id for e in target.elts if isinstance(e, ast.Name)]
            for name in names:
                if prov is not None and KEY_PARAM_RE.match(name):
                    state[name] = _KeyState(prov)
                else:
                    state.pop(name, None)  # rebound to a non-key value

    # -- expressions --------------------------------------------------------

    def _expr(self, node: ast.expr, state: Dict[str, _KeyState],
              in_fold_in: bool = False) -> None:
        if isinstance(node, (ast.Lambda, ast.GeneratorExp, ast.ListComp,
                             ast.SetComp, ast.DictComp)):
            return  # separate (or lazy) scope
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            st = state.get(node.id)
            if st is not None and st.consumed and not in_fold_in:
                self._flag(node, st)
            return
        if isinstance(node, ast.Call):
            kind = _call_kind(node, self.ctx)
            self._expr(node.func, state)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and isinstance(arg.ctx, ast.Load):
                    st = state.get(arg.id)
                    if st is not None:
                        if st.consumed and kind != "fold_in":
                            self._flag(arg, st)
                        if kind == "consume" or (kind == "other"
                                                 and st.provenance == "derived"):
                            st.consumed, st.site = True, arg.lineno
                else:
                    self._expr(arg, state, in_fold_in=(kind == "fold_in"))
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, state, in_fold_in)

    def _flag(self, node: ast.Name, st: _KeyState) -> None:
        site = (node.lineno, node.col_offset, node.id)
        if site in self._seen:
            return
        self._seen.add(site)
        self.findings.append(self.rule.finding(
            self.ctx, node,
            f"key `{node.id}` reused after it seeded or was handed off on line "
            f"{st.site}; derive a fresh key with rng.fold_in instead"))


class RngKeyReuse(Rule):
    code = "RPL001"
    name = "rng-key-reuse"
    rationale = ("Two generators seeded from one integer key draw the same "
                 "numbers; derived keys are single-owner, fold_in derives.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        for fn in ctx.defs:
            yield from _FunctionScan(self, fn, ctx).run()


def _attr_base(node: ast.expr) -> str:
    """Dotted string of an attribute chain's base: carry.pipe.key -> 'carry.pipe'."""
    parts: List[str] = []
    node = node.value if isinstance(node, ast.Attribute) else node
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _mentions_base(node: ast.expr, base: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and _attr_base(sub) == base:
            return True
    return False


class IssueKeyLineage(Rule):
    code = "RPL002"
    name = "issue-key-lineage"
    rationale = ("The pipeline slot must store the step's fresh key so the "
                 "next issue draws generator(fold_in(fresh, rank)) on every "
                 "step form.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            if ctx.qual(node.func).rsplit(".", 1)[-1] != "PipelinedRehearsalCarry":
                continue
            slot_key = None
            if len(node.args) >= 3:
                slot_key = node.args[2]
            for kw in node.keywords:
                if kw.arg == "key":
                    slot_key = kw.value
            if slot_key is None:
                continue
            if isinstance(slot_key, ast.Attribute) and slot_key.attr == "key":
                base = _attr_base(slot_key)
                others = list(node.args[:2]) + [kw.value for kw in node.keywords
                                                if kw.arg in ("reps", "valid")]
                if base and len(others) >= 2 and \
                        all(_mentions_base(o, base) for o in others[:2]):
                    continue  # wholesale relayout of one pipe — pass-through
                yield self.finding(ctx, slot_key,
                                   f"pipeline slot key reuses `{base}.key`; "
                                   "store this step's fresh incoming key so "
                                   "the lineage advances")
            elif isinstance(slot_key, ast.Name):
                fn = ctx.enclosing.get(node)
                if fn is None or not self._assigned_from_fold_in(
                        fn, slot_key.id, ctx):
                    continue
                yield self.finding(ctx, slot_key,
                                   f"pipeline slot key `{slot_key.id}` is a "
                                   "fold_in product (the consumed issue key); "
                                   "store the incoming step key instead")
            elif isinstance(slot_key, ast.Call) and \
                    _call_kind(slot_key, ctx) == "fold_in":
                yield self.finding(ctx, slot_key,
                                   "pipeline slot key is a fold_in "
                                   "product; store the incoming step key "
                                   "instead")

    @staticmethod
    def _assigned_from_fold_in(fn: ast.AST, name: str,
                               ctx: FileContext) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                    and _call_kind(node.value, ctx) == "fold_in":
                for target in node.targets:
                    if isinstance(target, ast.Name) and target.id == name:
                        return True
        return False


register_rule(RngKeyReuse())
register_rule(IssueKeyLineage())
