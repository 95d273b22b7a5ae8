"""RPL010 — use after an in-place write.

The port's counterpart of the reference's ``rules_donation.py`` (use after
donate): in PyTorch nothing is donated, but the steps and kernels write
their inputs in place, and a name read afterwards sees state that is half
new. Two forms:

(a) The carry form. A step that a port builder made
(``strategy.step.make_cl_step`` / ``make_stale_step``, the halves of
``make_pipelined_halves``, ``launch.steps.build_train_step(...).fn``)
writes the model, the optimizer's moments and the buffer in place and
returns a new carry (a new pipeline slot, new counts, the next optimizer
step). The carry it was handed is then half stale::

    step = make_cl_step(loss_fn, opt_update, rcfg)
    new_carry, m = step(carry, batch, key)
    history.append(carry.buffer)   # the buffer's rows are new, its counts old

A name bound to a builder's call (``name = make_cl_step(...)``, the
counterpart of ``name = jax.jit(f, donate_argnums=...)``; either branch of a
conditional expression counts, the may-write set) is a writing step; after
a bare name is passed at a written position, any read of it before it is
rebound is flagged. ``STEP_POSITIONS`` gives the positions.

(b) The kernel form, the counterpart of ``input_output_aliases``. A name
bound as an alias of a tensor's storage (a plain name, a view, basic
indexing or ``.detach()``; not ``.clone()``) before that storage is passed
at a written position of an in-place writer (``WRITERS``: the rehearsal
kernels' wrappers, their plain versions, and torch's in-place copies and
scatters) observes the writer's values. Read afterwards, it is flagged.
Both a call by the writer's name and a name bound to the writer
(``op = rehearsal_ops.rehearsal_update_sample``) count.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set, Tuple

from repro_torch.analysis.lint import FileContext, Finding, Rule, register_rule
from repro_torch.analysis.lint.common import last_part

SELF = -1  # the written position of a method: its receiver

# Every in-place writer the port has, by full path, with the positions it
# writes. The rule matches a call by the path's last part (a local call in
# the writer's own module has no prefix); tests resolve every path.
WRITERS: Dict[str, Tuple[int, ...]] = {
    "repro_torch.kernels.rehearsal_ops.rehearsal_update_sample": (0,),
    "repro_torch.kernels.rehearsal_ops.rehearsal_update_sample_leaves": (0,),
    "repro_torch.kernels.rehearsal_ops.rehearsal_pipelined_step": (0,),
    "repro_torch.kernels.rehearsal_ops.encode_scatter_rows": (0, 1),
    "repro_torch.kernels.ref.rehearsal_update_sample_ref": (0,),
    "repro_torch.kernels.ref.rehearsal_update_sample_leaves_ref": (0,),
    "repro_torch.kernels.ref.encode_scatter_rows_ref": (0, 1),
    "torch.Tensor.copy_": (SELF,),
    "torch.Tensor.index_copy_": (SELF,),
    "torch.Tensor.index_put_": (SELF,),
    "torch.Tensor.scatter_": (SELF,),
}
_FUNCTION_WRITERS = {last_part(p): pos for p, pos in WRITERS.items() if SELF not in pos}
_METHOD_WRITERS = {last_part(p) for p, pos in WRITERS.items() if SELF in pos}

# The carry positions each builder's step writes in place: the carry of the
# fused and stale steps; the optimizer state of the train half and the
# buffer of the issue half (the model itself is returned as the same object,
# so reading it is reading the new model); the built mesh step's optimizer
# state and, with rehearsal (six or more arguments), its buffer.
STEP_POSITIONS = {
    "make_cl_step": ((0,),),
    "make_stale_step": ((0,),),
    "make_pipelined_halves": ((1,), (0,)),  # (train_half, issue_half)
}
BUILT_STEP = "build_train_step"


def _built_positions(n_args: int) -> Set[int]:
    return {1, 2} if n_args >= 6 else {1}


# Calls and attributes that return a view of their receiver's storage.
VIEW_METHODS = {"view", "view_as", "detach", "unsqueeze", "squeeze", "transpose", "t",
                "permute", "expand", "expand_as", "narrow", "select", "unflatten",
                "as_strided", "diagonal", "unfold", "movedim", "swapaxes"}
VIEW_ATTRS = {"T", "mT", "data"}


def _basic_index(node: ast.expr) -> bool:
    """An index that makes a view: ints, slices, Ellipsis and None."""
    if isinstance(node, ast.Tuple):
        return all(_basic_index(e) for e in node.elts)
    if isinstance(node, ast.Slice):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and (
        node.value is None or node.value is Ellipsis
        or (isinstance(node.value, int) and not isinstance(node.value, bool)))


def _view_base(node: ast.expr) -> Tuple[Optional[str], bool]:
    """(the name whose storage ``node`` views, or None; whether the view
    spans all of it: no indexing on the way)."""
    whole = True
    while True:
        if isinstance(node, ast.Name):
            return node.id, whole
        if isinstance(node, ast.Subscript) and _basic_index(node.slice):
            node, whole = node.value, False
        elif isinstance(node, ast.Attribute) and node.attr in VIEW_ATTRS:
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in VIEW_METHODS:
            node = node.func.value
        else:
            return None, False


def _step_binding(value: ast.expr, ctx: FileContext) -> Tuple[Tuple[int, ...], ...]:
    """The written positions of the step(s) a builder call returns."""
    if isinstance(value, ast.IfExp):  # the may-write set of both branches
        a, b = _step_binding(value.body, ctx), _step_binding(value.orelse, ctx)
        if len(a) < len(b):
            a, b = b, a
        return tuple(tuple(sorted(set(p) | set(b[i] if i < len(b) else ())))
                     for i, p in enumerate(a))
    if isinstance(value, ast.Call):
        return STEP_POSITIONS.get(last_part(ctx.qual(value.func)), ())
    return ()


def _is_built(value: ast.expr, ctx: FileContext) -> bool:
    return isinstance(value, ast.Call) and \
        last_part(ctx.qual(value.func)) == BUILT_STEP


def _writing_steps(ctx: FileContext):
    """(steps: name -> positions, None for a built step's ``fn``, whose
    positions depend on its arity; built: names bound to
    ``build_train_step(...)``; writers: name -> positions, names bound to a
    kernel writer)."""
    steps: Dict[str, Optional[Set[int]]] = {}
    writers: Dict[str, Tuple[int, ...]] = {}
    assigns = [n for n in ctx.nodes if isinstance(n, ast.Assign)]
    built = {t.id for n in assigns if _is_built(n.value, ctx)
             for t in n.targets if isinstance(t, ast.Name)}
    for node in assigns:
        value = node.value
        bound = _step_binding(value, ctx)
        for target in node.targets:
            if isinstance(target, (ast.Tuple, ast.List)):
                for elt, pos in zip(target.elts, bound):
                    if isinstance(elt, ast.Name):
                        steps[elt.id] = set(pos)
            elif not isinstance(target, ast.Name):
                continue
            elif len(bound) == 1:
                steps[target.id] = set(bound[0])
            elif isinstance(value, ast.Attribute) and value.attr == "fn" and (
                    _is_built(value.value, ctx) or (isinstance(value.value, ast.Name)
                                                    and value.value.id in built)):
                steps[target.id] = None
            elif last_part(ctx.qual(value)) in _FUNCTION_WRITERS:
                writers[target.id] = _FUNCTION_WRITERS[last_part(ctx.qual(value))]
    return steps, built, writers


class UseAfterInplace(Rule):
    code = "RPL010"
    name = "use-after-inplace"
    rationale = ("A carry a step wrote in place is half stale, and an alias "
                 "of overwritten storage reads the writer's values.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        steps, built, writers = _writing_steps(ctx)
        for fn in ctx.defs:
            yield from self._scan_function(fn, steps, built, writers, ctx)

    def _scan_function(self, fn: ast.AST, steps, built, writers,
                       ctx: FileContext) -> Iterator[Finding]:
        # dead: name -> why it must not be read
        dead: Dict[str, str] = {}
        # aliases: name -> (the name whose storage it views, whether whole)
        aliases: Dict[str, Tuple[str, bool]] = {}
        seen: Set[Tuple[int, int, str]] = set()

        def rebind(name: str) -> None:
            dead.pop(name, None)
            aliases.pop(name, None)
            for alias in [a for a, (base, _) in aliases.items() if base == name]:
                del aliases[alias]  # still views the old storage, not the name

        def bind(target: ast.expr, value: Optional[ast.expr]) -> None:
            if isinstance(target, (ast.Tuple, ast.List)):
                values = value.elts if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts) else [None] * len(target.elts)
                for t, v in zip(target.elts, values):
                    bind(t, v)
                return
            if not isinstance(target, ast.Name):
                return
            rebind(target.id)
            base, whole = _view_base(value) if value is not None else (None, False)
            if base is not None and base != target.id:
                aliases[target.id] = (base, whole)

        def wrote(args, line: int, writer: str) -> None:
            """The names in ``args`` were written: every alias viewing their
            storage, other than the written names, now reads new values."""
            names = {n for n, _ in map(_view_base, args) if n is not None}
            storage = set(names)
            for name in names:  # a whole alias's base is the same storage
                while name in aliases and aliases[name][1]:
                    name = aliases[name][0]
                    storage.add(name)
            for alias in list(aliases):
                if alias in storage:
                    continue
                base = alias
                while base in aliases:
                    base = aliases[base][0]
                    if base in storage:
                        dead[alias] = (f"aliases `{base}`, which `{writer}` wrote in "
                                       f"place on line {line}; it reads the written "
                                       "values: clone it before the write")
                        break

        def written(node: ast.Call, positions) -> None:
            args = []
            for pos in positions:
                arg = node.func.value if pos == SELF else (
                    node.args[pos] if pos < len(node.args) else None)
                if isinstance(arg, (ast.List, ast.Tuple)):
                    args.extend(arg.elts)
                elif arg is not None:
                    args.append(arg)
            if args:
                wrote(args, node.lineno, last_part(ctx.qual(node.func)) or "writer")

        def donated(call: ast.Call, positions) -> None:
            for pos in positions:
                if pos < len(call.args) and isinstance(call.args[pos], ast.Name):
                    dead[call.args[pos].id] = (
                        f"was passed to a step on line {call.lineno} that writes it in "
                        "place and returns its successor: it is half stale; rebind it "
                        "to the step's result")

        def visit_expr(node: ast.expr) -> Iterator[Finding]:
            if isinstance(node, ast.Lambda):
                return
            if isinstance(node, ast.Call):
                for sub in node.args + [kw.value for kw in node.keywords]:
                    yield from visit_expr(sub)
                yield from visit_expr(node.func)
                # the write happens after the arguments were read
                func = node.func
                if isinstance(func, ast.Name) and func.id in steps:
                    positions = steps[func.id]
                    donated(node, _built_positions(len(node.args)) if positions is None
                            else positions)
                elif isinstance(func, ast.Attribute) and func.attr == "fn" and \
                        isinstance(func.value, ast.Name) and func.value.id in built:
                    donated(node, _built_positions(len(node.args)))
                elif isinstance(func, ast.Attribute) and func.attr in _METHOD_WRITERS:
                    written(node, (SELF,))
                else:
                    name = func.id if isinstance(func, ast.Name) and \
                        func.id in writers else last_part(ctx.qual(func))
                    written(node, writers.get(name) or _FUNCTION_WRITERS.get(name, ()))
                return
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if node.id in dead:
                    site = (node.lineno, node.col_offset, node.id)
                    if site not in seen:
                        seen.add(site)
                        yield self.finding(ctx, node,
                                           f"`{node.id}` {dead[node.id]}")
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    yield from visit_expr(child)

        def visit_stmts(body) -> Iterator[Finding]:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.Assign):
                    yield from visit_expr(stmt.value)
                    for target in stmt.targets:
                        bind(target, stmt.value)
                elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    if stmt.value is not None:
                        yield from visit_expr(stmt.value)
                    bind(stmt.target, None)
                elif isinstance(stmt, ast.For):
                    yield from visit_expr(stmt.iter)
                    bind(stmt.target, None)
                    yield from visit_stmts(stmt.body)
                    yield from visit_stmts(stmt.orelse)
                elif isinstance(stmt, ast.While):
                    yield from visit_expr(stmt.test)
                    yield from visit_stmts(stmt.body)
                    yield from visit_stmts(stmt.orelse)
                elif isinstance(stmt, ast.If):
                    yield from visit_expr(stmt.test)
                    snapshot, snap_aliases = dict(dead), dict(aliases)
                    yield from visit_stmts(stmt.body)
                    after_then, then_aliases = dict(dead), dict(aliases)
                    dead.clear()
                    dead.update(snapshot)
                    aliases.clear()
                    aliases.update(snap_aliases)
                    yield from visit_stmts(stmt.orelse)
                    dead.update(after_then)  # dead if either branch wrote
                    aliases.update(then_aliases)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        yield from visit_expr(item.context_expr)
                    yield from visit_stmts(stmt.body)
                elif isinstance(stmt, ast.Try):
                    yield from visit_stmts(stmt.body)
                    for handler in stmt.handlers:
                        yield from visit_stmts(handler.body)
                    yield from visit_stmts(stmt.orelse)
                    yield from visit_stmts(stmt.finalbody)
                else:
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            yield from visit_expr(child)

        yield from visit_stmts(fn.body)


register_rule(UseAfterInplace())
