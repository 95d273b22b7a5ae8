"""Shared AST machinery for the port's replint rules.

Everything here is module-local static analysis: import-alias resolution,
dotted-name ("qualname") expansion, and a conservative step-reachability
pass (the functions a step builder returns, ``torch.autograd.Function``
bodies and functions handed to torch's capturing or recomputing entry
points, closed over the module's direct-call graph).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

# The port's step builders (``repro_torch.strategy.step`` and
# ``repro_torch.launch.steps``): the functions each returns run once a step
# on the card, so a host read inside them stalls every step.
STEP_BUILDERS = {"make_cl_step", "make_stale_step", "make_pipelined_halves",
                 "build_train_step", "build_prefill_step", "build_decode_step"}

# Entry points that capture their function (torch.compile, CUDA graphs,
# TorchScript, FX, export, the torch.func transforms) or run it again in the
# backward (activation checkpointing): Python side effects inside run once
# at capture, or twice under recomputation, not once a step.
CAPTURE_ENTRY_QUALS = {
    "torch.compile", "torch.cuda.make_graphed_callables", "torch.jit.trace",
    "torch.jit.trace_module", "torch.jit.script", "torch.fx.symbolic_trace",
    "torch.export.export", "torch.utils.checkpoint.checkpoint",
    "torch.utils.checkpoint.checkpoint_sequential", "torch.vmap",
}
CAPTURE_ENTRY_PREFIXES = ("torch.func.",)

# Methods of a ``torch.autograd.Function`` subclass that autograd calls.
AUTOGRAD_METHODS = {"forward", "backward", "setup_context", "jvp", "vjp"}


def import_map(tree: ast.AST, nodes: Optional[List[ast.AST]] = None) -> Dict[str, str]:
    """Map local names to fully qualified module/attribute paths.

    ``import torch.nn.functional as F`` -> {"F": "torch.nn.functional"};
    ``from repro_torch import rng`` -> {"rng": "repro_torch.rng"};
    ``from repro_torch.rng import fold_in`` -> {"fold_in": "repro_torch.rng.fold_in"}.
    Walks the whole tree (or ``nodes``, its walk) so function-local imports
    resolve too.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree) if nodes is None else nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                out[local] = alias.name if alias.asname else local
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                out[local] = f"{node.module}.{alias.name}"
    return out


def qualname(node: ast.AST, imports: Dict[str, str]) -> str:
    """Dotted name of a Name/Attribute chain with the root alias expanded.

    Returns "" for anything that is not a plain dotted chain (calls,
    subscripts, ...).
    """
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(imports.get(node.id, node.id))
    return ".".join(reversed(parts))


def call_qual(call: ast.Call, imports: Dict[str, str]) -> str:
    return qualname(call.func, imports)


def last_part(qual: str) -> str:
    return qual.rsplit(".", 1)[-1] if qual else ""


def is_capture_entry(qual: str) -> bool:
    return qual in CAPTURE_ENTRY_QUALS or qual.startswith(CAPTURE_ENTRY_PREFIXES)


def decorator_captures(dec: ast.expr, imports: Dict[str, str]) -> bool:
    """True if a decorator captures the function it decorates.

    Handles ``@torch.compile``, ``@torch.jit.script``, the call form
    ``@torch.compile(mode=...)`` and ``@functools.partial(torch.compile, ...)``.
    """
    if is_capture_entry(qualname(dec, imports)):
        return True
    if isinstance(dec, ast.Call):
        fq = call_qual(dec, imports)
        if is_capture_entry(fq):
            return True
        if last_part(fq) == "partial":
            return any(is_capture_entry(qualname(a, imports)) for a in dec.args[:1])
    return False


class ModuleIndex:
    """One walk of a module: every node, and the function defs by name."""

    def __init__(self, tree: ast.Module):
        self.nodes: List[ast.AST] = list(ast.walk(tree))
        self.defs: List[ast.AST] = [n for n in self.nodes if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.defs_by_name: Dict[str, List[ast.AST]] = {}
        for fn in self.defs:
            self.defs_by_name.setdefault(fn.name, []).append(fn)


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """The nodes of a function body outside its nested defs, lambdas and
    classes (each a separate reachability decision)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def capture_roots(index: ModuleIndex, imports: Dict[str, str]) -> Set[ast.AST]:
    """Function defs captured or recomputed by torch: decorated with, or
    passed by name to, a capturing entry (``torch.compile(step)``,
    ``checkpoint(block, x)``)."""
    roots: Set[ast.AST] = set()
    for fn in index.defs:
        if any(decorator_captures(d, imports) for d in fn.decorator_list):
            roots.add(fn)
    for node in index.nodes:
        if not isinstance(node, ast.Call):
            continue
        fq = call_qual(node, imports)
        args = list(node.args)
        if last_part(fq) == "partial" and args:
            # functools.partial(torch.compile, fn, ...)
            if not is_capture_entry(qualname(args[0], imports)):
                continue
            args = args[1:]
        elif not is_capture_entry(fq):
            continue
        for arg in args:
            if isinstance(arg, ast.Name):
                roots.update(index.defs_by_name.get(arg.id, ()))
            elif isinstance(arg, ast.Lambda):
                roots.add(arg)
    return roots


def step_roots(index: ModuleIndex, imports: Dict[str, str],
               captured: Set[ast.AST]) -> Set[ast.AST]:
    """Function defs that run once a step on the card: the functions a step
    builder (``STEP_BUILDERS``) returns, the methods of a
    ``torch.autograd.Function`` subclass, and the capture roots
    (``captured``). A host loop that merely shares a name (a trainer's
    ``step``) is none of these."""
    roots = set(captured)
    for node in index.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name in STEP_BUILDERS:
            nested: Dict[str, List[ast.AST]] = {}
            returned: Set[str] = set()
            for sub in own_nodes(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nested.setdefault(sub.name, []).append(sub)
                elif isinstance(sub, ast.Return) and sub.value is not None:
                    returned |= {n.id for n in ast.walk(sub.value)
                                 if isinstance(n, ast.Name)}
            for name in returned:
                roots.update(nested.get(name, ()))
        elif isinstance(node, ast.ClassDef) and any(
                qualname(b, imports).endswith("autograd.Function") for b in node.bases):
            roots.update(m for m in node.body
                         if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                         and m.name in AUTOGRAD_METHODS)
    return roots


def reachable(index: ModuleIndex, roots: Set[ast.AST]) -> Set[ast.AST]:
    """Close the root set over the module-local direct-call graph.

    A call by bare name from a reachable function marks every same-module
    function of that name reachable (conservative, flow-insensitive).
    """
    def callees(fn: ast.AST) -> Iterator[ast.AST]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                for target in index.defs_by_name.get(node.func.id, ()):
                    if target is not fn:
                        yield target

    out = set(roots)
    frontier = list(roots)
    while frontier:
        fn = frontier.pop()
        for target in callees(fn):
            if target not in out:
                out.add(target)
                frontier.append(target)
    return out


def enclosing_functions(tree: ast.Module) -> Dict[ast.AST, Optional[ast.AST]]:
    """Map every node to its innermost enclosing function def (or None)."""
    out: Dict[ast.AST, Optional[ast.AST]] = {}

    def visit(node: ast.AST, fn: Optional[ast.AST]) -> None:
        out[node] = fn
        child_fn = node if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) else fn
        for child in ast.iter_child_nodes(node):
            visit(child, child_fn)

    visit(tree, None)
    return out


def int_literals(node: ast.AST) -> Set[int]:
    """All int constants anywhere under ``node``: the may-set of an
    expression such as ``(0,) if flag else ()``, here {0}."""
    out: Set[int] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, int) \
                and not isinstance(sub.value, bool):
            out.add(sub.value)
    return out
