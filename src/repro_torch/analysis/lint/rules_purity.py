"""Step purity rules — code that runs once a step on the card must not wait
for it.

RPL020 — host reads and host effects in step-reachable code. ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/``int()``/``bool()`` of a
tensor expression and ``torch.cuda.synchronize()`` copy a value to the host
and wait for every kernel queued before it: inside a step they stall the
card once a step, they are what ``launch.dryrun`` cannot run on fake tensors,
and they rule out capturing the step in a CUDA graph. Under a capturing or
recomputing entry (``torch.compile``, ``torch.cuda.make_graphed_callables``,
TorchScript, FX, export, the ``torch.func`` transforms, activation
checkpointing) host side effects — the clock, ``numpy.random``, prints,
logging, file I/O, environment reads — are flagged too: they run once at
capture (a baked constant, a print that never fires again) or twice under
recomputation, not once a step.

RPL021 — Python truthiness on a tensor. ``if torch.any(mask):`` reads the
tensor back to the host and branches on it: a hidden synchronisation with
the card, and a graph break under capture. Device-side control flow belongs
in ``torch.where`` and masks. The check is heuristic to stay quiet on config
flags: only tests that *call into* a tensor-producing torch function are
flagged, not plain-name tests like ``if pipelined:``, nor torch calls that
return Python values (``torch.distributed.get_world_size()``,
``torch.is_tensor(x)``, ``torch.cuda.is_available()``).

Scope for both rules: the functions a step builder returns, the methods of
``torch.autograd.Function`` subclasses and the functions handed to a
capturing entry, plus the module-local call-graph closure (see
``common.step_roots`` / ``common.reachable``). A host loop that merely
shares a name (a trainer's ``step`` method) is out of scope.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from repro_torch.analysis.lint import FileContext, Finding, Rule, register_rule
from repro_torch.analysis.lint.common import last_part, own_nodes

# qual prefixes whose call is a host side effect (RPL020, under capture)
HOST_CALL_PREFIXES = (
    "time.", "numpy.random.", "random.", "os.environ", "os.getenv",
    "os.putenv", "os.remove", "os.unlink", "os.system", "os.popen",
    "os.makedirs", "os.mkdir", "subprocess.", "logging.", "shutil.",
    "sys.stdout", "sys.stderr", "builtins.print", "builtins.open",
    "builtins.input", "socket.", "requests.", "urllib.",
)
HOST_CALL_EXACT = {"print", "open", "input", "breakpoint"}
# attribute-method calls on names that look like loggers
LOGGER_METHODS = {"debug", "info", "warning", "error", "exception", "critical"}
LOGGER_NAMES = {"log", "logger", "logging"}

# methods that copy a tensor to the host (RPL020, anywhere in a step)
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_READ_QUALS = {"torch.cuda.synchronize"}
HOST_CASTS = {"float", "int", "bool"}

# torch calls that return Python values, not tensors (RPL021, RPL020 casts)
PYTHON_VALUED_PREFIXES = (
    "torch.distributed.", "torch.cuda.", "torch.backends.", "torch.jit.",
    "torch.compiler.", "torch._dynamo.", "torch.fx.", "torch.utils.",
    "torch.version.", "torch.testing.", "torch.library.", "torch.overrides.",
    "torch.profiler.", "torch.multiprocessing.", "torch.autograd.profiler.",
)
PYTHON_VALUED_LAST = {"numel", "finfo", "iinfo", "device", "dtype", "Size", "typename",
                      "result_type", "promote_types", "can_cast", "Generator",
                      "no_grad", "enable_grad", "inference_mode", "set_grad_enabled"}


def _tensor_call(qual: str) -> bool:
    """True for a torch call that produces a tensor."""
    if not qual.startswith("torch.") or qual.startswith(PYTHON_VALUED_PREFIXES):
        return False
    last = last_part(qual)
    return not (last.startswith(("is_", "get_", "are_")) or last in PYTHON_VALUED_LAST)


def _tensor_expr(node: ast.expr, ctx: FileContext) -> Optional[str]:
    """The first tensor-producing torch call under ``node``, or None."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fq = ctx.qual(sub.func)
            if _tensor_call(fq):
                return fq
    return None


def _host_read(call: ast.Call, ctx: FileContext) -> Optional[str]:
    fq = ctx.qual(call.func)
    if fq in HOST_READ_QUALS:
        return f"{fq}()"
    if isinstance(call.func, ast.Attribute) and call.func.attr in HOST_READ_METHODS:
        return f".{call.func.attr}()"
    if fq in HOST_CASTS and call.args and _tensor_expr(call.args[0], ctx):
        return f"{fq}(<tensor>)"
    return None


def _host_effect(call: ast.Call, ctx: FileContext) -> Optional[str]:
    fq = ctx.qual(call.func)
    if fq in HOST_CALL_EXACT:
        return fq
    if fq:
        probe = fq + "."
        for prefix in HOST_CALL_PREFIXES:
            if probe.startswith(prefix) or fq.startswith(prefix):
                return fq
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in LOGGER_METHODS and \
            isinstance(call.func.value, ast.Name) and \
            call.func.value.id in LOGGER_NAMES:
        return f"{call.func.value.id}.{call.func.attr}"
    return None


def _functions(nodes) -> Iterator[ast.AST]:
    for fn in nodes:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield fn


class HostReadsInStep(Rule):
    code = "RPL020"
    name = "host-read-in-step"
    rationale = ("A host read inside a step stalls the card once a step and "
                 "rules out CUDA graphs; a host effect under capture runs at "
                 "capture or recompute, not once a step.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        for fn in _functions(ctx.step_reachable):
            captured = fn in ctx.capture_reachable
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                read = _host_read(node, ctx)
                if read:
                    yield self.finding(
                        ctx, node,
                        f"host read `{read}` inside step-reachable `{fn.name}` "
                        "waits for the card and copies to the host once a step; "
                        "keep the value on the device")
                    continue
                effect = _host_effect(node, ctx) if captured else None
                if effect:
                    yield self.finding(
                        ctx, node,
                        f"host side effect `{effect}(...)` inside `{fn.name}`, "
                        "which torch captures or recomputes, runs at capture "
                        "(or again on recomputation), not once a step")


class TensorTruthiness(Rule):
    code = "RPL021"
    name = "tensor-truthiness"
    rationale = ("Python `if`/`while`/`assert` on a tensor reads it back to "
                 "the host, a hidden sync; use torch.where / masks.")

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterator[Finding]:
        seen: Set[Tuple[int, int]] = set()
        for fn in _functions(ctx.step_reachable):
            for node in own_nodes(fn):
                test: Optional[ast.expr] = None
                kind = ""
                if isinstance(node, (ast.If, ast.While)):
                    test, kind = node.test, type(node).__name__.lower()
                elif isinstance(node, ast.Assert):
                    test, kind = node.test, "assert"
                elif isinstance(node, ast.IfExp):
                    test, kind = node.test, "conditional expression"
                if test is None:
                    continue
                fq = _tensor_expr(test, ctx)
                if fq is None:
                    continue
                site = (test.lineno, test.col_offset)
                if site in seen:
                    continue
                seen.add(site)
                yield self.finding(
                    ctx, test,
                    f"Python {kind} on a tensor (`{fq}(...)`) inside "
                    f"step-reachable `{fn.name}` synchronises with the card; "
                    "use torch.where or a mask")


register_rule(HostReadsInStep())
register_rule(TensorTruthiness())
