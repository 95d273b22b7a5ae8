"""``replint`` for the port: static analysis of the asynchrony invariants
(DESIGN.md §13), read in PyTorch's idiom.

The paper's contribution is *asynchrony done safely*: one-step-stale
representatives whose issue key is the step's fresh key, RNG lineage that
does not drift between backends, aux state that rides every transport path,
telemetry that never feeds back into the state. The port keeps those
invariants (``repro_torch.rng``, ``strategy.step``, ``obs``) and has hazards
of its own: host reads inside a step stall the card and rule out CUDA
graphs; a carry read after a step wrote half of it in place is half stale.
This package machine-checks both: an AST pass with a rule registry
(``RPL0xx`` codes), a CLI (``python -m repro_torch.analysis.lint``), text
and JSON output, and per-file / per-line ``# replint: disable=RPLxxx``
suppressions. It is pure standard library and needs no card.

Rule families (one module each, see the rule docstrings for the full model):

  * RPL001/RPL002 — RNG discipline (``rules_rng``): a key seeds one
    generator; the pipeline slot's lineage key is the step's fresh key.
  * RPL010 — in-place safety (``rules_inplace``): no read of a carry a step
    wrote in place, nor of an alias of a tensor a writer overwrote.
  * RPL020/RPL021 — step purity (``rules_purity``): no host reads inside
    step-reachable code, no host effects under a capturing entry, no Python
    branch on a tensor.
  * RPL030/RPL031/RPL032 — aux-field rideability (``rules_aux``): policy aux
    must survive resharding, checkpoints must carry the full buffer/pipe
    state, strategies declaring record fields must populate them.
  * RPL040/RPL041 — obs neutrality (``rules_obs``): telemetry reads state,
    never feeds it back, and never consumes RNG.

Suppressions: a line consisting only of ``# replint: disable=RPL001,RPL020``
disables those codes for the whole file; the same comment trailing a code line
suppresses just that line. The directive is the JAX package's
(``repro.analysis.lint``), so one comment serves both lints. Policy: every
suppression must sit next to a comment justifying *why* the flagged pattern
is deliberate.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reported violation. ``line`` is 1-based, ``col`` 0-based (ast)."""

    code: str  # RPLxxx
    message: str
    path: str
    line: int
    col: int = 0
    rule: str = ""  # short rule name (registry key context)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "code": self.code, "rule": self.rule, "message": self.message}


class Rule:
    """A registered checker: emits findings for one ``RPLxxx`` code family.

    ``check(tree, ctx)`` yields Findings; ``ctx`` is the per-file
    :class:`FileContext` (source lines, import map, step reachability)."""

    code: str = "RPL000"
    name: str = "rule"
    rationale: str = ""

    def check(self, tree: ast.Module, ctx: "FileContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST, message: str,
                code: Optional[str] = None) -> Finding:
        return Finding(code=code or self.code, message=message, path=ctx.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), rule=self.name)


RULES: Dict[str, Rule] = {}


def register_rule(rule: Rule) -> Rule:
    """Register under ``rule.code`` (last registration wins)."""
    RULES[rule.code] = rule
    return rule


# ---------------------------------------------------------------------------
# Per-file context: imports, source lines, step reachability
# ---------------------------------------------------------------------------


class FileContext:
    def __init__(self, path: str, source: str, tree: ast.Module):
        from repro_torch.analysis.lint.common import (ModuleIndex, capture_roots,
                                                      import_map, reachable, step_roots)

        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        index = ModuleIndex(tree)
        self.nodes = index.nodes  # every node of the module, walked once
        self.defs = index.defs  # its function defs
        self.imports = import_map(tree, index.nodes)
        captured = capture_roots(index, self.imports)
        # the functions under a capturing or recomputing entry and their
        # module-local callees: the host-effect rule's scope
        self.capture_reachable = reachable(index, captured)
        # with the functions that run once a step on the card (step builders'
        # results, autograd.Function bodies): the host-read and truthiness
        # rules' scope
        self.step_reachable = reachable(index, step_roots(index, self.imports, captured))

    def qual(self, node: ast.AST) -> str:
        from repro_torch.analysis.lint.common import qualname

        return qualname(node, self.imports)

    @functools.cached_property
    def enclosing(self) -> Dict[ast.AST, Optional[ast.AST]]:
        """Every node's innermost enclosing function def (or None); built on
        first use, since few files need it."""
        from repro_torch.analysis.lint.common import enclosing_functions

        return enclosing_functions(self.tree)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_DIRECTIVE = re.compile(r"#\s*replint:\s*disable=([A-Za-z0-9_,\s]+)")


def parse_suppressions(lines: Sequence[str]):
    """-> (file_codes: set, line_codes: {lineno: set}). A directive on an
    otherwise-empty line (comment-only) is file-wide; trailing a statement it
    suppresses that line only."""
    file_codes: set = set()
    line_codes: Dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = _DIRECTIVE.search(line)
        if not m:
            continue
        codes = {c.strip().upper() for c in m.group(1).split(",") if c.strip()}
        before = line[: m.start()].strip()
        if before:  # trailing comment on a code line
            line_codes.setdefault(i, set()).update(codes)
        else:  # comment-only line: whole file
            file_codes.update(codes)
    return file_codes, line_codes


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_checked: int
    suppressed: int
    errors: List[str]  # unparsable files

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "version": 1,
            "files_checked": self.files_checked,
            "findings": [f.to_json() for f in self.findings],
            "counts": self.counts,
            "suppressed": self.suppressed,
            "errors": self.errors,
        }


def _active_rules(select: Optional[Iterable[str]] = None) -> List[Rule]:
    import repro_torch.analysis.lint.rules_aux  # noqa: F401  (register on import)
    import repro_torch.analysis.lint.rules_inplace  # noqa: F401
    import repro_torch.analysis.lint.rules_obs  # noqa: F401
    import repro_torch.analysis.lint.rules_purity  # noqa: F401
    import repro_torch.analysis.lint.rules_rng  # noqa: F401

    if select is None:
        return [RULES[c] for c in sorted(RULES)]
    want = {c.strip().upper() for c in select}
    unknown = want - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule codes {sorted(unknown)}; "
                         f"registered: {sorted(RULES)}")
    return [RULES[c] for c in sorted(want)]


def lint_source(source: str, path: str = "<string>",
                select: Optional[Iterable[str]] = None) -> LintResult:
    """Lint one source string. Suppression directives apply as in files."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return LintResult([], 1, 0, [f"{path}: syntax error: {e}"])
    ctx = FileContext(path, source, tree)
    file_sup, line_sup = parse_suppressions(ctx.lines)
    findings: List[Finding] = []
    suppressed = 0
    for rule in _active_rules(select):
        for f in rule.check(tree, ctx):
            if f.code in file_sup or f.code in line_sup.get(f.line, ()):
                suppressed += 1
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return LintResult(findings, 1, suppressed, [])


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def lint_paths(paths: Sequence[str],
               select: Optional[Iterable[str]] = None) -> LintResult:
    """Lint every ``*.py`` under the given files/directories."""
    findings: List[Finding] = []
    errors: List[str] = []
    files = 0
    suppressed = 0
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        res = lint_source(src, path, select)
        findings.extend(res.findings)
        errors.extend(res.errors)
        suppressed += res.suppressed
        files += 1
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return LintResult(findings, files, suppressed, errors)


__all__ = ["Finding", "FileContext", "LintResult", "Rule", "RULES",
           "iter_python_files", "lint_paths", "lint_source",
           "parse_suppressions", "register_rule"]
