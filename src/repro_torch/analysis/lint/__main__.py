"""CLI: ``python -m repro_torch.analysis.lint [paths...]``.

Exit codes: 0 — clean; 1 — findings; 2 — usage / crash (unknown rule code,
unparsable file).

Examples::

    python -m repro_torch.analysis.lint src/repro_torch/
    python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py --json
    python -m repro_torch.analysis.lint src/repro_torch/strategy --select RPL001,RPL020
    python -m repro_torch.analysis.lint --list-rules
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.lint import RULES, _active_rules, lint_paths


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="replint for the port: step-safety & async-invariant static analysis")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files or directories to lint (default: src/repro_torch/)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit a JSON report instead of text")
    parser.add_argument("--select", default=None, metavar="RPL001,RPL020",
                        help="comma-separated rule codes to run (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        _active_rules(None)  # force registration
        for code in sorted(RULES):
            rule = RULES[code]
            print(f"{code}  {rule.name}: {rule.rationale}")
        return 0

    select = args.select.split(",") if args.select else None
    paths = args.paths or ["src/repro_torch/"]
    try:
        result = lint_paths(paths, select)
    except ValueError as e:  # unknown rule code
        print(f"replint: {e}", file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps(result.to_json(), indent=2, sort_keys=True))
    else:
        for finding in result.findings:
            print(finding.format())
        for err in result.errors:
            print(f"ERROR: {err}", file=sys.stderr)
        tail = (f"{len(result.findings)} finding(s) in "
                f"{result.files_checked} file(s)")
        if result.suppressed:
            tail += f", {result.suppressed} suppressed"
        print(tail)
    if result.errors:
        return 2
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
