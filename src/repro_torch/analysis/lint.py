"""libra-check lint driver + CLI.

Usage::

    python -m repro_torch.analysis.lint src/            # lint a tree
    python -m repro_torch.analysis.lint --list-rules    # show registered rules
    python -m repro_torch.analysis.lint src/ --report lint-report.txt

Exit status is 0 iff no unsuppressed violation was found — CI runs this as
a blocking job. A violation is suppressed by a ``# libra: ignore[<rule-id>]``
comment (with a justification after it) on the flagged line or the line
directly above; ``ignore[*]`` suppresses every rule on that line. Unknown
rule ids in suppressions are themselves reported, so stale suppressions
cannot rot silently.
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path
from typing import Iterable, Optional

from . import rules_hygiene, rules_torch  # noqa: F401 - rule registration
from .registry import ModuleInfo, ProjectContext, Violation, all_rules

_SUPPRESS_RE = re.compile(r"#\s*libra:\s*ignore\[([a-z*][a-z0-9*,\- ]*)\]")


def _suppressions_for(module: ModuleInfo, line: int) -> set[str]:
    """Rule ids suppressed at ``line`` (1-indexed): same line or line above."""
    out: set[str] = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(module.lines):
            m = _SUPPRESS_RE.search(module.lines[ln - 1])
            if m:
                out.update(p.strip() for p in m.group(1).split(","))
    return out


def parse_tree(paths: Iterable[str]) -> tuple[ProjectContext, list[Violation]]:
    """Parse every .py under ``paths``; syntax errors become violations."""
    modules: list[ModuleInfo] = []
    errors: list[Violation] = []
    files: list[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        else:
            files.append(path)
    for f in files:
        src = f.read_text()
        try:
            tree = ast.parse(src, filename=str(f))
        except SyntaxError as e:
            errors.append(Violation(
                str(f), e.lineno or 0, e.offset or 0, "syntax-error", str(e.msg)
            ))
            continue
        modules.append(ModuleInfo(str(f), tree, tuple(src.splitlines())))
    return ProjectContext(modules), errors


def run_lint(paths: Iterable[str]) -> list[Violation]:
    """Run every registered rule; returns unsuppressed violations, sorted."""
    ctx, violations = parse_tree(paths)
    known = {r.rule_id for r in all_rules()}
    for module in ctx.modules:
        raw: list[Violation] = []
        for rule in all_rules():
            raw.extend(rule.check(module, ctx))
        for v in raw:
            sup = _suppressions_for(module, v.line)
            if v.rule_id in sup or "*" in sup:
                continue
            violations.append(v)
        # stale/unknown suppression ids are findings too
        for i, text in enumerate(module.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            for rid in (p.strip() for p in m.group(1).split(",")):
                if rid != "*" and rid not in known:
                    violations.append(Violation(
                        module.path, i, text.index("#"), "unknown-suppression",
                        f"suppression names unknown rule {rid!r}",
                    ))
    return sorted(violations)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="libra-check: PyTorch-aware static lint for the repro_torch tree",
    )
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to lint (default: src)")
    ap.add_argument("--report", metavar="FILE",
                    help="also write the findings to FILE")
    ap.add_argument("--list-rules", action="store_true",
                    help="print registered rules and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.rule_id:22s} {rule.summary}")
            print(f"{'':22s}   {rule.rationale}")
        return 0

    violations = run_lint(args.paths or ["src"])
    lines = [v.render() for v in violations]
    body = "\n".join(lines)
    if args.report:
        Path(args.report).write_text(
            body + ("\n" if body else "")
            or "libra-check: no violations\n"
        )
    if violations:
        print(body)
        print(f"\nlibra-check: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    print("libra-check: no violations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
