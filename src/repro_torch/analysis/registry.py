"""Rule registry + shared project model for the libra-check lint pass.

A rule is a function ``check(module, ctx) -> list[Violation]`` registered
under a stable rule id. The driver (:mod:`repro_torch.analysis.lint`) parses the
whole tree first into a :class:`ProjectContext` so rules can reason across
modules (e.g. host-sync reachability from the engine step loop spans
``engine.py`` and ``prefill.py``), then runs every rule over every module.

Adding a rule::

    from .registry import Violation, register

    @register(
        "my-rule",
        summary="one-line description shown by --list-rules",
        rationale="why this pattern is a hazard in this codebase",
    )
    def check_my_rule(module, ctx):
        return [Violation("my-rule", module.path, node.lineno,
                          node.col_offset, "message")
                for node in ...]

Rules must be pure (no filesystem access beyond ``module``/``ctx``) and
stdlib-only — the CI lint job runs without the accelerator toolchain.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Callable, Iterable, Optional


@dataclasses.dataclass(frozen=True, order=True)
class Violation:
    """One lint finding, addressable to a source position."""

    path: str
    line: int
    col: int
    rule_id: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}"


@dataclasses.dataclass(frozen=True)
class ModuleInfo:
    """A parsed source module: AST + raw lines for suppression matching."""

    path: str
    tree: ast.Module
    lines: tuple[str, ...]

    @property
    def package_dir(self) -> str:
        return str(Path(self.path).parent)


@dataclasses.dataclass
class ProjectContext:
    """Every parsed module of the lint run, for cross-module rules."""

    modules: list[ModuleInfo]

    def modules_in_dir(self, package_dir: str) -> list[ModuleInfo]:
        return [m for m in self.modules if m.package_dir == package_dir]


CheckFn = Callable[[ModuleInfo, ProjectContext], Iterable[Violation]]


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    summary: str
    rationale: str
    check: CheckFn


_RULES: dict[str, Rule] = {}


def register(rule_id: str, *, summary: str, rationale: str):
    """Decorator: add a check function to the global rule table."""

    def deco(fn: CheckFn) -> CheckFn:
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        _RULES[rule_id] = Rule(rule_id, summary, rationale, fn)
        return fn

    return deco


def all_rules() -> list[Rule]:
    """Registered rules, stable order. Importing this module alone returns
    an empty table — the driver imports the rule modules for their
    registration side effects."""
    return [_RULES[k] for k in sorted(_RULES)]


def get_rule(rule_id: str) -> Optional[Rule]:
    return _RULES.get(rule_id)


# --------------------------------------------------------------- AST helpers
def dotted_name(node: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` attribute/name chains; None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_calls(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def const_str_elems(node: ast.AST) -> list[str]:
    """String constants inside a tuple/list/single-constant AST node."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [
            e.value
            for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        ]
    return []
