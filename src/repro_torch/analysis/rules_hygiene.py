"""Hygiene rules: asserts that vanish under -O, dict-order-dependent ties,
wall-clock/print usage on serving hot paths.

These are generic-Python hazards, but both have bitten (or nearly bitten)
this codebase specifically: the pool's structural checks were ``assert``
statements — gone under ``python -O``, exactly when a production serving
deployment would run — and every eviction/prefetch decision is a
``min``/``max`` over scorer floats whose ties (e.g. freshly-registered
LoRAs with identical scores) resolve by dict insertion order, making victim
choice depend on registration order rather than anything intentional.
"""

from __future__ import annotations

import ast
from pathlib import PurePath

from .registry import ModuleInfo, ProjectContext, Violation, dotted_name, register


def _enclosing_functions(tree: ast.Module) -> dict[int, str]:
    """Map id(node) -> name of the innermost enclosing function."""
    owner: dict[int, str] = {}

    def visit(node: ast.AST, fname: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
            else:
                owner[id(child)] = fname
                visit(child, fname)

    visit(tree, "<module>")
    return owner


def _is_check_context(fname: str) -> bool:
    """Functions whose whole job is validation may assert: they run only in
    debug/test sweeps, so -O stripping them is acceptable by design."""
    low = fname.lower()
    return (
        low.startswith("check") or low.startswith("_check")
        or "invariant" in low or low.startswith("test")
    )


@register(
    "bare-assert",
    summary="bare assert on a runtime path (stripped under python -O)",
    rationale=(
        "assert compiles to nothing under -O, so a corruption guard on a "
        "mutation path silently disappears in optimized deployments; raise "
        "PoolInvariantError/ValueError instead (check_*/test_* functions "
        "are exempt — they exist only for debug sweeps)"
    ),
)
def check_bare_assert(module: ModuleInfo, ctx: ProjectContext):
    owner = _enclosing_functions(module.tree)
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Assert):
            continue
        fname = owner.get(id(node), "<module>")
        if _is_check_context(fname):
            continue
        out.append(Violation(
            module.path, node.lineno, node.col_offset, "bare-assert",
            f"assert in {fname!r} vanishes under python -O; raise a typed "
            f"error instead",
        ))
    return out


@register(
    "dict-order-tiebreak",
    summary="min/max selection whose ties resolve by dict/insertion order",
    rationale=(
        "min()/max() with a scalar key returns the *first* minimal element, "
        "so equal scores (cold nodes, fresh LoRAs) make eviction/prefetch "
        "choices depend on insertion order — nondeterministic across runs "
        "and impossible to reproduce; break ties explicitly with a tuple "
        "key (score, node_id)"
    ),
)
def check_dict_order_tiebreak(module: ModuleInfo, ctx: ProjectContext):
    out = []
    for call in ast.walk(module.tree):
        if not isinstance(call, ast.Call):
            continue
        if not isinstance(call.func, ast.Name) or call.func.id not in ("min", "max"):
            continue
        key = next((k for k in call.keywords if k.arg == "key"), None)
        if key is None or not isinstance(key.value, ast.Lambda):
            continue
        body = key.value.body
        if isinstance(body, ast.Tuple):
            continue  # explicit tuple key = deliberate tiebreak
        out.append(Violation(
            module.path, call.lineno, call.col_offset, "dict-order-tiebreak",
            f"{call.func.id}() with a scalar key resolves ties by iteration "
            f"order; use a tuple key with an explicit tiebreak",
        ))
    return out


def _in_hot_package(path: str) -> bool:
    """True for modules under the serving hot path (src/repro/{core,serving})."""
    return bool({"core", "serving"} & set(PurePath(path).parts))


@register(
    "raw-clock",
    summary="time.time() / print() on a core/serving hot path",
    rationale=(
        "the engine and cache pool run inside the serving step loop: "
        "time.time() is wall-clock (jumps under NTP slew, breaks the "
        "monotonic engine-clock contract every TTFT/queue metric and the "
        "libra-trace timeline assume — use time.monotonic()/perf_counter()), "
        "and print() is synchronous unbuffered I/O per call on the hot path "
        "— emit through the Tracer (repro_torch.obs) or a logger instead"
    ),
)
def check_raw_clock(module: ModuleInfo, ctx: ProjectContext):
    if not _in_hot_package(module.path):
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name == "time.time":
            out.append(Violation(
                module.path, node.lineno, node.col_offset, "raw-clock",
                "wall-clock time.time() on a hot path; use the monotonic "
                "engine clock (time.monotonic()/perf_counter())",
            ))
        elif name == "print":
            out.append(Violation(
                module.path, node.lineno, node.col_offset, "raw-clock",
                "print() on a hot path; emit through the Tracer "
                "(repro_torch.obs) or a logger",
            ))
    return out
