"""PyTorch-aware lint rules: host syncs on the engine's step loop.

``host-sync`` is the counterpart of the reference's rule of that id
(``repro.analysis.rules_jax``): the same reachability from the ``step`` /
``run`` methods of ``*Engine`` classes, with a device expression being one
that references a ``torch.`` value. Its id is the reference's, so that a
``# libra: ignore[host-sync]`` in a port file means the same to both lints.

The reference's ``traced-branch`` and ``nonstatic-jit-arg`` have no
counterpart: they guard ``jax.jit`` tracing, and the port runs eagerly
(no ``torch.jit``, ``torch.compile`` or graph capture).

The rule is a first-order static approximation; it errs toward silence on
constructs it cannot resolve.
"""

from __future__ import annotations

import ast

from .registry import ModuleInfo, ProjectContext, Violation, dotted_name, register

_TORCH_ROOTS = ("torch",)
# methods that copy a tensor to the host (or read it there), on any receiver
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_CALLS = ("torch.cuda.synchronize",)


def _class_methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}


def _hot_functions(module: ModuleInfo, ctx: ProjectContext) -> list[ast.FunctionDef]:
    """The engine hot path, approximated: methods reachable from the
    ``step``/``run`` methods of ``*Engine`` classes via ``self.x()`` calls
    and same-module bare calls — plus, for modules living in a package that
    defines an Engine, every top-level class's ``__call__`` (engines invoke
    collaborators like the batch-prefill runner through ``__call__``)."""
    hot: dict[int, ast.FunctionDef] = {}
    module_fns = {
        n.name: n for n in module.tree.body if isinstance(n, ast.FunctionDef)
    }

    def expand(fn: ast.FunctionDef, methods: dict[str, ast.FunctionDef]) -> None:
        if id(fn) in hot:
            return
        hot[id(fn)] = fn
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and f.attr in methods
            ):
                expand(methods[f.attr], methods)
            elif isinstance(f, ast.Name) and f.id in module_fns:
                expand(module_fns[f.id], methods)

    pkg_has_engine = False
    for m in ctx.modules_in_dir(module.package_dir):
        for n in m.tree.body:
            if isinstance(n, ast.ClassDef) and "Engine" in n.name:
                pkg_has_engine = True
    for n in module.tree.body:
        if not isinstance(n, ast.ClassDef):
            continue
        methods = _class_methods(n)
        if "Engine" in n.name:
            for entry in ("step", "run"):
                if entry in methods:
                    expand(methods[entry], methods)
        elif pkg_has_engine and "__call__" in methods:
            expand(methods["__call__"], methods)
    return list(hot.values())


def _is_device_expr(node: ast.AST) -> bool:
    """Whether the expression statically references ``torch.`` values."""
    for n in ast.walk(node):
        name = dotted_name(n)
        if name and name.split(".", 1)[0] in _TORCH_ROOTS:
            return True
    return False


@register(
    "host-sync",
    summary="device→host synchronization reachable from the engine step loop",
    rationale=(
        ".item()/.cpu()/int() on a CUDA tensor or torch.cuda.synchronize() "
        "blocks the host until the stream drains and serializes the step "
        "loop with the card — the launch queue runs dry; keep values on the "
        "device or batch the transfer once per step"
    ),
)
def check_host_sync(module: ModuleInfo, ctx: ProjectContext):
    out = []
    for fn in _hot_functions(module, ctx):
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                out.append(Violation(
                    module.path, call.lineno, call.col_offset, "host-sync",
                    f".{f.attr}() in hot function {fn.name!r} forces a "
                    f"device→host sync",
                ))
                continue
            fname = dotted_name(f)
            if fname in _SYNC_CALLS:
                out.append(Violation(
                    module.path, call.lineno, call.col_offset, "host-sync",
                    f"{fname}() in hot function {fn.name!r} waits for the "
                    f"device",
                ))
            elif fname in ("int", "float", "bool") and any(
                _is_device_expr(a) for a in call.args
            ):
                out.append(Violation(
                    module.path, call.lineno, call.col_offset, "host-sync",
                    f"{fname}() over a device expression in hot function "
                    f"{fn.name!r} forces a device→host sync",
                ))
            elif fname and fname.split(".", 1)[0] in ("np", "numpy") and any(
                _is_device_expr(a) for a in call.args
            ):
                out.append(Violation(
                    module.path, call.lineno, call.col_offset, "host-sync",
                    f"{fname}() over a device expression in hot function "
                    f"{fn.name!r} implicitly copies device→host",
                ))
    return out
