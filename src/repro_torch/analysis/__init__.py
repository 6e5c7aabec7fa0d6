"""libra-check static layer for the port: a PyTorch-aware AST lint pass.

``python -m repro_torch.analysis.lint src/repro_torch`` runs every
registered rule over the tree and exits non-zero on violations. It is the
reference's lint (``repro.analysis``) with its JAX rules replaced by
:mod:`repro_torch.analysis.rules_torch`:

* ``host-sync``         — device→host syncs reachable from the engine step
  loop (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, ``int``/``float``/``bool``/``np.*`` over a
  ``torch.`` expression)
* ``bare-assert``       — ``assert`` on mutation paths (vanishes under -O)
* ``dict-order-tiebreak`` — min/max scheduling decisions whose ties resolve
  by dict/insertion order
* ``raw-clock``         — wall-clock ``time.time()`` / ``print()`` calls in
  the ``core``/``serving`` hot packages (monotonic-clock contract, hot-path
  I/O; emit via :mod:`repro_torch.obs` instead)

The reference's ``traced-branch`` and ``nonstatic-jit-arg`` guard
``jax.jit`` tracing and have no counterpart in the eager port. The rule
table is this package's own (:mod:`repro_torch.analysis.registry`), apart
from the reference's. This package is stdlib-only (no torch import). The
suppression syntax is the reference's (``# libra: ignore[<rule-id>]``).
"""

from .registry import Rule, Violation, all_rules, register

__all__ = ["Rule", "Violation", "all_rules", "register"]
