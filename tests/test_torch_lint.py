"""The port's lint (``repro_torch.analysis``): its ``host-sync`` rule sees
PyTorch host syncs on the engine's step loop that the reference's rule
cannot, its hygiene rules are the reference's, and the port lints clean."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import all_rules, lint, rules_torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def ids(violations):
    return [v.rule_id for v in violations]


ENGINE = """\
import numpy as np
import torch

class ToyEngine:
    def step(self):
        v = torch.ones(3)
        return self._sample(v)

    def _sample(self, v):
{suppress}        return {expr}

    def report(self, v):
        # not reachable from step/run: cold path, syncs are fine
        return {expr}
"""
SYNC_FORMS = {  # expression -> whether the reference's host-sync sees it
    "v.item()": True,
    "v.tolist()": True,
    "v.cpu()": False,
    "v.numpy()": False,
    "torch.cuda.synchronize()": False,
    "int(torch.argmax(v))": False,
    "float(torch.sum(v))": False,
    "bool(torch.any(v > 0))": False,
    "np.asarray(torch.argmax(v))": False,
}


def engine_module(tmp_path, expr, suppress=""):
    p = tmp_path / "engine.py"
    p.write_text(ENGINE.format(expr=expr, suppress=suppress))
    return str(p)


@pytest.mark.parametrize("expr", sorted(SYNC_FORMS))
def test_torch_sync_fires_on_the_hot_path_only(tmp_path, expr):
    vs = lint.run_lint([engine_module(tmp_path, expr)])
    assert ids(vs) == ["host-sync"]
    assert vs[0].line == 10  # in _sample, reached from step; not in report


@pytest.mark.parametrize("expr", sorted(SYNC_FORMS))
def test_reference_lint_sees_only_item_and_tolist(tmp_path, expr):
    vs = ref_lint.run_lint([engine_module(tmp_path, expr)])
    assert ids(vs) == (["host-sync"] if SYNC_FORMS[expr] else [])


@pytest.mark.parametrize("expr", sorted(SYNC_FORMS))
def test_host_sync_suppression(tmp_path, expr):
    path = engine_module(tmp_path, expr,
                         suppress="        # libra: ignore[host-sync] one batched copy\n")
    assert lint.run_lint([path]) == []


def test_host_values_stay_clean(tmp_path):
    """int/float/np over host values (numpy, shapes, Python numbers) do
    not sync."""
    path = engine_module(tmp_path, "int(np.asarray([1, 2]).sum()) + float(v.shape[0])")
    assert lint.run_lint([path]) == []


# the reference's hygiene snippets (tests/test_lint.py): (directory, source)
HYGIENE = {
    "bare_assert": ("", """\
def mutate(xs):
    assert xs, "empty"
    return xs.pop()

def check_invariants(xs):
    assert xs  # check helpers may assert

def test_mutate():
    assert mutate([1]) == 1
"""),
    "dict_order_tiebreak": ("", """\
def pick(nodes):
    return min(nodes, key=lambda n: n.score)

def pick_stable(nodes):
    return min(nodes, key=lambda n: (n.score, n.node_id))
"""),
    "raw_clock_hot": ("core", """\
import time

def step():
    t = time.time()
    print("step", t)
    return t
"""),
    "raw_clock_hot_clean": ("core", """\
import time

def step():
    return time.monotonic() + time.perf_counter()
"""),
    "raw_clock_cold": ("launch", """\
import time

def main():
    print("report:", time.time())
"""),
    "raw_clock_suppressed": ("serving", """\
import time

def step():
    return time.time()  # libra: ignore[raw-clock]
"""),
    "syntax_error": ("", "def broken(:\n"),
    "suppression_line_and_above": ("", """\
def mutate(xs):
    assert xs  # libra: ignore[bare-assert]
    # libra: ignore[bare-assert]
    assert len(xs) > 1
    return xs.pop()
"""),
    "wildcard": ("", """\
def mutate(xs):
    assert xs  # libra: ignore[*]
    return xs.pop()
"""),
    "unknown_suppression": ("", "x = 1  # libra: ignore[no-such-rule]\n"),
    "no_leak": ("", """\
def mutate(xs):
    # libra: ignore[dict-order-tiebreak]
    assert xs
    return xs.pop()
"""),
}


@pytest.mark.parametrize("name", sorted(HYGIENE))
def test_hygiene_findings_equal_the_reference(tmp_path, name):
    sub, source = HYGIENE[name]
    d = tmp_path / sub
    d.mkdir(exist_ok=True)
    p = d / "mod.py"
    p.write_text(source)
    # the copy names its own package where the reference names ``repro.obs``
    got = [dataclasses.replace(v, message=v.message.replace("repro_torch.", "repro."))
           for v in lint.run_lint([str(p)])]
    want = ref_lint.run_lint([str(p)])
    assert [dataclasses.astuple(v) for v in got] == [dataclasses.astuple(v) for v in want]


def test_rules_are_the_references_but_the_jit_ones():
    from repro.analysis import all_rules as ref_rules

    ref_ids = {r.rule_id for r in ref_rules()}
    assert {r.rule_id for r in all_rules()} == ref_ids - {"traced-branch",
                                                         "nonstatic-jit-arg"}


def test_lint_cli_is_the_references():
    ref = (REPO / "src" / "repro" / "analysis" / "lint.py").read_text()
    want = (ref.replace("repro.", "repro_torch.")
            .replace("rules_hygiene, rules_jax", "rules_hygiene, rules_torch")
            .replace("JAX-aware static lint for the repro tree",
                     "PyTorch-aware static lint for the repro_torch tree"))
    assert (PORT / "analysis" / "lint.py").read_text() == want


def test_port_tree_lints_clean():
    vs = lint.run_lint([str(PORT)])
    assert vs == [], "\n".join(v.render() for v in vs)


def test_engine_sites_are_the_references_three():
    """Unsuppressed, the port's host-sync finds the port's engine's three
    marked transfers, in the functions where the reference's rule finds the
    reference's three. The port's rule reports two findings at two of them
    (``.cpu()`` and ``.numpy()``, ``.cpu()`` and ``int()``), where the
    reference's reports one (``np.asarray()``, ``int()``)."""
    ctx, _ = lint.parse_tree([str(PORT / "serving")])
    found = [v for m in ctx.modules for v in rules_torch.check_host_sync(m, ctx)]
    engine = (PORT / "serving" / "engine.py").read_text().splitlines()
    marked = {i + 2 for i, text in enumerate(engine)
              if text.strip() == "# libra: ignore[host-sync]"}
    assert len(marked) == 3
    assert {v.line for v in found} == marked
    assert all(v.path.endswith("engine.py") for v in found)

    from repro.analysis import rules_jax

    rctx, _ = ref_lint.parse_tree([str(REPO / "src" / "repro" / "serving")])
    ref_found = [v for m in rctx.modules for v in rules_jax.check_host_sync(m, rctx)]
    assert len(ref_found) == 3

    def fns(vs):
        return sorted({v.message.split("hot function ")[1].split()[0] for v in vs})

    assert fns(found) == fns(ref_found) == ["'_decode_once'", "'_prefill_eager'",
                                            "'_run_chunks'"]


def test_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(PORT)],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no violations" in proc.stdout
