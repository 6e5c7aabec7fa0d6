"""The port stands alone: it imports neither JAX nor the reference package,
its control plane is the reference's own code, and it never falls back to
the CPU without being asked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
REF = REPO / "src" / "repro"

# files copied verbatim from the reference, with "repro." -> "repro_torch."
VERBATIM = sorted(
    [p.relative_to(REF) for d in ("configs", "obs", "core")
     for p in (REF / d).glob("*.py")]
    + [Path("serving") / f for f in ("request.py", "scheduler.py", "metrics.py")]
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.JoinedStr) and arg.values:
                head = arg.values[0]
                if isinstance(head, ast.Constant):
                    roots.add(str(head.value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_and_serving_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.kernels.ops, repro_torch.bridge; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(REPO / "src"),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("rel", VERBATIM, ids=str)
def test_control_plane_copy_is_verbatim(rel):
    want = (REF / rel).read_text().replace("repro.", "repro_torch.")
    assert (PORT / rel).read_text() == want


def test_request_journal_is_the_reference_class():
    ref = (REF / "distributed" / "checkpoint.py").read_text()
    i = ref.index("class RequestJournal")
    port = (PORT / "distributed" / "checkpoint.py").read_text()
    assert ref[i:].rstrip() in port


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch import configs
    from repro_torch.serving import EngineConfig, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(configs.reduced(configs.get("qwen3-0.6b")), EngineConfig())


def _build_model():
    from repro_torch import configs
    from repro_torch.models import build_model

    return build_model(configs.reduced(configs.get("qwen3-0.6b")))


def _lm():
    from repro_torch import configs
    from repro_torch.models.transformer import LM

    return LM(configs.reduced(configs.get("qwen3-0.6b")))


def _kv_pool():
    from repro_torch.kvcache import KVPoolSpec, PagedKVPool

    return PagedKVPool(KVPoolSpec(num_layers=1, block_size=2, kv_heads=1,
                                  head_dim=4), 2, 2)


def _tensor_tree():
    import numpy as np

    from repro_torch import bridge

    return bridge.tensor_tree({"w": np.zeros(3, np.float32)})


@pytest.mark.parametrize("make", [_build_model, _lm, _kv_pool, _tensor_tree],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_entry_point_without_device_raises_when_cuda_is_absent(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers choose the plain version only for CPU tensors; anything
    else goes to the kernel path (which raises here, with no card)."""
    from repro_torch.kernels import fused_sgmv

    x = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        fused_sgmv(x, torch.zeros((8, 4), device="meta"),
                   torch.zeros((1, 8, 2), device="meta"),
                   torch.zeros((1, 2, 4), device="meta"),
                   torch.zeros((1,), dtype=torch.int32))
