"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``<name>_launch`` returns the CUDA error code of the
launch, ``<name>_error_string`` names it):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch_kernels/lib<name>-<hash>.so \
        src/repro_torch/kernels/csrc/<name>.cu

The build runs at first use, from the sources in this package only, into
``build/repro_torch_kernels/`` at the root of the checkout. A library's file
name carries a hash of its source and flags, so an edited source rebuilds
and an unchanged one is reused. All missing libraries compile at once, one
``nvcc`` process per source.

This module also holds the launch counts: every wrapper adds one to its
kernel's count where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNELS = ("fused_sgmv", "ragged_extend", "paged_attention")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset (see ops.reset_launch_counts)
launches: collections.Counter = collections.Counter()

_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every library of ``KERNELS`` that is not built yet, all in
    parallel. Returns seconds per compiled kernel (empty if all were built)."""
    todo = [n for n in KERNELS if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(n))  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, argtypes: tuple[str, ...], extra: dict | None = None):
    """The ctypes library of kernel ``name``, built first if needed.
    ``argtypes`` spells the launch function's C signature: "p" for a
    pointer (the stream included), "i" for an int, "f" for a float.
    ``extra`` maps a suffix to the signature of another int-returning
    function ``<name>_<suffix>`` (a shape query)."""
    lib = _libs.get(name)
    if lib is None:
        import ctypes

        build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
        for fname, sig in {"launch": argtypes, **(extra or {})}.items():
            fn = getattr(lib, f"{name}_{fname}")
            fn.argtypes = [kinds[a] for a in sig]
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check_error(name: str, lib, code: int) -> None:
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg}) at launch")


def check_cuda_f32(name: str, device, **tensors) -> None:
    """Every tensor float32, contiguous, 16-byte aligned, on ``device``.
    The messages are built only on failure: this runs on every launch."""
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def as_int32(t, device):
    """An index tensor as contiguous int32 on ``device`` (torch defaults to
    int64; the kernels read int32)."""
    return t.to(device=device, dtype=torch.int32).contiguous()
