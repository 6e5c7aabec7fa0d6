"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<source>.cu`` compiles on its own into a shared library
with a plain C interface (each ``*_launch`` function returns the CUDA error
code of its launch, ``<source>_error_string`` names it):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
        --split-compile=0 -shared -Xcompiler -fPIC \
        -o build/repro_torch_kernels/lib<source>-<hash>.so \
        src/repro_torch/kernels/csrc/<source>.cu

The build runs at first use, from the sources in this package only, into
``build/repro_torch_kernels/`` at the root of the checkout. A library's file
name carries a hash of its source, of every header ``csrc/*.cuh`` (the
sources share them: ``tf32x3.cuh``, ``bf16_mma.cuh``, ``attention_tc.cuh``,
``wgmma.cuh``, ``attention_wgmma.cuh``, ``ragged_split.cuh``)
and of the flags,
so an edited source or header rebuilds and an unchanged one is reused.
All missing libraries compile at once, one ``nvcc`` process per source,
each with ``--split-compile=0`` (a source's device functions optimise in
parallel threads: ``fused_sgmv.cu`` holds its kernels for both float types).

A source may export more than one kernel (``fused_sgmv.cu`` holds
``fused_sgmv`` and ``sgmv``; ``flash_prefill.cu`` holds ``flash_prefill``
and ``flash_prefill_ragged``), and each forward source exports a
``*_bf16_launch`` beside each f32 entry (:func:`entry`), and a kernel may
run on more than one source (bf16 ``fused_sgmv`` on ``fused_sgmv.cu`` or,
in translation units of their own, ``fused_sgmv_wgmma.cu`` and
``fused_sgmv_cluster.cu``; bf16 ``ragged_extend``
on ``ragged_extend.cu`` or ``ragged_extend_wgmma.cu``): libraries are keyed
by source, launch counts by kernel (and, for the kernels of ``PATHS``, by
tile loop: ``path_launches``). ``flash_prefill_bwd.cu`` and
``lora_grad.cu`` are the backward passes of ``flash_prefill`` and
``fused_sgmv``; a launch of each (one call of its wrapper, several CUDA
kernels) counts once. This module holds the
launch counts: every wrapper adds one to its kernel's count where it
launches the kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

# csrc/<source>.cu, one library each
SOURCES = ("fused_sgmv", "fused_sgmv_wgmma", "fused_sgmv_cluster", "ragged_extend",
           "ragged_extend_wgmma", "paged_attention", "flash_prefill", "flash_prefill_bwd",
           "lora_grad")
# the kernels whose launches are counted
KERNELS = ("fused_sgmv", "sgmv", "ragged_extend", "paged_attention",
           "flash_prefill", "flash_prefill_ragged", "flash_prefill_bwd", "lora_grad")
# the serving-only kernels: no backward, so they refuse autograd on the card
SERVING_ONLY = ("sgmv", "ragged_extend", "paged_attention", "flash_prefill_ragged")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset (see ops.reset_launch_counts)
launches: collections.Counter = collections.Counter()
# the tile loops of a kernel that has more than one, picked by shape before
# the launch: bf16 flash_prefill and flash_prefill_ragged run
# attention_wgmma.cuh ("wgmma") or attention_tc.cuh ("mma"; f32 always)
# (flash_prefill.bf16_path); fused_sgmv runs, at M <= 16 rows,
# fused_sgmv_cluster.cu ("cluster", bf16 only) or fused_sgmv.cu's decode
# loop ("skinny"), and past them fused_sgmv_wgmma.cu ("wgmma", bf16 only)
# or fused_sgmv.cu's tiled loop ("mma") (sgmv.bf16_path); bf16 ragged_extend
# runs ragged_extend_wgmma.cu ("wgmma") or ragged_extend.cu ("mma"; f32
# always) (ragged_extend.bf16_path); bf16 paged_attention runs
# paged_attention.cu's split loop ("split") or its chunk loop ("chunk"; f32
# always) (paged_attention.bf16_path)
PATHS = {"flash_prefill": ("wgmma", "mma"), "flash_prefill_ragged": ("wgmma", "mma"),
         "fused_sgmv": ("wgmma", "mma", "skinny", "cluster"),
         "ragged_extend": ("wgmma", "mma"),
         "paged_attention": ("split", "chunk")}
# (kernel, path) -> launches since the last reset, beside ``launches``
path_launches: collections.Counter = collections.Counter()

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


def library_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every library of ``SOURCES`` that is not built yet, all in
    parallel. Returns seconds per compiled source (empty if all were built)."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    while len(seconds) < len(procs):  # each source's own seconds
        for n, (tmp, log, proc) in procs.items():
            if n not in seconds and proc.poll() is not None:
                seconds[n] = time.perf_counter() - t0
        time.sleep(0.05)
    for n, (tmp, log, proc) in procs.items():
        log.seek(0)
        text = log.read()
        log.close()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(n))  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(source: str, signatures: dict[str, str]):
    """The ctypes library of ``csrc/<source>.cu``, built first if needed.
    ``signatures`` maps each int-returning C function the caller uses to
    its arguments: "p" for a pointer (the stream included), "i" for an
    int, "l" for a 64-bit int, "f" for a float."""
    import ctypes

    lib = _libs.get(source)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(source)))
        err = getattr(lib, f"{source}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[source] = lib
    for fname, sig in signatures.items():
        fn = getattr(lib, fname)
        if fn.argtypes is None:
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "l": ctypes.c_int64, "f": ctypes.c_float}
            fn.argtypes = [kinds[a] for a in sig]
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of a CUDA device: the kernels' plans split work to fill them."""
    return _sm_count(torch.device(device).index or 0)


def check_error(name: str, source: str, lib, code: int) -> None:
    if code != 0:
        msg = getattr(lib, f"{source}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg}) at launch")


# the float types the kernels take: every float operand of a launch in one
FLOAT_TYPES = (torch.float32, torch.bfloat16)
CHUNK = 4  # elements a kernel stages per copy: 16 bytes in float32, 8 in bfloat16


def check_cuda(name: str, device, rows: bool = False, **tensors) -> torch.dtype:
    """Every tensor of one float type of ``FLOAT_TYPES`` (returned), on
    ``device``, contiguous and aligned to a chunk of 4 elements (16 bytes
    in float32, 8 in bfloat16); with ``rows`` it may be strided as long as
    its last dimension has unit stride and every other stride is a multiple
    of 4 elements. Mixed float types raise ``ValueError``.

    Under autograd, a tensor that requires grad raises rather than come
    back without a gradient: ``fused_sgmv`` and ``flash_prefill`` reach
    their kernels through an autograd Function, whose forward runs with
    grad off, so only the serving-only kernels (``SERVING_ONLY``), which
    have no backward, ever raise here. The messages are built only on
    failure: this runs on every launch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            f"{name}: a serving-only kernel with no backward pass (of "
            f"{', '.join(SERVING_ONLY)}); call under torch.no_grad() or on CPU tensors")
    dtype = next(iter(tensors.values())).dtype
    if dtype not in FLOAT_TYPES:
        raise ValueError(f"{name}: float32 or bfloat16 inputs, got {dtype}")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype} where the other inputs are "
                             f"{dtype}: every float input of a launch has one type")
        if rows:
            if t.stride(-1) != 1 or any(st % CHUNK for st in t.stride()[:-1]):
                raise ValueError(f"{name}: {arg} needs unit stride on its last "
                                 f"dimension and rows of a multiple of {CHUNK} elements")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % (CHUNK * t.element_size()):
            raise ValueError(f"{name}: {arg} must be aligned to {CHUNK} elements")
    return dtype


def entry(fname: str, dtype: torch.dtype) -> str:
    """The C entry of a kernel for ``dtype``: ``<fname>`` for float32,
    ``<fname without _launch>_bf16_launch`` for bfloat16."""
    return fname if dtype == torch.float32 else fname[:-len("_launch")] + "_bf16_launch"


def refuse_bf16_training(name: str, *tensors) -> None:
    """The backward kernels take float32 only: a bfloat16 input that
    requires grad on the card raises rather than train in another type."""
    if any(t.dtype == torch.bfloat16 and t.device.type == "cuda" for t in tensors):
        raise NotImplementedError(
            f"{name}: bf16 training is not ported yet (the backward kernels "
            "flash_prefill_bwd and lora_grad take float32); train in float32")


# head dims the attention kernels take: rows of 4-element chunks (a
# multiple of 4) up to 256 (csrc/attention_tc.cuh, csrc/paged_attention.cu)
MAX_HEAD_DIM = 256


def check_head_dim(name: str, D: int) -> None:
    if D % 4 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {D} must be a multiple of 4 up to {MAX_HEAD_DIM}")


def as_int32(t, device):
    """An index tensor as contiguous int32 on ``device`` (torch defaults to
    int64; the kernels read int32)."""
    return t.to(device=device, dtype=torch.int32).contiguous()
