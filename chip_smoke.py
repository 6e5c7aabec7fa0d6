"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the script
exits non-zero:

1. device   — the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. build    — nvcc builds every kernel source from ``src/repro_torch/
              kernels/csrc`` (one process per source, in parallel).
2b. link    — the port's own host link (qwen3-0.6b at full width, the
              engine's f32) in a process that has pinned no host memory
              yet, as an engine finds it when it starts:
              ``PagedKVPool.swap_out`` and ``swap_in`` of 1, 8 and 64 of the
              engine's KV blocks and ``AdapterStore.load`` of one adapter at
              ranks 8, 32 and 128, timed with CUDA events (and the host's
              enqueue), every round trip checked bit for bit; GB/s and the
              fixed cost of each (a least-squares fit over the sizes).
3. kernels  — each of the eight kernels against its plain PyTorch version at
              the shapes its path gives it (qwen3-0.6b: 8 slots, 256-token
              buckets and a 2048-token cache for the engine; 8 rows of 2016
              tokens for the fresh prefill, fused_sgmv at both paths'
              shapes and at the engine's 64-token buckets, on the q, k and
              o projections (v has k's shape), ragged_extend at
              the engine's 256-, 64- and 8-token buckets, paged_attention
              at phase 3's lengths and at the engine's decode lengths), a
              repeat launch bitwise equal, timed with CUDA events beside
              its plain version, one PyTorch library call where one
              computes the same function, and its bound
              (``repro_torch.kernels.counting``: ``bound_ms`` of the case's
              least ``work``, bytes / 3.35 TB/s or f32 flops / 165
              TFLOP/s, the larger). The decode kernels
              (fused_sgmv and sgmv at S=1, paged_attention) are timed warm
              and with a cold L2, their inputs rotated over copies that
              exceed twice the 50 MB L2. Then every kernel at the other
              configs' shapes (``arch_cases``): ragged_extend at the
              256-token bucket and paged_attention at the engine's decode
              lengths for llama-7b (G = 1), qwen2-vl-7b (G = 7),
              stablelm-12b (D = 160), gemma-2b (D = 256, MQA) and
              phi3.5-moe (32/8 heads), flash_prefill and
              flash_prefill_ragged at B = 2, S = 2048 for stablelm-12b and
              gemma-2b and flash_prefill at phi3.5-moe's static prefill,
              fused_sgmv on llama-7b's q projection, on deepseek-v2-lite's
              kv_a (2048->576), q (2048->3072) and o and phi3.5-moe's k
              (4096->1024), warm and cold, and fused_sgmv and sgmv at ranks
              1, 12 and 128; and the recurrent and enc-dec configs'
              shapes: fused_sgmv (rank 32, S = 256 and 1, warm and
              cold) on recurrentgemma-2b's q (2560->2560) and k (2560->256)
              (rwkv6-1.6b's r and seamless-m4t's decoder q have shapes
              timed above), and at seamless-m4t's 16/16 heads of 64
              ragged_extend at the 256 bucket and paged_attention at the
              engine's lengths; then phase 7c's own inputs: its prefill's
              ragged_extend (B = 2, S = 512, T = 520), its first and last
              greedy step's paged_attention (T = 520 in pages of 8), both
              warm and cold, flash_prefill at its identities' forward (2 x
              256), fused_sgmv on its decoder q at B = 2 (S = 512 and 1).
              Then the backward kernels (phase 8's shapes):
              flash_prefill_bwd at qwen3-0.6b's B = 8, S = 512 and at each
              ``ARCH_HEADS`` shape (B = 2), from the forward's own out and
              log-sum-exp (out the same bits with and without it), beside
              SDPA's f32 backward; lora_grad at qwen3-0.6b's q/k/v/o and at
              ranks 1, 12, 128, with a row of id -1 and repeated ids;
              flash_prefill_bwd over one 4096-token row (its separate dQ
              pass). Then
              a check that the four serving-only kernels refuse autograd on
              the card and that fused_sgmv and flash_prefill return the
              plain backward's gradients (and refuse a bf16 input that
              requires grad). Then the six forward kernels in bf16
              (``bf16_kernel_cases``): at the qwen3-0.6b shapes above, at
              llama-7b (G = 1), qwen2-vl-7b (G = 7), stablelm-12b (D = 160)
              and gemma-2b (D = 256), ranks 1 and 128, each against its
              plain bf16 version (BF16_TOL of its max) and, element by
              element, within one bf16 rounding of its plain f32 version on
              the same inputs upcast, repeat launches bitwise equal, bounds in bf16 bytes or flops / 989 TFLOP/s, SDPA in
              bf16 as the attention kernels' library call; each flash and
              fused_sgmv case names the tile loop it ran (``path``), and
              every bf16 flash case must run ``wgmma``
              (``csrc/attention_wgmma.cuh``), every bf16 ragged_extend case
              ``wgmma`` (phase 9's extend among them: 8 KV parts at
              qwen3-0.6b), every bf16 paged_attention case ``split`` where
              G·D <= 512 (phase 9's decode among them) and ``chunk`` past
              it, every bf16 fused_sgmv case
              ``wgmma`` (``csrc/fused_sgmv_wgmma.cu``) or, at S = 1,
              the loop the rule gives it (``decode_path``: ``cluster``,
              ``csrc/fused_sgmv_cluster.cu``, for W of 2^22 elements or
              2^21 past 8 rows, else ``skinny``; also at B = 16, llama-7b's
              q and deepseek's kv_a), a cluster call one kernel and no copy
              or memset beside it (``torch.profiler``: ``device_ops``); each
              bf16 fused_sgmv case times cuBLAS's bf16 ``x @ W`` beside it
              (``cublas_xw_ms``, at S = 1 also cold: the base term alone,
              a yardstick, not ``library_ms``). Then ``lse_kernel_cases``:
              paged_attention and ragged_extend with their log-sum-exp
              output (``return_lse``) in every loop (ragged ``mma`` in f32
              and bf16, ``wgmma``; paged ``chunk`` in f32 and bf16,
              ``split``) at phase 3's lengths, phase 9's shapes and phase
              11's time shard (``LSE_SHARD``: rows of local count 0), the
              output within ATTN_TOL (bf16: the rule above) and bitwise
              that of the launch without the flag, lse -inf exactly where
              the plain version's is and within ATTN_TOL·max(1, |lse|)
              elsewhere, timed with and without the flag.
4. engine   — the serving engine on qwen3-0.6b at full width (28 layers,
              random weights from seed 0), 36 requests on 6 adapters with
              shared system prompts and repeated prompts, a 4 GiB KV pool and
              an 8 GiB host tier; launch counts are reset just before and
              read just after. Then ``profile``: a fresh 12-request wave,
              40 of its steps under ``torch.profiler``, gives the device's
              busy share and device time per kernel group.
5. cpu      — the engine's tokens against a teacher-forced CPU run of the
              same weights (the kernels' plain versions).
6. generate — the static-batch path on the same model: ``LM.prefill`` of 8
              prompts of 2016 tokens (adapters 0..6 and the base model)
              into a 2048-token cache, then 32 greedy ``make_decode_step``
              steps; launch counts reset just before and read just after;
              one more prefill and 8 decode steps under ``torch.profiler``;
              forward / prefill / decode held against each other at B=2,
              S=256; the first 8 tokens of two rows against a CPU run.
6b. variants — the static path on the same model with an int8 KV cache and
              with Gemma 2's attention logit softcap (50.0): prefill of 2 x
              256 tokens and 8 greedy steps each, exact launch counts
              (their cached attention runs the plain version, as the
              reference routes it), the tokens teacher-forced on the CPU.
7. archs    — the host's MemTotal, then one line per config at full width
              in f32 (``ARCHS``: gemma-2b at full depth; llama-7b,
              qwen2-vl-7b, qwen3-4b, stablelm-12b, llama-13b and llama-34b
              at 4 layers; deepseek-v2-lite-16b (MLA, 64 experts) at 4 and
              phi3.5-moe (16 experts) at 2), weights drawn on the card from a
              seeded generator and handed to ``ServingEngine(params=...)``:
              12 requests on 4 adapters (64-512-token prompts, half behind
              one 128-token shared prompt, 16 new tokens), exact launch
              counts, TTFT, TPOT and tokens/s, peak device memory; llama-7b's
              and deepseek's steps under ``torch.profiler``; for
              stablelm-12b, gemma-2b, deepseek and phi3.5-moe the static
              path (prefill of 2 x 512 tokens, 8 greedy steps, the forward /
              prefill / decode identities, with no token dropped); two clean
              requests teacher-forced on the CPU with the engine's weights,
              or for the MoE configs three engine steps chosen by kind
              before the run (``REPLAY``) replayed on the CPU from the
              card's inputs and cache.
7b. state   — rwkv6-1.6b and recurrentgemma-2b at full width and depth,
              served with state snapshots: 18 requests in three waves
              (prompts; repeats, continued conversations and fresh prompts;
              repeats whose snapshots went to the host meanwhile) on a
              device pool that holds 4 adapters, the 8 running rows and 3
              spare snapshots, so snapshots go to the host and come back;
              state hit rate, snapshot bytes, swap counts, exact launch
              counts (fused_sgmv only), two requests teacher-forced on the
              CPU (one resumed from a snapshot); the static path and its
              identities; recurrentgemma's ring (prefill of 2 x 2048, its
              window, and 8 decode steps onto ring slots 0-7, against
              windowed forward over 2056 tokens); one prefill-chunk and one
              decode call profiled beside the recurrence alone
              (``wkv_scan`` / ``linear_scan``); rwkv6's engine steps under
              ``torch.profiler``.
7c. encdec  — seamless-m4t-large-v2 at full width (24 + 24 layers): frames
              of 2 x 512 x 1024 from a seeded generator, prefill of 2 x 512
              tokens and 8 greedy steps with exact launch counts, forward /
              prefill / decode identities, the card's tokens teacher-forced
              on the CPU.

8. train   — qwen3-0.6b at full width in f32, weights drawn on the card,
              rank-32 LoRA on 4 slots, B = 8 rows of 512 tokens (four
              adapters and a base row): 10 full-parameter steps with exact
              launches a step (fused_sgmv and lora_grad 4 per layer,
              flash_prefill and flash_prefill_bwd 1), steps/s, tokens/s,
              peak memory; under remat a warm-up step, then 4 steps timed
              one by one (the forward's launches double); 20 LoRA-only steps on one fixed batch (the loss
              falls, the base weights keep their bits, no dW is formed);
              one step's loss and gradients at B = 2, S = 256 against the
              CPU's (the plain versions); ``CheckpointManager.save_async``
              and ``restore`` bitwise; one full step under
              ``torch.profiler``.

9. bf16    — the static path in bf16 at full width and depth
              (``BF16_ARCHS``), weights drawn on the card: qwen3-0.6b
              (prefill of 8 x 2016, one extend of 8 x 32 with a token mask
              leaving rows ragged, 32 decode steps) and llama-7b (2 x 512,
              8 steps), each beside the same path in f32 on the same
              weights (the bf16 run fed the f32 tokens; its prefill logits
              within BF16_F32_TOL of f32's; its greedy choice equal to
              f32's wherever the f32 top-2 gap exceeds twice the largest
              bf16-against-f32 prefill logit difference, at a quarter of
              the positions at least), and
              deepseek-v2-lite-16b at all 27 layers in bf16 alone (2 x 256,
              8 steps); every projection through fused_sgmv on 8 LoRA slots
              with a row of id -1, exact launch counts (every flash_prefill
              launch on the ``wgmma`` loop: ``flash_prefill_paths``; every
              fused_sgmv launch of the prefill and the extend on the
              ``wgmma`` loop and of the decode steps on the loop the rule
              gives each projection, ``cluster`` or ``skinny``:
              ``fused_sgmv_paths``; the f32 run's decode steps on the
              ``skinny`` one: ``fused_sgmv_paths_f32``), prefill s, decode
              ms a step (and in 3 more windows of 8 steps), peak GB, 8 more
              decode steps profiled (the device's busy share), and forward
              / prefill / decode held against each other within
              BF16_IDENT_TOL (deepseek's expert choices pinned to the
              forward's; its free-routing errors reported).

10. link_late — phase 2b's link once more, after every other phase: the
              same path in a process that has pinned and freed many GB of
              host memory and run every model; then ``h100_spec``:
              the simulator's H100 spec as measured in this run (phase
              2b's swap_in, phase 9's llama-7b prefill and decode) beside
              ``sim/h100.py``'s.

11. dist    — the multi-device layer on every card of the machine, one rank
              a card over NCCL (in this process on one card: a 1 x 1
              mesh; through ``repro_torch.distributed.runner`` on more):
              qwen3-0.6b at full width in f32 as in phase 8 (seed-0
              weights, rank-32 LoRA on 4 slots, B = 8 x 512), placed by the
              sharding rules on the ``plan_mesh`` mesh, 3 sharded steps
              against 3 unsharded ``make_train_step`` steps on the same
              weights and batches (loss within TRAIN_LOSS_TOL, grad_norm
              within DIST_GRAD_NORM_TOL, relative), exact launches a step on
              every rank (reset just before, read just after: the kernels
              line's ``launches_by_path["dist"]``), s a step and peak GB a
              rank, ``wire_bytes`` of the rank's gradients with and without
              int8 compression; then ``python -m repro_torch.launch.train
              --arch qwen3-0.6b --full-config --steps 2 --ckpt-every 2
              --compress`` in a subprocess (``torchrun`` on more cards), and
              again with ``--steps 4``, which must resume from step 2.
              Before them, the tensor- and expert-parallel families
              (``FAMILY_RUNS``: deepseek-v2-lite-16b (MLA, MoE) and
              rwkv6-1.6b at 2 layers, recurrentgemma-2b at 3,
              seamless-m4t-large-v2 at 2 + 2; full width, f32, B = 4 x
              128): 2 unsharded steps on the card, then the same 2 steps
              through ``make_sharded_train_step`` on a (1, 2) mesh of two
              ranks on the one card over gloo (NCCL refuses two ranks on
              one device), losses within TRAIN_LOSS_TOL and grad norms
              within FAMILY_GRAD_NORM_TOL (f32's own spread at full width),
              both ranks' losses equal, every rank's local shapes the rules'
              shards, exact launches a step
              on each rank (also in ``launches_by_path["dist"]``); their
              step times go through the host and are no tensor-parallel
              timings. ``tp_kernel_cases`` also holds the kernels at
              deepseek's, rwkv6's, phi3.5-moe's and seamless's local shapes.
              Then the serving runs (``SERVE_RUNS``): the sharded prefill
              and decode steps (``make_sharded_prefill_step``,
              ``make_sharded_decode_step``) on the same (1, 2) gloo mesh:
              qwen3-0.6b at 28 layers (cache by kv heads), gemma-2b at 4
              (one kv head: cache in time, paged_attention with lse and the
              merge over the model axis), deepseek-v2-lite-16b, rwkv6-1.6b,
              recurrentgemma-2b and seamless-m4t-large-v2 at the depths
              above, f32, and qwen3-0.6b and gemma-2b again in bf16: 4
              prompts of 156 tokens on 4 adapters into 320 positions, then 8
              decode steps fed the unsharded run's tokens (the time shard's
              boundary at 160 crossed at the fifth); against the unsharded
              steps on the card: both ranks' logits bitwise equal, f32
              logits within ARCH_TOL·(1 + |logit|), bf16 rows within
              SERVE_BF16_TOL, the greedy tokens equal wherever the top-2 gap
              exceeds twice the row's difference (in f32 at every
              position, in bf16 at MIN_CLEAR_SHARE of them at least); one
              ``make_sharded_decode_step`` step bitwise the decode's; the
              local cache shapes the rules' and their bytes the dry run's
              ``device_bytes``; exact launches on each rank; peak GB a rank
              and launches a decode step by loop.

Every phase's line carries the script's seconds so far (``t_s``). Then the
script's seconds. The line before the last is the ``kernels`` JSON (one
entry a kernel, and bf16 fused_sgmv's ``wgmma`` and ``cluster`` loops,
each its own source, as ``fused_sgmv_wgmma`` and ``fused_sgmv_cluster``
with phase 9's launches); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
# the card's constants, each kernel's least work and its bound
from repro_torch.kernels.counting import L2_BYTES, bound_ms, work  # noqa: E402

# bf16 kernels against their plain bf16 versions: times max|plain| (the
# reference's bf16 tolerance)
BF16_TOL = 2e-2
# ... and each element against the plain f32 version on the same inputs
# upcast, rounded once to bf16: kernel and plain version both sum in f32
# and round the output once, so they differ by one bf16 spacing at most,
# plus the f32 tolerance of the sums and twice the error of an f32 operand
# split into two bf16 or TF32 halves (16 bits kept: P in P·V), times max|f32|
BF16_SPLIT_REL = 2.0 ** -16
SGMV_TOL = 1e-4  # times max|ref|: f32 sums of up to 2048 terms, other order
ATTN_TOL = 1e-5  # absolute: softmax-weighted unit-scale values
ARGMAX_TOL = 1e-3  # a card token may trail the CPU's best logit by this
# the backward kernels: times max|plain grad| (sums over S or B·S terms)
GRAD_TOL = 1e-4
# phase 8: a full-width gradient leaf on the card against the CPU's, times
# max|CPU leaf| (28 layers of f32 sums in other orders, 3xTF32 forwards)
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-4  # relative
# forward / prefill / decode logits of one model against each other: the
# tolerance of tests/test_arch_smoke.py (other kernels, other sum orders)
ARCH_TOL = 2e-4


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


# the plain versions are timed for the record, not as a yardstick: 3 calls
# after 1 warm-up (kernels and library calls keep time_ms's 20 after 3)
PLAIN = dict(iters=3, warmup=1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``. The stream is first held by
    a spin kernel that outlasts the host's enqueue of all ``iters`` calls,
    so the events time the device's work alone; a short kernel timed
    without it would read the host's launch cost. The spin's length comes
    from one synchronised call after the warm-up, which a first call's
    one-time cost (a library's plan built for a new shape, as cuDNN's bf16
    attention builds one) does not reach. The host time is the enqueue
    time per call (Python, checks, launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_guess = time.perf_counter() - h0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # ~2e6 cycles per ms at the H100's clock; hold for 3x the enqueue
    torch.cuda._sleep(int(2e6 * max(20.0, 3e3 * iters * host_guess)))
    t0.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - h0) / iters * 1e3
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_ms


def cold_copies(nbytes: float) -> int:
    """Copies of a call's inputs to rotate through so that each call finds
    its ``nbytes`` in device memory, not in L2: more than twice the L2
    passes between two uses of one copy."""
    return math.ceil(2 * L2_BYTES / nbytes) + 1


def rotating(calls):
    """One function that makes the next of ``calls`` on each use, in turn:
    with ``calls`` on :func:`cold_copies` copies, ``time_ms`` of it times
    each launch with a cold L2, as a decode step finds its weights and its
    KV (28 layers of them pass between two uses)."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def esize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def bf16_spacing(x):
    """The distance between neighbouring bf16 values at each |x| (f32): 2^-7
    of its binade's lower end; 0 where x is 0."""
    _, e = torch.frexp(x)  # |x| in [2^(e-1), 2^e)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def one_rounding_err(got, want_f32, atol: float) -> float:
    """The largest excess of |got − bf16(want_f32)| over one bf16 spacing
    at |want_f32| plus ``atol``, elementwise (<= 0 holds)."""
    w = want_f32.float()
    err = (got.float() - w.to(torch.bfloat16).float()).abs()
    return float((err - bf16_spacing(w) - atol).max())


def check_out(what: str, got, want, want_f32, dtype, f32_tol: float) -> dict:
    """``got`` (a kernel) against ``want`` (its plain version in the same
    dtype): within ``f32_tol`` in f32. In bf16, within BF16_TOL·max|want|,
    and each element within one bf16 rounding of ``want_f32`` (the plain
    f32 version on the same inputs upcast): |got − bf16(want_f32)| at most
    one bf16 spacing + ``f32_tol`` + BF16_SPLIT_REL·max|want_f32|. Returns
    the errors."""
    err = float((got.float() - want.float()).abs().max())
    tol = f32_tol if dtype == torch.float32 else BF16_TOL * float(want.float().abs().max())
    require(got.dtype == dtype, f"{what}: output {got.dtype}, inputs {dtype}")
    require(err <= tol, f"{what}: max err {err} > {tol}")
    out = {"max_abs_err": err}
    if dtype != torch.float32:
        require(want_f32 is not None, f"{what}: no f32 plain version to hold bf16 to")
        out["max_abs_err_f32"] = float((got.float() - want_f32).abs().max())
        atol = f32_tol + BF16_SPLIT_REL * float(want_f32.abs().max())
        excess = one_rounding_err(got, want_f32, atol)
        require(excess <= 0, f"{what}: an element is {excess} past one bf16 rounding "
                             f"of the f32 plain value (+ {atol})")
        out["one_rounding_excess"] = excess
    return out


def up(*ts):
    """The float tensors of ``ts`` in f32 (the others as they are)."""
    return [t.float() if torch.is_tensor(t) and t.is_floating_point() else t for t in ts]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ----------------------------------------------------------------- phase 3
# qwen3-0.6b's LoRA projections (d_in, d_out) that phase 3 times; v has k's
# shape, so it is not timed again
PROJECTIONS = (("q", 1024, 2048), ("k", 1024, 1024), ("o", 2048, 1024))


def sgmv_case(ops, ref, proj, d_in, d_out, S, gen, dev, B=8, N=8, r=32,
              base=True, cold=False, dtype=torch.float32):
    """fused_sgmv (``base``) or sgmv, the delta alone, on one projection,
    in ``dtype`` (f32 draws rounded for bf16). A repeat launch must give
    the same bits. Decode shapes (S = 1), and any shape with ``cold``, are
    also timed with a cold L2 (``cold``: W, A and B rotated over
    :func:`cold_copies` copies), as a decode step finds them."""
    t_case = time.perf_counter()
    x = torch.randn((B, S, d_in), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5).to(dtype)
    a = (torch.randn((N, d_in, r), generator=gen, device=dev) * d_in ** -0.5).to(dtype)
    b = (torch.randn((N, r, d_out), generator=gen, device=dev) * 0.1).to(dtype)
    es = esize(dtype)
    ids = torch.tensor(([-1, 0, 1, 2, 3, 4, 5, 7] * 2)[:B], dtype=torch.int32, device=dev)
    scale = 1.0
    name = "fused_sgmv" if base else "sgmv"

    def kernel(ww, aa=a, bb=b):
        if base:
            return ops.fused_sgmv(x, ww, aa, bb, ids, scale=scale)
        return ops.sgmv(x, aa, bb, ids, scale=scale)

    def plain(ww, aa=a, bb=b, xx=x):
        if base:
            return ref.fused_sgmv_ref(xx, ww, aa, bb, ids, scale)
        return ref.sgmv_ref(xx, aa, bb, ids, scale)

    errs, errs32, excess, first = [], [], [], None
    paths = ops.path_launch_counts()["fused_sgmv"]
    for ww in ((w, torch.zeros_like(w)) if base else (w,)):
        got, want = kernel(ww), plain(ww)
        want32 = plain(*up(ww, a, b, x)) if dtype != torch.float32 else None
        torch.cuda.synchronize()
        e = check_out(f"{name} {proj} S={S} zero_w={ww is not w} {dtype}", got, want,
                      want32, dtype, SGMV_TOL * float(want.float().abs().max()))
        errs.append(e["max_abs_err"])
        errs32.append(e.get("max_abs_err_f32", 0.0))
        excess.append(e.get("one_rounding_excess", -math.inf))
        first = got if first is None else first
    # the loop fused_sgmv's launches took (sgmv.bf16_path): one for both
    took = {p: n - paths[p] for p, n in ops.path_launch_counts()["fused_sgmv"].items()}
    path = None
    if base:
        path = next((p for p, n in took.items() if n == 2), None)
        require(path is not None and sum(took.values()) == 2,
                f"fused_sgmv {proj} S={S} {dtype}: launches by loop {took}")
    require(torch.equal(kernel(w), first), f"{name} {proj} S={S}: a repeat "
                                           "launch differs")
    live = ids >= 0
    if not base:
        require(bool((got[~live] == 0).all()), f"sgmv {proj} S={S}: a row of "
                                               "id -1 is not 0")
    n_live_ids = int(torch.unique(ids[live]).numel())
    lora_bytes = n_live_ids * r * (d_in + d_out)
    bnd, by = bound_ms(*work(name, B=B, S=S, d_in=d_in, d_out=d_out, r=r,
                             ids=ids.tolist(), itemsize=es), dtype)
    ms, host_ms = time_ms(lambda: kernel(w))
    out = dict(
        case=f"{proj} {d_in}->{d_out}, B={B}, S={S}, r={r}"
             + (", bf16" if dtype == torch.bfloat16 else ""),
        shape=[B, S, d_in, d_out], max_abs_err=max(errs), ms=ms, host_ms=host_ms,
        plain_ms=time_ms(lambda: plain(w), **PLAIN)[0],
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    if base:
        out["path"] = path
    if dtype != torch.float32:
        out["max_abs_err_f32"] = max(errs32)
        out["one_rounding_excess"] = max(excess)
        if base:  # a yardstick, not library_ms: cuBLAS's x·W alone, no delta
            out["cublas_xw_ms"] = time_ms(lambda: torch.matmul(x, w))[0]
    if S == 1 or cold:
        n = cold_copies(es * ((d_in * d_out if base else 0) + lora_bytes))
        copies = [(w.clone() if base else w, a.clone(), b.clone()) for _ in range(n)]
        ms_c, host_c = time_ms(rotating([lambda c=c: kernel(*c) for c in copies]))
        out["cold"] = dict(copies=n, ms=ms_c, host_ms=host_c, plain_ms=time_ms(
            rotating([lambda c=c: plain(*c) for c in copies]), **PLAIN)[0])
        if base and dtype != torch.float32:  # the yardstick on the same cold W
            out["cold"]["cublas_xw_ms"] = time_ms(
                rotating([lambda c=c: torch.matmul(x, c[0]) for c in copies]))[0]
        del copies
    out["seconds"] = time.perf_counter() - t_case
    return out


# The engine's prefill buckets (256-token chunks, and the 64- and 8-token
# buckets of short chunks), each with an inactive row, decode riders
# (true_lens 1) at long starts, part-filled rows and a full chunk at a long
# prefix: bucket S -> (true_lens, starts) of its 8 rows
RAGGED_BUCKETS = {
    256: ([0, 1, 37, 256, 256, 37, 1, 256], [0, 2047, 500, 0, 1792, 1011, 64, 300]),
    64: ([0, 1, 37, 64, 64, 37, 1, 64], [0, 2047, 500, 0, 1984, 1011, 1500, 300]),
    8: ([0, 1, 5, 8, 8, 5, 1, 8], [0, 2047, 500, 0, 2040, 1011, 1500, 300]),
}


def ragged_case(ops, ref, gen, dev, S, lens, starts, B=8, T=2048, H=16, Hkv=8,
                D=128, cold=False, dtype=torch.float32):
    """ragged_extend on one bucket, in ``dtype``: the loop it took
    (``path``), checked, zeros past every row's length, a repeat launch
    bitwise equal, timed warm and, with
    ``cold``, with a cold L2 (q and the KV rotated over
    :func:`cold_copies` copies)."""
    t_case = time.perf_counter()
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
    tl = torch.tensor(lens, dtype=torch.int32, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    paths = ops.path_launch_counts()["ragged_extend"]
    got = ops.ragged_extend(q, k, v, st, tl)
    path = next(p for p, n in ops.path_launch_counts()["ragged_extend"].items() if n > paths[p])
    parts = None
    if path == "wgmma":  # the launch's KV parts (csrc/ragged_split.cuh: split_count)
        from repro_torch.kernels import build
        from repro_torch.kernels.ragged_extend import _WGMMA_SIGNATURES
        lib = build.load("ragged_extend_wgmma", _WGMMA_SIGNATURES)
        parts = lib.ragged_extend_wgmma_kv_parts(B, S, T, H, Hkv, D)
    want = ref.ragged_extend_ref(q, k, v, st, tl)
    want32 = ref.ragged_extend_ref(*up(q, k, v), st, tl) if dtype != torch.float32 else None
    torch.cuda.synchronize()
    errs = check_out(f"ragged_extend S={S} D={D} {dtype}", got, want, want32, dtype,
                     ATTN_TOL)
    del want, want32
    for b, n in enumerate(lens):
        require(bool((got[b, n:] == 0).all()),
                f"ragged_extend S={S}: row {b} is not 0 past its {n} tokens")
    require(torch.equal(ops.ragged_extend(q, k, v, st, tl), got),
            f"ragged_extend S={S}: a repeat launch differs")
    # the same function through one library call: GQA attention with the
    # equivalent boolean mask (padded queries see nothing and give NaN there)
    qpos = st[:, None].long() + torch.arange(S, device=dev)[None, :]
    kpos = torch.arange(T, device=dev)
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (torch.arange(S, device=dev)[None, :, None] < tl[:, None, None].long()))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True))[0]
    es = esize(dtype)
    bnd, by = bound_ms(*work("ragged_extend", B=B, S=S, H=H, Hkv=Hkv, D=D, starts=starts,
                             true_lens=lens, itemsize=es), dtype)
    ms, host_ms = time_ms(lambda: ops.ragged_extend(q, k, v, st, tl))
    out = dict(
        case=f"B={B}, S={S}, T={T}, {H}/{Hkv} heads, D={D}, true_lens={lens}"
             + (", bf16" if dtype == torch.bfloat16 else ""),
        path=path, kv_parts=parts, **errs, ms=ms, host_ms=host_ms,
        plain_ms=time_ms(lambda: ref.ragged_extend_ref(q, k, v, st, tl), **PLAIN)[0],
        bound_ms=bnd, bound_by=by, library_ms=lib,
    )
    if cold:
        n = cold_copies(es * (q.numel() + k.numel() + v.numel()))
        copies = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
        ms_c, host_c = time_ms(rotating(
            [lambda c=c: ops.ragged_extend(*c, st, tl) for c in copies]))
        out["cold"] = dict(copies=n, ms=ms_c, host_ms=host_c, plain_ms=time_ms(rotating(
            [lambda c=c: ref.ragged_extend_ref(*c, st, tl) for c in copies]), **PLAIN)[0])
        del copies
    out["seconds"] = time.perf_counter() - t_case
    return out


# paged_attention's lengths: phase 3's first case (an empty row, 1-token
# rows, rows at the table's width and an idle row past it), then the
# engine's decode (the trace's 64-1024-token prompts, the 256-token shared
# prefix, up to 32 generated tokens) in the same 2048-token table
PAGED_LENGTHS = {
    "table": [0, 1, 129, 2048, 2048, 129, 1, 2049],  # 2049: an idle row at len T
    "engine": [0, 64, 97, 300, 545, 790, 1056, 1312],
}


def paged_case(ops, ref, gen, dev, lens, B=8, T=2048, H=16, Hkv=8, D=128,
               ps=128, dtype=torch.float32):
    """paged_attention on full-width qwen3-0.6b heads, in ``dtype``: the
    loop it took (``path``), checked, a repeat launch bitwise equal, timed warm and with a cold L2
    (``cold``: the KV rotated over :func:`cold_copies` copies). The library
    call is SDPA with the equivalent boolean mask (it reads the whole
    table)."""
    t_case = time.perf_counter()
    pages = T // ps
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
    kc = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
    tables = torch.arange(B * pages, dtype=torch.int32, device=dev).view(B, pages)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < ln[:, None].long())[:, None, None, :]
    qt = q[:, :, None, :]

    def kernel(k, v):
        return ops.paged_attention(q, k.view(B * pages, ps, Hkv, D),
                                   v.view(B * pages, ps, Hkv, D), tables, ln)

    def plain(k, v, qq=q):
        return ref.paged_attention_ref(qq, k.view(B * pages, ps, Hkv, D),
                                       v.view(B * pages, ps, Hkv, D), tables, ln)

    def library(kt, vt):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    paths = ops.path_launch_counts()["paged_attention"]
    got = kernel(kc, vc)
    path = next(p for p, n in ops.path_launch_counts()["paged_attention"].items()
                if n > paths[p])
    want = plain(kc, vc)
    want32 = plain(*up(kc, vc, q)) if dtype != torch.float32 else None
    torch.cuda.synchronize()
    errs = check_out(f"paged_attention {lens} D={D} {dtype}", got, want, want32, dtype,
                     ATTN_TOL)
    for b, n in enumerate(lens):
        if n == 0:
            require(bool((got[b] == 0).all()), "paged_attention: a length 0 row is not 0")
    require(torch.equal(kernel(kc, vc), got),
            f"paged_attention {lens}: a repeat launch differs")
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    kv_tokens = sum(min(n, T) for n in lens)
    es = esize(dtype)
    bnd, by = bound_ms(*work("paged_attention", B=B, H=H, Hkv=Hkv, D=D, T=T, page_size=ps,
                             lengths=lens, itemsize=es), dtype)
    ms, host_ms = time_ms(lambda: kernel(kc, vc))
    out = dict(
        case=f"B={B}, T={T}, page={ps}, {H}/{Hkv} heads, D={D}, lengths={lens}"
             + (", bf16" if dtype == torch.bfloat16 else ""),
        path=path, **errs, ms=ms, host_ms=host_ms,
        plain_ms=time_ms(lambda: plain(kc, vc), **PLAIN)[0],
        bound_ms=bnd, bound_by=by, library_ms=time_ms(lambda: library(kt, vt))[0],
    )
    n = cold_copies(2 * es * kv_tokens * Hkv * D)
    copies = [(kc.clone(), vc.clone()) for _ in range(n)]
    ms_c, host_c = time_ms(rotating([lambda c=c: kernel(*c) for c in copies]))
    cold = dict(copies=n, ms=ms_c, host_ms=host_c,
                plain_ms=time_ms(rotating([lambda c=c: plain(*c) for c in copies]),
                                 **PLAIN)[0])
    copies = [tuple(t.transpose(1, 2).contiguous() for t in c) for c in copies]
    cold["library_ms"] = time_ms(rotating([lambda c=c: library(*c) for c in copies]))[0]
    out["cold"] = cold
    out["seconds"] = time.perf_counter() - t_case
    return out


def flash_case(ops, ref, gen, dev, lens=None, B=8, S=2016, H=16, Hkv=8,
               D=128, dtype=torch.float32):
    """flash_prefill, or flash_prefill_ragged with ``lens``, at the fresh
    prefill's shape, in ``dtype``. The library call is SDPA, causal or with
    the equivalent boolean mask (its fully masked queries give NaN there)."""
    t_case = time.perf_counter()
    F = torch.nn.functional
    q = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    if lens is None:
        name, live = "flash_prefill", [S] * B

        def kernel():
            return ops.flash_prefill(q, k, v)

        def plain(q=q, k=k, v=v):
            return ref.flash_prefill_ref(q, k, v)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    else:
        name, live = "flash_prefill_ragged", lens
        tl = torch.tensor(lens, dtype=torch.int32, device=dev)
        pos = torch.arange(S, device=dev)
        mask = ((pos[None, :, None] >= pos[None, None, :])
                & (pos[None, None, :] < tl[:, None, None].long()))[:, None]

        def kernel():
            return ops.flash_prefill_ragged(q, k, v, tl)

        def plain(q=q, k=k, v=v):
            return ref.flash_prefill_ragged_ref(q, k, v, tl)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    paths = ops.path_launch_counts()[name]
    got = kernel()
    path = next(p for p, n in ops.path_launch_counts()[name].items() if n > paths[p])
    want = plain()
    want32 = plain(*up(q, k, v)) if dtype != torch.float32 else None
    torch.cuda.synchronize()
    errs = check_out(f"{name} D={D} {dtype}", got, want, want32, dtype, ATTN_TOL)
    del want, want32
    for b, n in enumerate(live):
        require(bool((got[b, :, n:] == 0).all()),
                f"{name}: row {b} is not 0 past its {n} tokens")
    require(torch.equal(kernel(), got), f"{name}: a repeat launch differs")
    del got
    bnd, by = bound_ms(*work(name, B=B, S=S, H=H, Hkv=Hkv, D=D, true_lens=lens,
                             itemsize=esize(dtype)), dtype)
    ms, host_ms = time_ms(kernel)
    return dict(
        case=f"B={B}, S={S}, {H}/{Hkv} heads, D={D}"
             + (f", true_lens={lens}" if lens is not None else "")
             + (", bf16" if dtype == torch.bfloat16 else ""),
        path=path, **errs, ms=ms, host_ms=host_ms,
        plain_ms=time_ms(plain, **PLAIN)[0],
        bound_ms=bnd, bound_by=by, library_ms=time_ms(library, iters=5)[0],
        seconds=time.perf_counter() - t_case,
    )


def grad_guard(ops, ref, dev):
    """The serving-only kernels refuse autograd on the card (an input that
    requires grad raises instead of coming back without a gradient); the
    two training kernels, ``fused_sgmv`` and ``flash_prefill``, return the
    plain backward's gradients within ``GRAD_TOL`` of their largest
    magnitude. Returns (refused, {training kernel: largest error})."""
    x = torch.randn((2, 3, 8), device=dev, requires_grad=True)
    qh = torch.randn((2, 2, 3, 4), device=dev, requires_grad=True)
    qs = torch.randn((2, 3, 2, 4), device=dev, requires_grad=True)
    kv = torch.randn((2, 8, 1, 4), device=dev)
    kvh = torch.randn((2, 1, 3, 4), device=dev, requires_grad=True)
    w, a, b = (torch.randn(s, device=dev, requires_grad=True)
               for s in ((8, 8), (2, 8, 4), (2, 4, 8)))
    ids = torch.tensor([1, -1], dtype=torch.int32, device=dev)
    serving = {
        "sgmv": lambda: ops.sgmv(x, a, b, ids),
        "ragged_extend": lambda: ops.ragged_extend(qs, kv, kv, ids.abs(), ids.abs() + 3),
        "paged_attention": lambda: ops.paged_attention(
            qs[:, 0], kv, kv, torch.arange(2, device=dev).view(2, 1), ids.abs() + 5),
        "flash_prefill_ragged": lambda: ops.flash_prefill_ragged(qh, kvh, kvh,
                                                                 ids.abs() + 2),
    }
    refused = []
    for name, call in serving.items():
        try:
            call()
        except NotImplementedError:
            refused.append(name)
    require(sorted(refused) == sorted(serving),
            f"only {refused} of the serving-only kernels refused autograd")
    training = {
        "fused_sgmv": ((x, w, a, b), lambda *t: ops.fused_sgmv(*t, ids, scale=0.5),
                       lambda *t: ref.fused_sgmv_ref(*t, ids, 0.5)),
        "flash_prefill": ((qh, kvh, kvh.detach().clone().requires_grad_(True)),
                          ops.flash_prefill, ref.flash_prefill_ref),
    }
    errors = {}
    for name, (inputs, kernel, plain) in training.items():
        out = kernel(*inputs)
        dy = torch.randn_like(out)
        got = torch.autograd.grad(out, inputs, dy)
        want = torch.autograd.grad(plain(*inputs), inputs, dy)
        errs = [float((g - w_).abs().max()) / max(float(w_.abs().max()), 1e-30)
                for g, w_ in zip(got, want)]
        require(max(errs) <= GRAD_TOL, f"{name}: card gradients off the plain "
                                       f"backward's by {max(errs)} of max")
        errors[name] = max(errs)
        # bf16 training is not ported: a bf16 input that requires grad raises
        bf = [t.detach().to(torch.bfloat16).requires_grad_(True) for t in inputs]
        try:
            kernel(*bf)
            require(False, f"{name}: a bf16 input under autograd did not raise")
        except NotImplementedError:
            refused.append(f"{name} bf16")
    return refused, errors


def flash_bwd_case(ops, ref, gen, dev, B=8, S=512, H=16, Hkv=8, D=128):
    """flash_prefill_bwd on views of (B, S, H, D) tensors transposed to
    head-major, as ``gqa_full`` hands them over, from the forward's own out
    and log-sum-exp; the forward's out is the same bits with and without
    the log-sum-exp. The library call is the backward of SDPA (causal, GQA,
    f32) through ``torch.autograd.grad``."""
    F = torch.nn.functional
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).transpose(1, 2)
                   for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                                 (B, S, H, D)))
    out, lse = ops.flash_prefill_fwd(q, k, v)
    with torch.no_grad():
        require(torch.equal(out, ops.flash_prefill(q, k, v)),
                f"flash_prefill {H}/{Hkv}x{D}: out differs with its log-sum-exp")
    lse_err = float((lse - ref.flash_prefill_lse_ref(q, k)).abs().max())
    require(lse_err <= ATTN_TOL * max(1.0, float(lse.abs().max())),
            f"flash_prefill {H}/{Hkv}x{D}: log-sum-exp off by {lse_err}")

    def kernel():
        return ops.flash_prefill_bwd(q, k, v, out, lse, do)

    def plain():
        return ref.flash_prefill_bwd_ref(q, k, v, out, lse, do)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    for name, e, w in zip(("dq", "dk", "dv"), errs, want):
        tol = GRAD_TOL * float(w.abs().max())
        require(e <= tol, f"flash_prefill_bwd {H}/{Hkv}x{D} {name}: max err {e} > {tol}")
    again = kernel()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"flash_prefill_bwd {H}/{Hkv}x{D}: a repeat launch differs")
    del got, again
    # SDPA takes (B, heads, S, D): the head-major views, made contiguous;
    # its gradients' largest error against the plain ones is recorded (a
    # yardstick computes the same function)
    qc, kc, vc = (t.detach().contiguous().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
    do_c = do.contiguous()
    lib_grads = torch.autograd.grad(o_lib, (qc, kc, vc), do_c, retain_graph=True)
    lib_err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(lib_grads, want))
    del want, lib_grads
    library = time_ms(lambda: torch.autograd.grad(o_lib, (qc, kc, vc), do_c,
                                                  retain_graph=True), iters=5)[0]
    del o_lib
    bnd, by = bound_ms(*work("flash_prefill_bwd", B=B, S=S, H=H, Hkv=Hkv, D=D))
    ms, host_ms = time_ms(kernel)
    return dict(case=f"B={B}, S={S}, {H}/{Hkv} heads, D={D}",
                max_abs_err=max(errs), lse_max_abs_err=lse_err, ms=ms, host_ms=host_ms,
                plain_ms=time_ms(plain, **PLAIN)[0], bound_ms=bnd, bound_by=by,
                library_ms=library, library_rel_err=lib_err)


def lora_grad_case(ops, ref, gen, dev, proj, d_in, d_out, B=8, S=512, N=4, r=32):
    """lora_grad (dA, dB and the delta of dx, added into dx = dy·Wᵀ) on one
    projection, with a row of id −1 and repeated ids; an adapter with no
    row gets zeros; a repeat launch gives the same bits. No single library
    call computes it."""
    x = torch.randn((B, S, d_in), generator=gen, device=dev)
    dy = torch.randn((B, S, d_out), generator=gen, device=dev)
    a = torch.randn((N + 1, d_in, r), generator=gen, device=dev) * d_in ** -0.5
    b = torch.randn((N + 1, r, d_out), generator=gen, device=dev) * 0.1
    ids = torch.tensor([-1, 0, 1, 2, 3, 0, 1, 2][:B], dtype=torch.int32, device=dev)
    base = torch.randn((B, S, d_in), generator=gen, device=dev)
    scale = 2.0

    def kernel(dx):
        return ops.lora_grad(x, dy, a, b, ids, scale, dx)

    dx = base.clone()
    da, db = kernel(dx)
    delta, da_w, db_w = ref.lora_grad_ref(x, dy, a, b, ids, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in (("dx", dx, base + delta), ("da", da, da_w), ("db", db, db_w)):
        errs[name] = float((g - w).abs().max())
        tol = GRAD_TOL * float(w.abs().max())
        require(errs[name] <= tol, f"lora_grad {proj} r={r} {name}: max err "
                                   f"{errs[name]} > {tol}")
    require(not da[N].any() and not db[N].any(),
            f"lora_grad {proj} r={r}: an adapter with no row got a gradient")
    dx2 = base.clone()
    da2, db2 = kernel(dx2)
    require(torch.equal(dx2, dx) and torch.equal(da2, da) and torch.equal(db2, db),
            f"lora_grad {proj} r={r}: a repeat launch differs")
    bnd, by = bound_ms(*work("lora_grad", B=B, S=S, d_in=d_in, d_out=d_out, r=r,
                             slots=N + 1, ids=ids.tolist()))
    ms, host_ms = time_ms(lambda: kernel(dx2))
    return dict(case=f"{proj} {d_in}->{d_out}, B={B}, S={S}, r={r}, ids={ids.tolist()}",
                max_abs_err=max(errs.values()), errors=errs, ms=ms, host_ms=host_ms,
                plain_ms=time_ms(lambda: ref.lora_grad_ref(x, dy, a, b, ids, scale),
                                 **PLAIN)[0],
                bound_ms=bnd, bound_by=by, library_ms=None)


LONG_BWD_S = 4096  # the long flash_prefill_bwd case: B = 1, qwen3-0.6b's heads


def backward_kernel_cases(ops, ref, gen, dev):
    """Phase 3's backward cases: flash_prefill_bwd at qwen3-0.6b's B = 8,
    S = 512 and at each :data:`ARCH_HEADS` head shape (B = 2, S = 512);
    lora_grad at qwen3-0.6b's q/k/v/o (B = 8, S = 512, rank 32) and on q at
    ranks 1, 12 and 128; then flash_prefill_bwd at qwen3-0.6b's heads over
    one row of :data:`LONG_BWD_S` tokens. Returns {kernel: [case, ...]},
    the qwen3-0.6b cases first."""
    out = {"flash_prefill_bwd": [flash_bwd_case(ops, ref, gen, dev)], "lora_grad": []}
    torch.cuda.empty_cache()
    for arch, H, Hkv, D in ARCH_HEADS:
        m = flash_bwd_case(ops, ref, gen, dev, B=2, H=H, Hkv=Hkv, D=D)
        out["flash_prefill_bwd"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
    for proj, d_in, d_out in (("q", 1024, 2048), ("k", 1024, 1024), ("v", 1024, 1024),
                              ("o", 2048, 1024)):
        out["lora_grad"].append(lora_grad_case(ops, ref, gen, dev, proj, d_in, d_out))
    for r in (1, 12, 128):
        out["lora_grad"].append(lora_grad_case(ops, ref, gen, dev, "q", 1024, 2048, r=r))
    torch.cuda.empty_cache()
    # a long row, past the budget of the folded dQ partials: the separate
    # dQ pass (flash_prefill.bwd_plan)
    out["flash_prefill_bwd"].append(flash_bwd_case(ops, ref, gen, dev, B=1, S=LONG_BWD_S))
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- phase 4
def make_trace(Request, vocab: int, seed: int = 0, N1: int = 24, tag: str = ""):
    """Two waves: N1 requests, then 12 that include 6 repeats of wave-1
    prompts (prefix hits). About half open with one 256-token shared system
    prompt declared as ``shared_prefix_len``. ``tag`` prefixes the ids."""
    rng = random.Random(seed)
    system = tuple(rng.randrange(vocab) for _ in range(256))

    def fresh(i):
        # 64-1024 tokens, skewed long (mean ~780) so the KV working set
        # (~5 GB) outgrows the 4 GiB pool and the swapper moves KV to host
        n = 64 + int(960 * (1.0 - rng.random() ** 3))
        if i % 2 == 0 and n > 320:
            body = tuple(rng.randrange(vocab) for _ in range(n - 256))
            return system + body, 256
        return tuple(rng.randrange(vocab) for _ in range(n)), 0

    wave1, wave2 = [], []
    for i in range(N1):
        prompt, shared = fresh(i)
        wave1.append(Request(f"{tag}w1-{i}", f"lora-{i % 6}", prompt,
                             max_new_tokens=32, shared_prefix_len=shared))
    for i in range(12):
        if i % 2 == 0:
            old = wave1[(3 * i) % N1]
            prompt, shared, adapter = old.prompt, old.shared_prefix_len, old.adapter_id
        else:
            (prompt, shared), adapter = fresh(i), f"lora-{(i + 3) % 6}"
        wave2.append(Request(f"{tag}w2-{i}", adapter, prompt, max_new_tokens=32,
                             shared_prefix_len=shared))
    return wave1, wave2


KERNEL_GROUPS = (  # device-event name fragment -> group, first match wins
    ("fused_sgmv", "fused_sgmv"), ("lora_shrink", "fused_sgmv"),
    ("lora_grad_", "lora_grad"), ("attn_bwd_", "flash_prefill_bwd"),
    ("ragged_extend", "ragged_extend"), ("paged_attention", "paged_attention"),
    ("flash_prefill", "flash_prefill"),
    ("gemm", "library matmul"), ("gemv", "library matmul"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("Memcpy", "copies"), ("Memset", "copies"),
)


def profiled(fn):
    """Run ``fn`` under ``torch.profiler`` (device activity only). Returns
    the device's busy share of the window's wall time and device time per
    kernel group; ``None`` fields if the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, groups, top = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        g = next((g for frag, g in KERNEL_GROUPS if frag in e.name), "other")
        groups[g] = groups.get(g, 0.0) + (hi - lo) / 1e3
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + (hi - lo) / 1e3
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):  # union of the kernel intervals
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {
        "wall_ms": wall_us / 1e3, "device_events": len(spans),
        "device_busy_ms": busy / 1e3 if spans else None,
        "device_busy_share": busy / wall_us if spans else None,
        "device_ms_by_group": groups or None,
        "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:16]) or None,
    }


def profile_steps(engine, wave, steps: int = 40):
    """Serve a fresh ``wave`` of requests and trace the first ``steps``
    engine steps (see :func:`profiled`)."""
    for r in wave:
        engine.submit(r)

    def window():
        for _ in range(steps):
            engine.step()

    out = {"steps": steps, **profiled(window)}
    engine.run()  # finish the wave outside the window
    return out


def pick_requests(finished):
    """At least 4 finished, never-preempted requests (a preempted request
    folds its tokens into its prompt): one with a shared prefix, one with a
    prefix hit, then the shortest others."""
    clean = [r for r in finished if r.preempt_count == 0]
    shared = [r for r in clean if r.shared_prefix_len > 0][:1]
    hit = [r for r in clean if r.matched_tokens > 0 and r not in shared][:1]
    others = sorted((r for r in clean if r not in shared + hit),
                    key=lambda r: len(r.prompt))
    picked = shared + hit + others[: 4 - len(shared + hit)]
    require(len(picked) >= 4 and shared and hit,
            f"need 4 clean requests with a shared prefix and a prefix hit, "
            f"got {len(picked)}")
    return picked


def check_against_cpu(cfg, max_seq_len, picked, adapter_weights, params=None,
                      seed: int = 0):
    """On the CPU, with the engine's adapters (``adapter_weights``: {id:
    host weights}) and ``params`` (CPU tensors; default: the weights of
    ``seed``, drawn from CPU generators as the engine drew them), run one
    teacher-forced ``extend`` over each request's prompt and generated
    tokens, with its shared span at adapter id -1 as the engine ran it.
    Each card token must be the CPU argmax or trail the CPU's best logit by
    at most ``ARGMAX_TOL``. Returns (tokens, argmax-equal, largest deficit,
    smallest top-2 gap)."""
    from repro_torch.lora import AdapterStore
    from repro_torch.models import build_model

    model = build_model(cfg, dtype=torch.float32, device="cpu")
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(seed))
    store = AdapterStore(model, cfg.lora.max_adapters)
    for aid, weights in adapter_weights.items():
        store.register(aid, weights=weights)
    worst, min_gap, exact, total = 0.0, math.inf, 0, 0
    for r in picked:
        slot = store.load(r.adapter_id)
        full = list(r.prompt) + list(r.generated)
        P, G = len(r.prompt), len(r.generated)
        cache = model.init_cache(1, max_seq_len)
        sb = min(max(r.shared_prefix_len, 0), P)
        spans = [(0, sb, -1), (sb, P + G - 1, slot)] if sb else [(0, P + G - 1, slot)]
        logits = []
        for lo, hi, aid in spans:
            # the span's positions whose next token the card generated
            pos = [p - lo for p in range(max(lo, P - 1), hi)] or [0]
            out, cache = model.extend(
                params, cache, torch.tensor([full[lo:hi]]), cache["len"],
                lora=store.slots, adapter_ids=torch.tensor([aid], dtype=torch.int32),
                logit_positions=torch.tensor([pos]))
            if hi > max(lo, P - 1):
                logits.append(out[0])
        lg = torch.cat(logits)  # (G, vocab)
        require(lg.shape[0] == G, f"{r.request_id}: {lg.shape[0]} logits for {G} tokens")
        gen = torch.tensor(r.generated)
        top2 = lg.topk(2, dim=-1).values
        deficit = float((top2[:, 0] - lg[torch.arange(G), gen]).max())
        worst = max(worst, deficit)
        min_gap = min(min_gap, float((top2[:, 0] - top2[:, 1]).min()))
        exact += int((lg.argmax(-1) == gen).sum())
        total += G
        require(deficit <= ARGMAX_TOL,
                f"{r.request_id}: a card token trails the CPU max logit by {deficit}")
        store.unload(r.adapter_id)
    return total, exact, worst, min_gap


# ----------------------------------------------------------------- phase 6
def random_lora(model, n_slots: int, seed: int) -> dict:
    """LoRA slots with non-zero A and B, drawn on the CPU (the same numbers
    on every device): ``init_lora`` zeroes B, and a zero B would hide a
    broken delta."""
    gen = torch.Generator().manual_seed(seed)
    lora = model.init_lora(gen, n_slots)
    return {t: (a, (torch.randn(b.shape, generator=gen) * 0.02).to(model.device,
                                                                    model.dtype))
            for t, (a, b) in lora.items()}


def top2_gap(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def greedy(model, params, lora, tokens, ids, max_len: int, steps: int):
    """``LM.prefill`` then ``steps`` greedy ``make_decode_step`` steps.
    Returns the tokens (B, steps + 1), the seconds of the prefill and of
    the decode steps (synchronised), and the cache."""
    from repro_torch.models import make_decode_step

    decode = make_decode_step(model)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, tokens, max_len, lora=lora, adapter_ids=ids)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    sync()
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(steps):
        tok, cache = decode(params, lora, cache, {"tokens": tok[:, None],
                                                  "adapter_ids": ids})
        out.append(tok)
    sync()
    return torch.stack(out, 1).cpu(), t1 - t0, time.perf_counter() - t1, cache


def identity_logits(model, params, lora, tokens, ids, pin=None, frames=None):
    """forward over ``tokens`` (B, S), prefill of tokens[:, :S-1] and the
    decode of token S-1 (see :func:`arch_identities`), an encoder-decoder's
    after ``frames``; with ``pin`` (a :class:`PinnedRouting` in use) the
    forward's expert choices are replayed in the prefill and the decode.
    Returns ((prefill logits, forward's at S-2), (decode logits, forward's
    at S-1))."""
    B, S = tokens.shape
    src = () if frames is None else (frames,)
    if pin is not None:
        pin.record(B)
    full, _ = model.forward(params, *src, tokens, lora=lora, adapter_ids=ids)
    if pin is not None:
        pin.replay(B, 0)
    last, cache = model.prefill(params, *src, tokens[:, :S - 1], S, lora=lora,
                                adapter_ids=ids)
    if pin is not None:
        pin.replay(B, S - 1)
    dec, _ = model.decode(params, cache, tokens[:, S - 1:], lora=lora, adapter_ids=ids)
    return (last[:, 0], full[:, S - 2]), (dec[:, 0], full[:, S - 1])


def arch_identities(model, params, lora, tokens, ids):
    """forward / prefill / decode against each other on ``tokens`` (B, S):
    prefill of tokens[:, :S-1] gives forward's logits at S-2, and decoding
    token S-1 then gives forward's logits at S-1. Returns the largest
    excess of |difference| over ARCH_TOL·(1 + |forward|) (<= 0 passes) and
    the largest |difference| of each identity."""
    errs, excess = [], -math.inf
    for got, want in identity_logits(model, params, lora, tokens, ids):
        diff = (got - want).abs()
        errs.append(float(diff.max()))
        excess = max(excess, float((diff - ARCH_TOL * (1 + want.abs())).max()))
    return excess, errs


def generate_phase(ops, cfg, dev, seed: int = 0, B: int = 8, S: int = 2016,
                   max_len: int = 2048, steps: int = 32, check_rows=(0, 7),
                   check_tokens: int = 8):
    """Phase 6: the static-batch prefill / greedy-decode path at full width.
    Returns (its JSON line, the launch counts of its run)."""
    from repro_torch.models import build_model, make_decode_step

    L = cfg.num_layers
    model = build_model(cfg, dtype=torch.float32, device=dev)
    params = model.init_params(torch.Generator().manual_seed(seed))
    lora = random_lora(model, 8, seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed + 2))
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1][:B], dtype=torch.int32)

    ops.reset_launch_counts()
    gen_tokens, prefill_s, decode_s, cache = greedy(model, params, lora, tokens,
                                                    ids, max_len, steps)
    launches = ops.launch_counts()
    del cache
    want = dict.fromkeys(launches, 0)
    want.update(flash_prefill=L, fused_sgmv=4 * L * (1 + steps),
                paged_attention=L * steps)
    require(launches == want, f"generate launches {launches}, expected {want}")

    # a second prefill and 8 decode steps under the profiler
    prof_prefill = profiled(lambda: model.prefill(params, tokens, max_len,
                                                  lora=lora, adapter_ids=ids))
    torch.cuda.empty_cache()
    _, cache = model.prefill(params, tokens, max_len, lora=lora, adapter_ids=ids)
    tok = gen_tokens[:, 0].to(dev)
    step = make_decode_step(model)

    def decode8():
        nonlocal tok, cache
        for _ in range(8):
            tok, cache = step(params, lora, cache, {"tokens": tok[:, None],
                                                    "adapter_ids": ids})

    prof_decode = profiled(decode8)
    del cache
    torch.cuda.empty_cache()

    excess, arch_errs = arch_identities(model, params, lora, tokens[:2, :256],
                                        ids[list(check_rows)])
    require(excess <= 0, f"forward / prefill / decode disagree on the card: "
                         f"max errors {arch_errs} over {ARCH_TOL}·(1 + |logit|)")
    del model, params, lora
    torch.cuda.empty_cache()

    # the CPU run of the same weights: the kernels' plain versions
    t0 = time.perf_counter()
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    cpu_params = cpu.init_params(torch.Generator().manual_seed(seed))
    cpu_lora = random_lora(cpu, 8, seed + 1)
    rows = list(check_rows)
    prompt = tokens[rows]
    cpu_tokens, _, _, cache = greedy(cpu, cpu_params, cpu_lora, prompt, ids[rows],
                                     S + check_tokens, check_tokens - 1)
    # the top-2 gap of each checked token: one extend over the last prompt
    # token and the generated ones, with every position's logits
    logits, _ = cpu.extend(
        cpu_params, cache, torch.cat([prompt[:, -1:], cpu_tokens[:, :-1]], 1),
        torch.full((len(rows),), S - 1), lora=cpu_lora, adapter_ids=ids[rows],
        all_logits=True)
    cpu_s = time.perf_counter() - t0
    equal = torch.equal(cpu_tokens, gen_tokens[rows, :check_tokens])
    require(equal, f"card tokens {gen_tokens[rows, :check_tokens].tolist()} != "
                   f"CPU tokens {cpu_tokens.tolist()}")
    line = {
        "phase": "generate", "batch": B, "prompt_tokens": S, "max_len": max_len,
        "decode_steps": steps, "adapter_ids": ids.tolist(),
        "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
        "decode_s": decode_s, "decode_ms_per_step": decode_s / steps * 1e3,
        "decode_tokens_per_s": B * steps / decode_s,
        "launches": launches, "profile_prefill": prof_prefill,
        "profile_decode_8_steps": prof_decode,
        "arch_identities_max_abs_err": arch_errs,
        "cpu_rows": rows, "cpu_tokens_equal": equal,
        "tokens": gen_tokens[rows, :check_tokens].tolist(),
        "smallest_top2_gap": float(top2_gap(logits).min()),
        "cpu_seconds": cpu_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }
    return line, launches


# ---------------------------------------------------------------- variants
SOFTCAP = 50.0  # Gemma 2's published attention logit softcap


def variants_phase(ops, cfg, dev, seed: int = 0, B: int = 2, S: int = 256,
                   steps: int = 8):
    """The static path on full-width qwen3-0.6b with an int8 KV cache
    (``kv_quant``) and with the attention logits capped at :data:`SOFTCAP`
    (no config of the repo sets one): ``LM.prefill`` of B prompts of S
    tokens and ``steps`` greedy decode steps, launch counts reset just
    before and read just after each. The reference routes both variants'
    cached attention to its plain attention, and the softcap's fresh
    prefill too: ``paged_attention`` never runs, ``flash_prefill`` only for
    the int8 cache's prefill. Then the card's tokens teacher-forced on the
    CPU (prefill of the prompts, one extend over the generated tokens) with
    the same weights: each must be the CPU argmax or trail its best logit
    by at most ARGMAX_TOL. Returns (its JSON line, the summed launches)."""
    from repro_torch.models import build_model

    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    cpu_params = cpu.init_params(torch.Generator().manual_seed(seed))
    params = tree_to(cpu_params, dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed + 2))
    ids = torch.tensor([0, -1][:B], dtype=torch.int32)
    L, line, total = cfg.num_layers, {"phase": "variants", "arch": cfg.name,
                                      "batch": B, "prompt_tokens": S,
                                      "decode_steps": steps}, None
    for name, vcfg, kv_quant in (("kv_quant", cfg, True),
                                 ("softcap", dataclasses.replace(cfg, logit_softcap=SOFTCAP),
                                  False)):
        model = build_model(vcfg, dtype=torch.float32, device=dev, kv_quant=kv_quant)
        lora = random_lora(model, 8, seed + 1)
        ops.reset_launch_counts()
        gen, prefill_s, decode_s, cache = greedy(model, params, lora, tokens, ids,
                                                 S + steps, steps)
        launches = ops.launch_counts()
        del cache, model, lora
        want = dict.fromkeys(launches, 0)
        want.update(fused_sgmv=4 * L * (1 + steps), flash_prefill=L * kv_quant)
        require(launches == want, f"{name}: launches {launches}, expected {want}")
        total = dict(launches) if total is None else {
            k: total[k] + n for k, n in launches.items()}
        t0 = time.perf_counter()
        cm = build_model(vcfg, dtype=torch.float32, device="cpu", kv_quant=kv_quant)
        cl = random_lora(cm, 8, seed + 1)
        last, cache = cm.prefill(cpu_params, tokens, S + steps, lora=cl, adapter_ids=ids)
        rest, _ = cm.extend(cpu_params, cache, gen[:, :-1], cache["len"], lora=cl,
                            adapter_ids=ids, all_logits=True)
        lg = torch.cat([last, rest], 1)  # (B, steps + 1, vocab)
        picked = lg.gather(-1, gen[:, :, None].long())[..., 0]
        deficit = float((lg.max(-1).values - picked).max())
        require(deficit <= ARGMAX_TOL,
                f"{name}: a card token trails the CPU max logit by {deficit}")
        line[name] = {
            "prefill_s": prefill_s, "decode_ms_per_step": decode_s / steps * 1e3,
            "launches": launches, "tokens": gen.tolist(),
            "cpu": {"tokens": gen.numel(),
                    "argmax_equal": int((lg.argmax(-1) == gen).sum()),
                    "largest_deficit": deficit,
                    "smallest_top2_gap": float(top2_gap(lg).min()),
                    "seconds": time.perf_counter() - t0}}
        if name == "softcap":
            line[name]["softcap"] = SOFTCAP
    return line, total


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ------------------------------------------------------------------- archs
# The configs at full width: (name, layers run; None: all of them).
# stablelm-12b (~48 GB of f32 weights at full depth), llama-13b (~52 GB,
# and 1.6 MB of f32 KV a token) and llama-34b (~135 GB: no 80 GB card holds
# it in f32) run 4 of their layers; deepseek-v2-lite-16b 4 of 27 (~65 GB at
# full depth, too much beside the check's CPU copy; layer 0 is dense, 1-3
# MoE) and phi3.5-moe 2 of 32 (~167 GB at full depth). llama-7b,
# qwen2-vl-7b and qwen3-4b run 4 layers too, to keep the script inside its
# time limit on a slow host (phase 9 runs llama-7b at full depth in bf16).
# Every kernel sees the same shapes at every depth.
ARCHS = (("llama-7b", 4), ("qwen2-vl-7b", 4), ("qwen3-4b", 4),
         ("gemma-2b", None), ("stablelm-12b", 4), ("llama-13b", 4),
         ("llama-34b", 4), ("deepseek-v2-lite-16b", 4),
         ("phi3.5-moe-42b-a6.6b", 2))
# the static path at D = 160, 256, and on MLA and the MoE FFN
STATIC_ARCHS = ("stablelm-12b", "gemma-2b", "deepseek-v2-lite-16b",
                "phi3.5-moe-42b-a6.6b")
PROFILE_ARCHS = ("llama-7b", "deepseek-v2-lite-16b",  # under torch.profiler
                 "rwkv6-1.6b")
ARCH_POOL_TOKENS = 4096  # device KV pool: the trace's working set, ~3.4k tokens
ARCH_MAX_SEQ = 640  # 512-token prompts and 16 new tokens; 5 pages of 128
# phase 3 at the archs' shapes: (config, query heads, kv heads, head dim)
ARCH_HEADS = (("llama-7b", 32, 32, 128), ("qwen2-vl-7b", 28, 4, 128),
              ("stablelm-12b", 32, 8, 160), ("gemma-2b", 8, 1, 256),
              ("phi3.5-moe-42b-a6.6b", 32, 8, 128),
              ("seamless-m4t-large-v2", 16, 16, 64))
# seamless-m4t-large-v2's static path (phase 7c): B rows of S prompt
# tokens after S_SRC frames, STEPS greedy steps, the identities' forward
# over FORWARD tokens
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_B, ENCDEC_S, ENCDEC_S_SRC, ENCDEC_STEPS, ENCDEC_FORWARD = 2, 512, 512, 8, 256
# flash_prefill at the static path's shapes: (config, B, S, heads, kv heads, D)
ARCH_FLASH = (("stablelm-12b", 2, 2048, 32, 8, 160), ("gemma-2b", 2, 2048, 8, 1, 256),
              ("phi3.5-moe-42b-a6.6b", 2, 512, 32, 8, 128),
              (ENCDEC_ARCH, ENCDEC_B, ENCDEC_FORWARD, 16, 16, 64))
# fused_sgmv at the LoRA projections of the MLA and MoE configs (rank 32):
# deepseek's kv_a is the first d_out that is no multiple of the 128-column
# tile; all warm and with a cold L2
ARCH_SGMV = (("deepseek-v2-lite-16b", "kv_a", 2048, 576),
             ("deepseek-v2-lite-16b", "q", 2048, 3072),
             ("deepseek-v2-lite-16b", "o", 2048, 2048),
             ("phi3.5-moe-42b-a6.6b", "k", 4096, 1024),
             ("recurrentgemma-2b", "q", 2560, 2560),
             ("recurrentgemma-2b", "k", 2560, 256),
             # rwkv6-1.6b's r (2048 -> 2048) has deepseek's o shape,
             # seamless-m4t's q (1024 -> 1024) qwen3-0.6b's k: not repeated
             )
# the MoE configs' card-against-CPU check replays these extend calls of the
# engine trace, each chosen by its kind before the run: the first mixed
# step (prefill chunks with decode riders) and the first two pure decode
# calls after it
REPLAY = ("mixed", "decode", "decode")


def arch_kernel_cases(ops, ref, gen, dev):
    """Phase 3 at the shapes of the other configs: ragged_extend at the
    256-token bucket and paged_attention at the engine's decode lengths for
    llama-7b (G = 1), qwen2-vl-7b (G = 7), stablelm-12b (D = 160), gemma-2b
    (D = 256, MQA) and phi3.5-moe (32/8 heads); flash_prefill and
    flash_prefill_ragged at B = 2, S = 2048 for the two wide heads,
    flash_prefill at phi3.5-moe's static prefill; fused_sgmv on llama-7b's
    q projection at S = 256 and 1 and at :data:`ARCH_SGMV`; fused_sgmv and
    sgmv at ranks 1, 12 and 128 on qwen3-0.6b's q projection. Returns
    {kernel: [case, ...]}."""
    out = {k: [] for k in ("fused_sgmv", "sgmv", "ragged_extend", "paged_attention",
                           "flash_prefill", "flash_prefill_ragged")}
    for arch, H, Hkv, D in ARCH_HEADS:
        m = ragged_case(ops, ref, gen, dev, 256, *RAGGED_BUCKETS[256], H=H, Hkv=Hkv, D=D)
        out["ragged_extend"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
        m = paged_case(ops, ref, gen, dev, PAGED_LENGTHS["engine"], H=H, Hkv=Hkv, D=D)
        out["paged_attention"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
    for arch, B, S, H, Hkv, D in ARCH_FLASH:
        m = flash_case(ops, ref, gen, dev, B=B, S=S, H=H, Hkv=Hkv, D=D)
        out["flash_prefill"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
        if S == 2048:
            m = flash_case(ops, ref, gen, dev, lens=[2048, 1000], B=B, S=S, H=H,
                           Hkv=Hkv, D=D)
            out["flash_prefill_ragged"].append({"arch": arch, **m})
            torch.cuda.empty_cache()
    for S in (256, 1):
        m = sgmv_case(ops, ref, "q", 4096, 4096, S, gen, dev)
        out["fused_sgmv"].append({"arch": "llama-7b", **m})
    for arch, proj, d_in, d_out in ARCH_SGMV:
        for S in (256, 1):
            m = sgmv_case(ops, ref, proj, d_in, d_out, S, gen, dev, cold=True)
            out["fused_sgmv"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
    for r in (1, 12, 128):
        for S in (256, 1):
            m = sgmv_case(ops, ref, "q", 1024, 2048, S, gen, dev, r=r)
            out["fused_sgmv"].append({"arch": "qwen3-0.6b", **m})
            m = sgmv_case(ops, ref, "q", 1024, 2048, S, gen, dev, r=r, base=False)
            out["sgmv"].append({"arch": "qwen3-0.6b", **m})
    torch.cuda.empty_cache()
    return out


def encdec_kernel_cases(ops, ref, gen, dev):
    """The kernels at phase 7c's own inputs (its counted launches): the
    prefill's ``ragged_extend`` (start 0, every token real, a cache of T =
    S + steps), the first and last greedy step's ``paged_attention`` over
    the page size that T takes, both warm and cold; the decoder's
    ``fused_sgmv`` on q at B rows of S and of 1 token. Yields (kernel,
    case)."""
    from repro_torch.models.attention import _page_size_for

    H, Hkv, D = next((h, g, d) for a, h, g, d in ARCH_HEADS if a == ENCDEC_ARCH)
    B, S, T = ENCDEC_B, ENCDEC_S, ENCDEC_S + ENCDEC_STEPS
    yield "ragged_extend", ragged_case(ops, ref, gen, dev, S, [S] * B, [0] * B, B=B,
                                       T=T, H=H, Hkv=Hkv, D=D, cold=True)
    ps = _page_size_for(T)
    require(ps > 0, f"{ENCDEC_ARCH}: no page size divides T = {T}")
    for n in (S + 1, T):
        yield "paged_attention", paged_case(ops, ref, gen, dev, [n] * B, B=B, T=T, H=H,
                                            Hkv=Hkv, D=D, ps=ps)
    for rows in (S, 1):
        yield "fused_sgmv", sgmv_case(ops, ref, "q", H * D, H * D, rows, gen, dev, B=B,
                                      cold=True)


def arch_trace(Request, vocab: int, seed: int = 0):
    """Two waves of 6 requests on 4 adapters: prompts of 64-512 tokens, the
    even ones behind one 128-token shared prompt (declared as
    ``shared_prefix_len``), 16 new tokens each. The second wave's shared
    prompts find the first wave's on the trunk."""
    rng = random.Random(seed)
    system = tuple(rng.randrange(vocab) for _ in range(128))
    waves = ([], [])
    for i in range(12):
        n = rng.randint(64, 512)
        if i % 2 == 0:
            n = max(n, 192)
            prompt = system + tuple(rng.randrange(vocab) for _ in range(n - 128))
        else:
            prompt = tuple(rng.randrange(vocab) for _ in range(n))
        waves[i // 6].append(Request(f"a{seed}-{i}", f"lora-{i % 4}", prompt,
                                     max_new_tokens=16,
                                     shared_prefix_len=128 if i % 2 == 0 else 0))
    return waves


def host_mem_total() -> int:
    """The host's MemTotal in bytes (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) * 1024
    return 0


def tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_cpu(v) for v in tree)
    return tree.cpu()


def expected_launches(model, launches, prefill_calls: int, decode_calls: int,
                      fresh_prefills: int = 0) -> dict:
    """The launch counts a run must give: every LoRA target of every layer
    that has them through fused_sgmv on each call; GQA attention through
    ragged_extend in each prefill call, paged_attention in each decode call
    and flash_prefill in each fresh prefill (``LM.prefill``), as the
    reference routes it; MLA, RWKV (LoRA on r/k/v/o, no attention) and the
    hybrid (LoRA and a windowed, plain attention on its attention layers
    only) through none of the attention kernels; the encoder-decoder's
    decoder through ragged_extend in its fresh prefills too (its encoder
    and cross-attention through the plain sdpa)."""
    cfg = model.cfg
    L = cfg.num_layers
    if cfg.rglru is not None:
        L = model._layer_types().count("attn")
    n_targets = len(model.lora_dims())
    want = dict.fromkeys(launches, 0)
    want["fused_sgmv"] = n_targets * L * (prefill_calls + decode_calls + fresh_prefills)
    if cfg.is_encdec:  # its decoder's fresh prefill extends from start 0
        want.update(ragged_extend=L * (prefill_calls + fresh_prefills),
                    paged_attention=L * decode_calls)
        return want
    gqa = cfg.mla is None and not model.recurrent
    want.update(ragged_extend=L * prefill_calls * gqa,
                paged_attention=L * decode_calls * gqa,
                flash_prefill=L * fresh_prefills * gqa)
    return want


def no_drop_model(model):
    """The same LM with ``capacity_factor = E`` (C == T·k: no token is
    dropped), as the reference's smoke tests set it; ``model`` itself where
    there is no MoE FFN."""
    from repro_torch.models import build_model

    cfg = model.cfg
    if cfg.moe is None:
        return model
    moe = dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts))
    return build_model(dataclasses.replace(cfg, moe=moe), dtype=model.dtype, device=model.device)


def static_path(ops, model, params, seed: int = 0, B: int = 2, S: int = 512,
                steps: int = 8):
    """``LM.prefill`` of B prompts of S tokens and ``steps`` greedy decode
    steps (exact launch counts), then forward / prefill / decode against
    each other at B = 2, S = 256, on the engine's weights. With an MoE FFN
    the identities run at ``capacity_factor = E`` (:func:`no_drop_model`):
    at the published factor the tokens a step drops depend on the whole
    batch, which differs between the three calls."""
    cfg = model.cfg
    lora = random_lora(model, 8, seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed + 2))
    ids = torch.tensor([0, -1][:B], dtype=torch.int32)
    ops.reset_launch_counts()
    _, prefill_s, decode_s, cache = greedy(model, params, lora, tokens, ids,
                                           ARCH_MAX_SEQ, steps)
    launches = ops.launch_counts()
    del cache
    want = expected_launches(model, launches, 0, steps, fresh_prefills=1)
    require(launches == want, f"{cfg.name} static launches {launches}, expected {want}")
    excess, errs = arch_identities(no_drop_model(model), params, lora, tokens[:, :256], ids)
    require(excess <= 0, f"{cfg.name}: forward / prefill / decode disagree on the card: "
                         f"max errors {errs} over {ARCH_TOL}·(1 + |logit|)")
    out = {"batch": B, "prompt_tokens": S, "decode_steps": steps,
           "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
           "decode_ms_per_step": decode_s / steps * 1e3, "launches": launches,
           "arch_identities_max_abs_err": errs}
    if cfg.moe is not None:
        out["identities_capacity_factor"] = float(cfg.moe.num_experts)
    return out


class ExtendRecorder:
    """Stands in for ``model.extend`` (an instance attribute, which the
    engine and its prefill subsystem both look up): passes every call
    through and, for the calls :data:`REPLAY` names by kind, keeps on the
    host the inputs (tokens, offsets, token mask, kept rows, adapter ids,
    the adapter slots) and the whole cache before the call, and the logits
    and cache after it. ``close`` puts the model's own method back."""

    def __init__(self, model):
        self.model, self.extend = model, model.extend
        self.calls, self.records, self.wanted = 0, [], list(REPLAY)
        model.extend = self

    @staticmethod
    def kind(tokens, kw) -> str:
        tl = kw.get("true_lens")
        if tl is None:
            return "decode" if tokens.shape[1] == 1 else "chunk"
        tl = torch.as_tensor(tl)
        return "mixed" if bool((tl == 1).any() and (tl > 1).any()) else "prefill"

    def __call__(self, params, cache, tokens, start, **kw):
        index, kind = self.calls, self.kind(tokens, kw)
        self.calls += 1
        take = bool(self.wanted) and self.wanted[0] == kind
        if take:
            self.wanted.pop(0)
            rec = {"index": index, "kind": kind, "bucket": int(tokens.shape[1]),
                   "tokens": torch.as_tensor(tokens).cpu().clone(),
                   "start": torch.as_tensor(start).cpu().clone(),
                   "kw": {k: tree_cpu(v) if isinstance(v, dict) else
                          torch.as_tensor(v).cpu().clone() for k, v in kw.items()},
                   "cache": {k: v.cpu().clone() for k, v in cache.items()}}
        logits, cache = self.extend(params, cache, tokens, start, **kw)
        if take:
            rec["logits"] = logits.cpu()
            rec["cache_after"] = {k: v.cpu().clone() for k, v in cache.items()}
            self.records.append(rec)
        return logits, cache

    def close(self):
        del self.model.extend


def replay_on_cpu(cfg, records, cpu_params):
    """Rerun each recorded ``extend`` on the CPU (the kernels' plain
    versions) from the recorded cache, with the engine's weights and
    adapter slots, and hold the card's logits (kept rows; every row's last
    real token), updated cache and argmax against it: |card − CPU| within
    ARCH_TOL·(1 + |CPU|), and each card argmax the CPU's or trailing its
    best logit by at most ARGMAX_TOL."""
    from repro_torch.models import build_model

    require(len(records) == len(REPLAY),
            f"{cfg.name}: replayed {[r['kind'] for r in records]}, wanted {REPLAY}")
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    out = []
    for rec in records:
        t0 = time.perf_counter()
        kw = dict(rec["kw"])
        logits, cache = model.extend(cpu_params, dict(rec["cache"]), rec["tokens"],
                                     rec["start"], **kw)
        keep = kw.get("keep_rows")
        rows = (torch.arange(logits.shape[0]) if keep is None
                else keep.nonzero()[:, 0])
        want, got = logits[rows, -1], rec["logits"][rows, -1]
        excess = float(((got - want).abs() - ARCH_TOL * (1 + want.abs())).max())
        card_tok = got.argmax(-1)
        deficit = float((want.max(-1).values - want[torch.arange(len(rows)), card_tok]).max())
        cache_excess = max(
            float(((rec["cache_after"][k] - cache[k]).abs()
                   - ARCH_TOL * (1 + cache[k].abs())).max())
            for k in cache if k != "len")
        require(torch.equal(cache["len"], rec["cache_after"]["len"]),
                f"{cfg.name}: call {rec['index']}: len differs")
        require(excess <= 0 and cache_excess <= 0 and deficit <= ARGMAX_TOL,
                f"{cfg.name}: call {rec['index']} ({rec['kind']}): logits over tolerance "
                f"by {excess}, cache by {cache_excess}, argmax deficit {deficit}")
        out.append({"call": rec["index"], "kind": rec["kind"], "bucket": rec["bucket"],
                    "rows": len(rows), "logits_max_abs_err": float((got - want).abs().max()),
                    "cache_max_abs_err": max(
                        float((rec["cache_after"][k] - cache[k]).abs().max())
                        for k in cache if k != "len"),
                    "argmax_equal": int((card_tok == want.argmax(-1)).sum()),
                    "largest_deficit": deficit,
                    "smallest_top2_gap": float(top2_gap(want).min()),
                    "seconds": time.perf_counter() - t0})
    return out


def arch_phase(ops, configs, EngineConfig, ServingEngine, Request, dev, name,
               layers, seed: int = 0):
    """One config at full width (``layers`` of them, or all): weights
    drawn on the card from a seeded generator and handed to the engine,
    which serves :func:`arch_trace`; exact launch counts; the static path
    for ``STATIC_ARCHS``; then the CPU check with the engine's weights: two
    clean requests teacher-forced, or, with an MoE FFN, the :data:`REPLAY`
    steps replayed (at the published capacity factor the tokens dropped
    depend on the whole padded batch, so one request alone would not
    reproduce them). Returns (its JSON line, its launch counts)."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import kv_pool_spec

    t_start = time.perf_counter()
    full = configs.get(name)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.float32, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    weights_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    spec = kv_pool_spec(cfg, 16)
    kv_token = spec.bytes_per_token
    adapters = [f"lora-{i}" for i in range(4)]
    # the manager's pools hold the adapters beside the KV: 4 adapters of
    # L·r·Σ(d_in + d_out) floats (81 MB each for qwen2-vl-7b)
    lora_bytes = len(adapters) * 4 * L * cfg.lora.rank * sum(
        din + dout for din, dout in model.lora_dims().values())
    pool = ARCH_POOL_TOKENS * kv_token + lora_bytes
    ecfg = EngineConfig(hbm_bytes=pool, host_bytes=pool, block_size=16,
                        max_batch_slots=8, max_seq_len=ARCH_MAX_SEQ, prefill_chunk=256,
                        step_token_budget=512)
    engine = ServingEngine(cfg, ecfg, params=params, device=dev)
    require(engine.params["embed"].data_ptr() == params["embed"].data_ptr(),
            f"{name}: the engine copied weights drawn on the card")
    require(engine.kv_spec == spec, f"{name}: the engine's pool is {engine.kv_spec}")
    for aid in adapters:
        engine.register_adapter(aid)
    wave1, wave2 = arch_trace(Request, cfg.vocab_size, seed)
    reqs = wave1 + wave2
    recorder = ExtendRecorder(engine.model) if cfg.moe is not None else None
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in wave1:
        engine.submit(r)
    engine.run()
    for r in wave2:
        engine.submit(r)
    report = engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    if recorder is not None:
        recorder.close()
    row = report.row()
    decode_calls, prefill_calls = engine._decode_calls, engine.prefill.stats.calls
    require(row["n_finished"] == len(reqs) and row["n_unfinished"] == 0,
            f"{name}: finished {row['n_finished']} of {len(reqs)}")
    require(row["kv_hit_rate"] > 0, f"{name}: kv_hit_rate is 0")
    want = expected_launches(model, launches, prefill_calls, decode_calls)
    require(launches == want, f"{name}: launches {launches} do not match {decode_calls} "
                              f"decode and {prefill_calls} prefill calls of {L} layers")
    generated = sum(len(r.generated) for r in reqs)
    line = {
        "phase": "archs", "arch": name, "layers": L, "of_layers": full.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
        "lora_targets": sorted(model.lora_dims()),
        "weights_bytes": weights_bytes, "kv_bytes_per_token": kv_token,
        "pool_bytes": pool, "setup_s": setup_s, "run_s": run_s,
        "requests": len(reqs), "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "generated_tokens": generated, "generated_tokens_per_s": generated / run_s,
        "avg_ttft": row["avg_ttft"], "p99_ttft": row["p99_ttft"],
        "avg_tpot": row["avg_tpot"], "p99_tpot": row["p99_tpot"],
        "kv_hit_rate": row["kv_hit_rate"], "steps": engine._step_count,
        "decode_calls": decode_calls, "prefill_calls": prefill_calls,
        "launches": launches,
    }
    if cfg.mla is not None:
        line["mla"] = dataclasses.asdict(cfg.mla)
    if cfg.moe is not None:
        line["moe"] = dataclasses.asdict(cfg.moe)
    picked = pick_two(engine.finished) if recorder is None else None
    if name in PROFILE_ARCHS:
        line["profile"] = profile_steps(engine, arch_trace(Request, cfg.vocab_size,
                                                           seed + 1)[0], steps=20)
    if name in STATIC_ARCHS:
        line["static"] = static_path(ops, engine.model, engine.params, seed)
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # the CPU run of the engine's own weights and adapters
    t0 = time.perf_counter()
    cpu_params = tree_cpu(engine.params)
    adapter_weights = {aid: engine.adapters._host[aid].weights for aid in adapters}
    del engine, model, params
    torch.cuda.empty_cache()
    if recorder is not None:
        line["cpu"] = {"replayed": replay_on_cpu(cfg, recorder.records, cpu_params),
                       "rule": list(REPLAY)}
    else:
        total, exact, worst, min_gap = check_against_cpu(cfg, ARCH_MAX_SEQ, picked,
                                                         adapter_weights, cpu_params)
        line["cpu"] = {"requests": [r.request_id for r in picked],
                       "shared_prefix": [r.shared_prefix_len for r in picked],
                       "tokens": total, "argmax_equal": exact, "largest_deficit": worst,
                       "smallest_top2_gap": min_gap}
    del cpu_params
    line["cpu"]["seconds"] = time.perf_counter() - t0
    line["seconds"] = time.perf_counter() - t_start
    return line, launches


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def pick_two(finished):
    """The shortest finished, never-preempted request with a shared prefix
    and the shortest without one."""
    clean = sorted((r for r in finished if r.preempt_count == 0),
                   key=lambda r: len(r.prompt) + len(r.generated))
    picked = ([r for r in clean if r.shared_prefix_len > 0][:1]
              + [r for r in clean if r.shared_prefix_len == 0][:1])
    require(len(picked) == 2, f"need 2 clean requests, got {len(picked)}")
    return picked


# ---------------------------------------------------------- recurrent archs
# rwkv6-1.6b (24 layers, ~6.3 GB of f32 weights) and recurrentgemma-2b (26
# layers, ~11.6 GB), both at full depth, served with state snapshots
STATE_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b")
STATE_SPARE = 3  # snapshots the device pool holds beside the running rows


def state_trace(Request, vocab: int, seed: int = 0):
    """The first wave, 8 prompts of 128-384 tokens on 4 adapters, 16 new
    tokens each; and a function that builds a later wave from the first
    once the waves before it have run. Wave 2: the first two prompts again,
    two continued conversations (a first-wave request's prompt and output,
    then 64 new tokens) and two fresh prompts; its running rows and new
    snapshots push the untouched first-wave snapshots to the host. Wave 3:
    the last four first-wave prompts again, which find their snapshots
    there and swap them back in."""
    rng = random.Random(seed)

    def fresh(tag):
        n = rng.randint(128, 384)
        return tuple(rng.randrange(vocab) for _ in range(n))

    wave1 = [Request(f"s{seed}-a{i}", f"lora-{i % 4}", fresh(i), max_new_tokens=16)
             for i in range(8)]

    def later(wave):
        if wave == 3:
            return [Request(f"s{seed}-late{i}", r.adapter_id, r.prompt, max_new_tokens=16)
                    for i, r in enumerate(wave1[4:])]
        out = [Request(f"s{seed}-again{i}", r.adapter_id, r.prompt, max_new_tokens=16)
               for i, r in enumerate(wave1[:2])]
        out += [Request(f"s{seed}-turn2-{i}", r.adapter_id,
                        r.full_tokens + tuple(rng.randrange(vocab) for _ in range(64)),
                        max_new_tokens=16) for i, r in enumerate(wave1[2:4])]
        out += [Request(f"s{seed}-b{i}", f"lora-{i + 1}", fresh(i), max_new_tokens=16)
                for i in range(2)]
        return out

    return wave1, later


def pick_resumed(finished):
    """The shortest finished, never-preempted request that resumed from a
    snapshot and the shortest one that started cold."""
    clean = sorted((r for r in finished if r.preempt_count == 0),
                   key=lambda r: len(r.prompt) + len(r.generated))
    picked = ([r for r in clean if r.matched_tokens > 0][:1]
              + [r for r in clean if r.matched_tokens == 0][:1])
    require(len(picked) == 2, f"need a resumed and a cold request, got {len(picked)}")
    return picked


def ring_wrap(model, params, lora, seed: int = 0, B: int = 2, steps: int = 8):
    """recurrentgemma's ring of window slots: prefill of B x W tokens (W the
    window) into a cache of W + ``steps`` positions, which holds W slots,
    then ``steps`` decode steps of the next tokens, writing positions W ..
    W + steps - 1 onto ring slots 0 .. steps - 1. Each step's logits (and
    the prefill's last) against windowed ``forward`` over all W + steps
    tokens, within ARCH_TOL·(1 + |forward|)."""
    W = model.cfg.window_size
    tokens = torch.randint(0, model.cfg.vocab_size, (B, W + steps),
                           generator=torch.Generator().manual_seed(seed + 4))
    ids = torch.tensor([0, -1][:B], dtype=torch.int32)
    full, _ = model.forward(params, tokens, lora=lora, adapter_ids=ids)
    want = full[:, W - 1:].clone()
    del full
    last, cache = model.prefill(params, tokens[:, :W], W + steps, lora=lora,
                                adapter_ids=ids)
    require(cache["k"].shape[2] == W, f"ring of {cache['k'].shape[2]} slots, not {W}")
    got = [last[:, 0]]
    for j in range(steps):
        dec, cache = model.decode(params, cache, tokens[:, W + j:W + j + 1], lora=lora,
                                  adapter_ids=ids)
        got.append(dec[:, 0])
    got = torch.stack(got, 1)
    diff = (got - want).abs()
    excess = float((diff - ARCH_TOL * (1 + want.abs())).max())
    require(excess <= 0, f"{model.cfg.name}: ring decode against windowed forward: "
                         f"max error {float(diff.max())} over ARCH_TOL")
    return {"window": W, "prefill_tokens": W, "decode_steps": steps,
            "ring_slots_written": list(range(steps)),
            "max_abs_err": float(diff.max()),
            "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
            "tokens_checked": got.shape[0] * got.shape[1]}


def step_breakdown(model, params, lora, B: int = 8, S: int = 256):
    """Where one engine call's device time goes: a prefill-chunk call (B
    rows of S tokens from a zero state) and a decode call (one token a
    row), each under ``torch.profiler``, beside the recurrence alone at the
    same shapes (``wkv_scan`` a layer for RWKV, ``linear_scan`` a recurrent
    layer for the hybrid), warmed up and then profiled over ``reps`` calls
    (the profiler loses the kernels of a window of a few): the WKV loop is
    bound by the host's launches, so CUDA events around it would time the
    host. ``scan_share`` is layers x the scan's device busy ms a call over
    the engine call's; ``scan_launch_share`` the same for the device's
    kernel count."""
    from repro_torch.models import recurrent

    cfg, dev = model.cfg, model.device
    ids = torch.tensor([0, 1, 2, 3, -1, 0, 1, 2][:B], dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(5)
    if cfg.rwkv is not None:
        H, N = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        layers, name = cfg.num_layers, "wkv_scan"

        def scan_fn(s):
            r, k, v = (torch.randn((B, s, H, N), generator=gen, device=dev)
                       for _ in range(3))
            w = torch.rand((B, s, H, N), generator=gen, device=dev)
            wkv = torch.zeros((B, H, N, N), device=dev)
            return lambda: recurrent.wkv_scan(r, k, v, w, wkv)
    else:
        Wd = cfg.rglru.lru_width or cfg.d_model
        layers, name = model._layer_types().count("rec"), "linear_scan"

        def scan_fn(s):
            a = torch.rand((B, s + 1, Wd), generator=gen, device=dev)
            b = torch.randn((B, s + 1, Wd), generator=gen, device=dev)
            return lambda: recurrent.linear_scan(a, b)
    out = {"scan": name, "scan_layers": layers, "batch": B}
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(6))
    for kind, s in (("prefill_chunk", S), ("decode", 1)):
        cache = model.init_cache(B, ARCH_MAX_SEQ)
        if kind == "decode":
            _, cache = model.extend(params, cache, tokens, cache["len"], lora=lora,
                                    adapter_ids=ids)
        call = profiled(lambda: model.extend(params, cache, tokens[:, :s], cache["len"],
                                             lora=lora, adapter_ids=ids))
        fn = scan_fn(s)
        fn()  # warm
        reps = 1 if cfg.rwkv is not None and s > 1 else 50

        def scans():
            for _ in range(reps):
                fn()

        scan = profiled(scans)
        busy = call["device_busy_ms"]
        scan_busy = scan["device_busy_ms"] and scan["device_busy_ms"] / reps
        scan_events = scan["device_events"] / reps
        out[kind] = {
            "tokens_per_row": s, "call": call, "scan_reps": reps, "scan_busy_ms": scan_busy,
            "scan_wall_ms": scan["wall_ms"] / reps, "scan_device_events": scan_events,
            "scan_share": layers * scan_busy / busy if busy and scan_busy else None,
            "scan_launch_share": (layers * scan_events / call["device_events"]
                                  if call["device_events"] else None),
        }
        del cache
    return out


def state_arch_phase(ops, configs, EngineConfig, ServingEngine, Request, dev, name,
                     seed: int = 0):
    """One recurrent config at full width and depth: weights drawn on the
    card, a device pool of 4 adapters, the 8 running rows (one snapshot's
    blocks each, the engine's admission throttle) and :data:`STATE_SPARE`
    snapshots, and the host tier as large; :func:`state_trace` served,
    launch counts exact, state hits and swaps both ways required; then the
    static path, the ring (recurrentgemma), the step breakdown, and two
    requests teacher-forced on the CPU with the engine's weights. Returns
    (its JSON line, its launch counts)."""
    from repro_torch.kvcache import flat_state_elems
    from repro_torch.models import build_model
    from repro_torch.serving.engine import kv_pool_spec

    t_start = time.perf_counter()
    cfg = configs.get(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.float32, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    weights_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    block = kv_pool_spec(cfg, 16).block_bytes
    adapters = [f"lora-{i}" for i in range(4)]
    adapter_bytes = 4 * cfg.num_layers * cfg.lora.rank * sum(
        din + dout for din, dout in model.lora_dims().values())
    snapshot_bytes = 4 * flat_state_elems(model.init_cache(1, ARCH_MAX_SEQ))

    def blocks(n):
        return -(-n // block)

    pool = block * (len(adapters) * blocks(adapter_bytes)
                    + (8 + STATE_SPARE) * blocks(snapshot_bytes))
    ecfg = EngineConfig(hbm_bytes=pool, host_bytes=2 * pool, block_size=16,
                        max_batch_slots=8, max_seq_len=ARCH_MAX_SEQ, prefill_chunk=256,
                        step_token_budget=512)
    engine = ServingEngine(cfg, ecfg, params=params, device=dev)
    require(engine.kv_pool is None and engine.state_cache is not None,
            f"{name}: the engine has no state cache")
    require(engine.state_spec.snapshot_bytes == snapshot_bytes,
            f"{name}: snapshot of {engine.state_spec.snapshot_bytes} bytes")
    for aid in adapters:
        engine.register_adapter(aid)
    wave1, later = state_trace(Request, cfg.vocab_size, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = []
    for wave in (wave1, 2, 3):
        wave = later(wave) if isinstance(wave, int) else wave
        for r in wave:
            engine.submit(r)
        report = engine.run()
        reqs += wave
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    row = report.row()
    sc = engine.state_cache
    decode_calls, prefill_calls = engine._decode_calls, engine.prefill.stats.calls
    require(row["n_finished"] == len(reqs) and row["n_unfinished"] == 0,
            f"{name}: finished {row['n_finished']} of {len(reqs)}")
    require(row["state_hit_rate"] > 0, f"{name}: state_hit_rate is 0")
    require(sc.swap_outs > 0 and sc.swap_ins > 0,
            f"{name}: {sc.swap_outs} snapshots swapped out, {sc.swap_ins} in")
    want = expected_launches(model, launches, prefill_calls, decode_calls)
    require(launches == want, f"{name}: launches {launches}, expected {want} for "
                              f"{decode_calls} decode and {prefill_calls} prefill calls")
    generated = sum(len(r.generated) for r in reqs)
    line = {
        "phase": "state", "arch": name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "lora_targets": sorted(model.lora_dims()), "weights_bytes": weights_bytes,
        "snapshot_bytes": snapshot_bytes, "block_bytes": block,
        "snapshot_blocks": blocks(snapshot_bytes), "pool_bytes": pool,
        "setup_s": setup_s, "run_s": run_s, "requests": len(reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "generated_tokens": generated, "generated_tokens_per_s": generated / run_s,
        "avg_ttft": row["avg_ttft"], "p99_ttft": row["p99_ttft"],
        "avg_tpot": row["avg_tpot"], "p99_tpot": row["p99_tpot"],
        "state_hit_rate": row["state_hit_rate"],
        "resumed": {r.request_id: r.matched_tokens for r in reqs if r.matched_tokens},
        "snapshot_swap_outs": sc.swap_outs, "snapshot_swap_ins": sc.swap_ins,
        "swap_out_bytes": sc.swap_out_bytes, "swap_in_bytes": sc.swap_in_bytes,
        "steps": engine._step_count, "decode_calls": decode_calls,
        "prefill_calls": prefill_calls, "launches": launches,
    }
    picked = pick_resumed(engine.finished)
    if name in PROFILE_ARCHS:
        line["profile"] = profile_steps(engine, state_trace(Request, cfg.vocab_size,
                                                            seed + 1)[0], steps=20)
    line["static"] = static_path(ops, engine.model, engine.params, seed)
    lora = random_lora(engine.model, 8, seed + 1)
    if cfg.rglru is not None:
        line["ring"] = ring_wrap(engine.model, engine.params, lora, seed)
        torch.cuda.empty_cache()
    line["breakdown"] = step_breakdown(engine.model, engine.params, lora)
    line["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    # the CPU run of the engine's own weights and adapters
    t0 = time.perf_counter()
    cpu_params = tree_cpu(engine.params)
    adapter_weights = {aid: engine.adapters._host[aid].weights for aid in adapters}
    del engine, model, params, lora
    torch.cuda.empty_cache()
    total, exact, worst, min_gap = check_against_cpu(cfg, ARCH_MAX_SEQ, picked,
                                                     adapter_weights, cpu_params)
    line["cpu"] = {"requests": [r.request_id for r in picked],
                   "matched_tokens": [r.matched_tokens for r in picked],
                   "tokens": total, "argmax_equal": exact, "largest_deficit": worst,
                   "smallest_top2_gap": min_gap, "seconds": time.perf_counter() - t0}
    del cpu_params
    line["seconds"] = time.perf_counter() - t_start
    return line, {k: n + line["static"]["launches"].get(k, 0) for k, n in launches.items()}


# ------------------------------------------------------------------ encdec
def encdec_phase(ops, configs, dev, seed: int = 0, B: int = ENCDEC_B, S: int = ENCDEC_S,
                 S_src: int = ENCDEC_S_SRC, steps: int = ENCDEC_STEPS):
    """seamless-m4t-large-v2 at full width: frames (B, S_src, d_model) and
    prompts (B, S) from seeded CPU generators, ``prefill`` (encode, the
    cross K/V, the decoder through ``ragged_extend``) and ``steps`` greedy
    ``make_decode_step`` steps (``paged_attention``), launch counts reset
    just before and read just after; forward (``flash_prefill``) / prefill
    / decode identities at S = 256; then the card's tokens teacher-forced
    on the CPU with the same weights (each the CPU argmax or trailing its
    best logit by at most ARGMAX_TOL). Returns (its JSON line, launches)."""
    from repro_torch.models import build_model, make_decode_step

    t_start = time.perf_counter()
    cfg = configs.get(ENCDEC_ARCH)
    L = cfg.num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dtype=torch.float32, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    weights_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    lora = random_lora(model, 8, seed + 1)
    frames = torch.randn((B, S_src, cfg.d_model),
                         generator=torch.Generator().manual_seed(seed + 3))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(seed + 2))
    ids = torch.tensor([0, -1][:B], dtype=torch.int32)

    def run(m, p, lo, forced=None):
        """Prefill then ``steps`` decode steps: greedy, or fed ``forced``
        (B, steps + 1) and returning every step's logits."""
        step = make_decode_step(m)
        logits, cache = m.prefill(p, frames, tokens, S + steps, lora=lo, adapter_ids=ids)
        outs = [logits[:, -1]]
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        toks = [tok]
        for j in range(steps):
            if forced is None:
                tok, cache = step(p, lo, cache, {"tokens": tok[:, None], "adapter_ids": ids})
                toks.append(tok)
            else:
                lg, cache = m.decode(p, cache, forced[:, j:j + 1], lora=lo, adapter_ids=ids)
                outs.append(lg[:, -1])
        return torch.stack(toks, 1).cpu(), torch.stack(outs, 1)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_tokens, _ = run(model, params, lora)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(fused_sgmv=4 * L * (1 + steps), ragged_extend=L, paged_attention=L * steps)
    require(launches == want, f"{ENCDEC_ARCH}: launches {launches}, expected {want}")
    # forward / prefill / decode against each other at S = 256
    n = min(ENCDEC_FORWARD, S)
    full, _ = model.forward(params, frames, tokens[:, :n], lora=lora, adapter_ids=ids)
    last, cache = model.prefill(params, frames, tokens[:, :n - 1], n, lora=lora,
                                adapter_ids=ids)
    dec, _ = model.decode(params, cache, tokens[:, n - 1:n], lora=lora, adapter_ids=ids)
    errs, excess = [], -math.inf
    for got, wnt in ((last[:, 0], full[:, n - 2]), (dec[:, 0], full[:, n - 1])):
        diff = (got - wnt).abs()
        errs.append(float(diff.max()))
        excess = max(excess, float((diff - ARCH_TOL * (1 + wnt.abs())).max()))
    require(excess <= 0, f"{ENCDEC_ARCH}: forward / prefill / decode disagree on the "
                         f"card: max errors {errs} over ARCH_TOL")
    line = {"phase": "encdec", "arch": ENCDEC_ARCH, "encoder_layers": cfg.encoder_layers,
            "decoder_layers": L, "d_model": cfg.d_model,
            "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.resolved_head_dim,
            "vocab": cfg.vocab_size, "weights_bytes": weights_bytes, "batch": B,
            "frames": S_src, "prompt_tokens": S, "decode_steps": steps,
            "greedy_s": greedy_s, "launches": launches,
            "arch_identities_max_abs_err": errs, "tokens": gen_tokens.tolist(),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    cpu_params, cpu_lora = tree_cpu(params), tree_cpu(lora)
    del model, params, lora, full, cache
    torch.cuda.empty_cache()

    # the card's tokens teacher-forced on the CPU: the kernels' plain versions
    t0 = time.perf_counter()
    _, lg = run(build_model(cfg, dtype=torch.float32, device="cpu"), cpu_params, cpu_lora, forced=gen_tokens)
    picked = lg.gather(-1, gen_tokens[:, :, None].long())[..., 0]
    deficit = float((lg.max(-1).values - picked).max())
    require(deficit <= ARGMAX_TOL,
            f"{ENCDEC_ARCH}: a card token trails the CPU max logit by {deficit}")
    line["cpu"] = {"tokens": gen_tokens.numel(),
                   "argmax_equal": int((lg.argmax(-1) == gen_tokens).sum()),
                   "largest_deficit": deficit, "smallest_top2_gap": float(top2_gap(lg).min()),
                   "seconds": time.perf_counter() - t0}
    line["seconds"] = time.perf_counter() - t_start
    return line, launches


# ------------------------------------------------------------------- train
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_B, TRAIN_S = 8, 512  # 4,096 tokens a step
TRAIN_IDS = (0, 1, 2, 3, 0, 1, 2, -1)  # four adapters and a base-model row
TRAIN_STEPS, REMAT_STEPS, LORA_STEPS = 10, 4, 20
CHECK_B, CHECK_S = 2, 256  # the card-against-CPU step
TRAIN_CKPT = HERE / "build" / "repro_torch_train" / "chip_smoke"


def train_batch(cfg, step: int, dev, B: int = TRAIN_B, S: int = TRAIN_S) -> dict:
    """The step's batch from a generator on the card seeded by ``step``:
    each adapter's labels follow ``(tokens·31 + id·7 + 1) % vocab`` (the
    LoRA example's rule; the base row as id 0), so the loss can fall."""
    gen = torch.Generator(device=dev).manual_seed(1000 + step)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    ids = torch.tensor(TRAIN_IDS[:B], dtype=torch.int32, device=dev)
    labels = (tokens * 31 + ids.clamp_min(0)[:, None].long() * 7 + 1) % cfg.vocab_size
    return {"tokens": tokens, "labels": labels, "adapter_ids": ids}


def train_grads(model, params, lora, batch, lora_only: bool):
    """(cross-entropy, gradient leaves, names) of the train step's loss at
    these weights, before clipping: the trainable tree's leaves in the
    order ``repro_torch.tree`` walks them."""
    from repro_torch.models import cross_entropy
    from repro_torch.tree import flatten_with_names, unflatten

    trainable = {"lora": lora} if lora_only else {"params": params, "lora": lora}
    named = flatten_with_names(trainable)
    live = [t.detach().requires_grad_(True) for _, t in named]
    tree = unflatten(trainable, live)
    with torch.enable_grad():
        logits, aux = model.forward(params if lora_only else tree["params"], batch["tokens"],
                                    lora=tree["lora"], adapter_ids=batch["adapter_ids"])
        ce = cross_entropy(logits, batch["labels"])
        grads = torch.autograd.grad(ce + 0.01 * aux, live)
    return float(ce.detach()), [g.detach() for g in grads], [n for n, _ in named]


def train_phase(ops, configs, dev):
    """Phase 8: training on full-width qwen3-0.6b in f32, weights drawn on
    the card, rank-32 LoRA on 4 slots. Full-parameter steps (launch counts
    exact a step, also under remat), LoRA-only steps on one fixed batch
    (the loss falls, the base weights keep their bits, no dW is formed),
    one step's gradients on the card against the CPU's (plain versions),
    a checkpoint round trip, and one full step under ``torch.profiler``.
    Returns (line, launches of the full-parameter steps)."""
    from repro_torch.distributed import CheckpointManager
    from repro_torch.models import (TrainState, build_model, make_train_state,
                                    make_train_step)
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    sgmv_mod = importlib.import_module("repro_torch.kernels.sgmv")
    t_start = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH)
    L = cfg.num_layers
    model = build_model(cfg, dtype=torch.float32, device=dev)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             n_lora_slots=4)
    n_params = sum(t.numel() for t in leaves(state.params))
    line = {"phase": "train", "arch": TRAIN_ARCH, "layers": L, "batch": TRAIN_B,
            "seq": TRAIN_S, "adapter_ids": list(TRAIN_IDS), "params": n_params}
    dw_calls = [0]
    real_weight_grad = sgmv_mod.weight_grad

    def counting_weight_grad(x, dy):
        dw_calls[0] += 1
        return real_weight_grad(x, dy)

    sgmv_mod.weight_grad = counting_weight_grad
    try:
        # 1. full-parameter steps: one warm-up, then TRAIN_STEPS counted
        step_fn = make_train_step(model, lr=3e-4)
        state, _ = step_fn(state, train_batch(cfg, 0, dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        dw_calls[0] = 0
        losses = []
        t0 = time.perf_counter()
        for step in range(1, TRAIN_STEPS + 1):
            state, met = step_fn(state, train_batch(cfg, step, dev))
            losses.append(met["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        per_step = {"fused_sgmv": 4 * L, "flash_prefill": L, "flash_prefill_bwd": L,
                    "lora_grad": 4 * L}
        want = dict.fromkeys(launches, 0)
        want.update({k: n * TRAIN_STEPS for k, n in per_step.items()})
        require(launches == want, f"train launches {launches} != {want}")
        require(dw_calls[0] == 4 * L * TRAIN_STEPS,
                f"full-parameter steps formed dW {dw_calls[0]} times")
        losses = [float(x) for x in losses]
        require(all(math.isfinite(x) for x in losses), f"train losses {losses}")
        line["full"] = {"steps": TRAIN_STEPS, "seconds": wall,
                        "steps_per_s": TRAIN_STEPS / wall,
                        "tokens_per_s": TRAIN_STEPS * TRAIN_B * TRAIN_S / wall,
                        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches_per_step": {k: v // TRAIN_STEPS
                                              for k, v in launches.items()},
                        "losses": losses, "grad_norm": float(met["grad_norm"])}
        full_launches = launches

        # 2. remat: the forward's kernels run again in the backward; one
        # warm-up step (the allocator meets remat's pattern), then
        # REMAT_STEPS timed one by one
        remat_fn = make_train_step(build_model(cfg, dtype=torch.float32, device=dev, remat=True), lr=3e-4)

        def alloc_counts():  # the caching allocator's cudaMalloc, cudaFree and retries
            st = torch.cuda.memory_stats()
            return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                              "num_alloc_retries")}

        a0, t0 = alloc_counts(), time.perf_counter()
        rstate, _ = remat_fn(state, train_batch(cfg, 100, dev))
        torch.cuda.synchronize()
        warm_s, a1 = time.perf_counter() - t0, alloc_counts()
        ops.reset_launch_counts()
        rsteps = []
        for step in range(1, REMAT_STEPS + 1):
            t0 = time.perf_counter()
            rstate, _ = remat_fn(rstate, train_batch(cfg, 100 + step, dev))
            torch.cuda.synchronize()
            rsteps.append(time.perf_counter() - t0)
        rwall, a2 = sum(rsteps), alloc_counts()
        launches = ops.launch_counts()
        want = dict.fromkeys(launches, 0)
        want.update(fused_sgmv=8 * L * REMAT_STEPS, flash_prefill=2 * L * REMAT_STEPS,
                    flash_prefill_bwd=L * REMAT_STEPS, lora_grad=4 * L * REMAT_STEPS)
        require(launches == want, f"remat launches {launches} != {want}")
        line["remat"] = {"steps": REMAT_STEPS, "seconds_per_step": rwall / REMAT_STEPS,
                         "step_seconds": rsteps, "warmup_step_seconds": warm_s,
                         "allocator_warmup": {k: a1[k] - a0[k] for k in a0},
                         "allocator_timed": {k: a2[k] - a1[k] for k in a0},
                         "launches_per_step": {k: v // REMAT_STEPS
                                               for k, v in launches.items()}}
        del rstate, remat_fn

        # 3. LoRA-only steps on one fixed batch: the loss falls, the base
        # weights keep their bits, dW is never formed
        base = [t.clone() for t in leaves(state.params)]
        lstate = TrainState(params=state.params, lora=state.lora,
                            opt=adamw_init({"lora": state.lora}),
                            step=torch.zeros((), dtype=torch.int32))
        lora_fn = make_train_step(model, lr=3e-3, train_lora_only=True)
        fixed = train_batch(cfg, 200, dev)
        dw_calls[0] = 0
        ops.reset_launch_counts()
        llosses = []
        t0 = time.perf_counter()
        for _ in range(LORA_STEPS):
            lstate, met = lora_fn(lstate, fixed)
            llosses.append(met["loss"])
        torch.cuda.synchronize()
        lwall = time.perf_counter() - t0
        llosses = [float(x) for x in llosses]
        launches = ops.launch_counts()
        require(llosses[-1] < llosses[0], f"LoRA-only loss did not fall: {llosses}")
        require(all(torch.equal(a, b) for a, b in zip(leaves(lstate.params), base)),
                "LoRA-only steps changed the base weights")
        require(dw_calls[0] == 0, f"LoRA-only steps formed dW {dw_calls[0]} times")
        require(launches["lora_grad"] == 4 * L * LORA_STEPS,
                f"LoRA-only launches {launches}")
        line["lora_only"] = {"steps": LORA_STEPS, "seconds_per_step": lwall / LORA_STEPS,
                             "losses": llosses, "dw_formed": dw_calls[0],
                             "launches_per_step": {k: v // LORA_STEPS
                                                   for k, v in launches.items()}}
        del base, lstate, lora_fn
    finally:
        sgmv_mod.weight_grad = real_weight_grad

    # 4. one step's gradients at B = 2, S = 256 on the card and on the CPU
    t0 = time.perf_counter()
    check = train_batch(cfg, 300, dev, B=CHECK_B, S=CHECK_S)
    cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
    cpu_params, cpu_lora = tree_cpu(state.params), tree_cpu(state.lora)
    cpu_batch = {k: v.cpu() for k, v in check.items()}
    cmp = {}
    ce_cpu, g_cpu, names = train_grads(cpu_model, cpu_params, cpu_lora, cpu_batch, False)
    lora_ref = {n: g for n, g in zip(names, g_cpu) if n.startswith("lora/")}
    for mode in ("full", "lora_only"):
        ce, g_card, gnames = train_grads(model, state.params, state.lora, check,
                                         mode == "lora_only")
        rel_loss = abs(ce - ce_cpu) / abs(ce_cpu)
        require(rel_loss <= TRAIN_LOSS_TOL, f"train {mode}: card loss {ce} against the "
                                            f"CPU's {ce_cpu}")
        want = dict(zip(names, g_cpu)) if mode == "full" else lora_ref
        worst, worst_leaf = 0.0, None
        for n, g in zip(gnames, g_card):
            w = want[n]
            e = float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            if e > worst:
                worst, worst_leaf = e, n
        require(worst <= TRAIN_GRAD_TOL, f"train {mode}: gradient {worst_leaf} off the "
                                         f"CPU's by {worst} of its max")
        cmp[mode] = {"loss_card": ce, "loss_cpu": ce_cpu, "loss_rel_err": rel_loss,
                     "leaves": len(gnames), "largest_grad_err": worst,
                     "at_leaf": worst_leaf}
        del g_card
    del g_cpu, lora_ref, cpu_params, cpu_lora, cpu_model
    cmp["seconds"] = time.perf_counter() - t0
    line["cpu_check"] = cmp

    # 5. the checkpoint round trip of the state after the counted steps
    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    mgr = CheckpointManager(TRAIN_CKPT, keep=1)
    step_n = TRAIN_STEPS + 1
    mgr.save_async(step_n, state)
    save_call_s = time.perf_counter() - t0
    mgr.wait()
    restored = mgr.restore(mgr.latest_step(), state)
    require(all(torch.equal(a, b) and a.device == b.device
                for a, b in zip(leaves(restored), leaves(state))),
            "the restored checkpoint differs from the saved state")
    nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
    del restored
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    line["checkpoint"] = {"step": step_n, "bytes": nbytes, "save_async_call_s": save_call_s,
                          "round_trip_s": time.perf_counter() - t0, "bitwise": True}

    # 6. one full-parameter step under the profiler
    prof_batch = train_batch(cfg, 400, dev)
    out = {}

    def one_step():
        out["state"] = step_fn(state, prof_batch)[0]

    line["profile"] = profiled(one_step)
    del out
    line["seconds"] = time.perf_counter() - t_start
    return line, full_launches


# -------------------------------------------------------------------- bf16
BF16 = torch.bfloat16
# phase 9, the bf16 static path at full width and depth: (config, rows,
# prompt tokens, masked extend chunk, greedy steps, with an f32 run of the
# same weights). deepseek-v2-lite-16b holds 32.4 GB of bf16 weights (64.8
# GB in f32: no f32 run beside it). rwkv6-1.6b (24 layers), the RG-LRU
# hybrid (26) and seamless-m4t-large-v2 (24 + 24, after as many frames as
# prompt tokens, phase 7c's sizes; its extend takes no mask, so every row
# of the chunk is real) run in bf16 as the reference builds them
BF16_ARCHS = (("qwen3-0.6b", 8, 2016, 32, 32, True),
              ("llama-7b", 2, 512, 32, 8, True),
              ("deepseek-v2-lite-16b", 2, 256, 32, 8, False),
              ("rwkv6-1.6b", 2, 256, 32, 8, True),
              ("recurrentgemma-2b", 2, 512, 32, 8, True),
              (ENCDEC_ARCH, ENCDEC_B, ENCDEC_S, 32, 8, True))
# forward / prefill / decode of one bf16 model against each other: each
# compared logit row's relative L2 error at most BF16_IDENT_TOL. The calls
# round the bf16 activations at other places (other kernels, other GEMM
# shapes): 0.011-0.012 on qwen3-0.6b and llama-7b at full depth, 0.040
# (prefill) and 0.071 (decode) on deepseek-v2-lite-16b with its expert
# choices pinned (an H100 80GB HBM3 at 700 W), whose calls differ in more
# places (its expert products take the call's token count as their rows;
# its decode runs MLA in the absorbed form, the forward in the expanded). Left free, an MoE routes a token to
# other experts where a bf16 rounding moves a close choice, and the error
# jumps (0.14 and 0.31 on deepseek), so an MoE config's identities run
# with the expert choices pinned to the forward's (:class:`PinnedRouting`)
# and its free-routing errors are reported. A broken path gives rows of
# about their own norm: errors near 1.
BF16_IDENT_TOL = 0.1
# the bf16 run against the f32 run on the same weights: each prefill logit
# row within BF16_F32_TOL of its norm, and no logit further than
# BF16_F32_TOL of the largest f32 |logit| (rows 0.014 and 0.015, logits
# 0.014 and 0.016 on qwen3-0.6b and llama-7b); the greedy tokens are compared where the
# f32 top-2 gap exceeds twice that largest difference, and at least
# MIN_CLEAR_SHARE of the positions must be so compared
BF16_F32_TOL = 0.05
MIN_CLEAR_SHARE = 0.25
# families whose bf16 runs lie farther from f32 than BF16_F32_TOL through
# the plain versions too, so that the spread is bf16's own, not the
# kernels': (tolerance in place of BF16_F32_TOL, share in place of
# MIN_CLEAR_SHARE). On phase 9's weights (scripts/bf16_spread.py, an H100
# 80GB HBM3 at 700 W) rwkv6-1.6b's bf16 prefill lies 0.4916 of a row's
# norm from f32's through the kernels and 0.5056 through the plain
# versions; its network carries rounding ~1000-fold over 24 layers (f32
# through the plain versions lies 2.9e-6 from f32 through the kernels at
# the first layer, 3.1e-3 at the logits), so no position's f32 top-2 gap
# clears twice the difference (0 of 18). recurrentgemma-2b: 0.0525 and
# 0.0514 (2 of 18 positions clear). Each such family's bf16 run is also
# held, anchored, against bf16 through the plain versions: no farther
# from f32 than BF16_PLAIN_MULT times theirs plus BF16_PLAIN_FLOOR of the
# largest f32 |logit|, as tests/test_torch_bf16_families.py holds the
# reduced configs against the reference
BF16_F32_FAMILY = {"rwkv6-1.6b": (0.75, 0.0), "recurrentgemma-2b": (0.08, 0.1)}
BF16_PLAIN_MULT, BF16_PLAIN_FLOOR = 2.0, 0.005
# after the timed decode steps, this many windows of 8 steps each, timed
# on their own: the spread of ms a step within one run
DECODE_WINDOWS = 3


# fused_sgmv's tiled shapes of phase 9 beyond qwen3-0.6b's prefill, each a
# plan of its own (csrc/fused_sgmv_wgmma.cu: make_plan): (arch, projection,
# B, S, d_in, d_out). The 8 x 32 extend splits the tile loop into 4 parts
# and the shrink into 2; llama-7b's d_in = 4096 splits the shrink into 8;
# deepseek's kv_a (d_out = 576) ends in a part-filled tile and splits both
SGMV_PHASE9 = (("qwen3-0.6b extend", "q", 8, 32, 1024, 2048),
               ("llama-7b", "q", 2, 512, 4096, 4096),
               ("deepseek-v2-lite-16b", "q", 2, 256, 2048, 3072),
               ("deepseek-v2-lite-16b", "kv_a", 2, 256, 2048, 576))
# ... and the LoRA projections of phase 9's other families at their
# prefill (``wgmma``) and decode (``cluster``): (arch, projection, d_in,
# d_out), B and S from BF16_ARCHS: rwkv6-1.6b's r (k, v, o alike),
# recurrentgemma-2b's q and its k (one kv head: d_out 256), seamless's
# decoder q (k, v, o alike)
SGMV_FAMILIES = (("rwkv6-1.6b", "r", 2048, 2048), ("recurrentgemma-2b", "q", 2560, 2560),
                 ("recurrentgemma-2b", "k", 2560, 256), (ENCDEC_ARCH, "q", 1024, 1024))
# ... and more decode shapes (S = 1) of the cluster loop's rule
# (sgmv.bf16_path): (arch, projection, B, d_in, d_out). qwen3-0.6b's q at
# 16 rows, llama-7b's q and deepseek's q (24 slabs at cs = 8) take the
# cluster loop; deepseek's kv_a (a part-filled slab) stays on the skinny
# one, where it was faster
SGMV_DECODE = (("qwen3-0.6b 16 rows", "q", 16, 1024, 2048),
               ("llama-7b", "q", 2, 4096, 4096),
               ("deepseek-v2-lite-16b", "q", 2, 2048, 3072),
               ("deepseek-v2-lite-16b", "kv_a", 2, 2048, 576))
# the decode case whose device operations phase 3 counts, and that the
# kernels line reports for the cluster loop
SGMV_CLUSTER_CASE = "q 1024->2048, B=16, S=1, r=32, bf16"


def decode_path(B: int, d_in: int, d_out: int) -> str:
    """The loop sgmv.bf16_path gives a bf16 decode launch of B rows on
    16-byte bases (every phase 3 and phase 9 decode launch)."""
    sg = importlib.import_module("repro_torch.kernels.sgmv")
    return sg.bf16_path(B, d_in, d_out, (0, 0, 0, 0), BF16)


def sgmv_device_ops(ops, proj, d_in, d_out, gen, dev, B=8, calls: int = 10) -> dict:
    """The device operations (kernels, copies, memsets) of each bf16
    fused_sgmv call at S = 1, from ``torch.profiler`` over ``calls`` calls:
    per call in all and by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((B, 1, d_in), generator=gen, device=dev).to(BF16)
    w = (torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5).to(BF16)
    a = (torch.randn((8, d_in, 32), generator=gen, device=dev) * d_in ** -0.5).to(BF16)
    b = (torch.randn((8, 32, d_out), generator=gen, device=dev) * 0.1).to(BF16)
    ids = torch.tensor(([-1, 0, 1, 2, 3, 4, 5, 7] * 2)[:B], dtype=torch.int32, device=dev)
    ops.fused_sgmv(x, w, a, b, ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.fused_sgmv(x, w, a, b, ids)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    return {"case": f"{proj} {d_in}->{d_out}, B={B}, S=1, r=32, bf16", "calls": calls,
            "per_call": sum(names.values()) / calls,
            "names": {k: n / calls for k, n in names.items()}}


# ... and flash_prefill at seamless's decoder self-attention over 2 x 512
# (phase 9's bf16_identities run its forward over 2 x 256)
FLASH_FAMILIES = ((ENCDEC_ARCH, ENCDEC_B, ENCDEC_S, 16, 16, 64),)


# ragged_extend and paged_attention at phase 9's shapes (BF16_ARCHS' rows,
# prompts, ragged extend lengths and cache length, as bf16_phase sets them):
# (arch, query heads H, kv heads Hkv, head dim D). qwen3-0.6b's 8 x 32
# extend makes one q tile a (row, kv head) over 2176 keys, split in 8 KV
# parts and combined; llama-7b's 2 x 32 over 640 keys in 3; seamless's
# unmasked 2 x 32 at D = 64 (one 64-wide D chunk) over 640. Their decode's
# first step: pages of 128, 5-block clusters (seamless: G·D = 64)
ATTN_PHASE9 = (("qwen3-0.6b", 16, 8, 128), ("llama-7b", 32, 32, 128),
               (ENCDEC_ARCH, 16, 16, 64))


def phase9_max_len(S: int, chunk_len: int, steps: int) -> int:
    """A phase 9 run's cache length: room for the timed steps, the timed
    windows and the profiled steps, in whole pages of 128."""
    return -(-(S + chunk_len + steps + 8 * (DECODE_WINDOWS + 1)) // 128) * 128


def phase9_extend_lens(name: str, B: int, chunk_len: int) -> list:
    """A phase 9 extend's real tokens a row: ragged (32, 25, 18, ...), but
    the encoder-decoder's, whose extend takes no mask (every row whole)."""
    if name == ENCDEC_ARCH:
        return [chunk_len] * B
    return [chunk_len - (7 * b) % chunk_len for b in range(B)]


def phase9_attention_shapes():
    """(arch, B, prompt tokens, cache length T, extend chunk, its true_lens,
    H, Hkv, D) of each ATTN_PHASE9 config, from BF16_ARCHS as
    :func:`bf16_phase` builds its run."""
    heads = {arch: (H, Hkv, D) for arch, H, Hkv, D in ATTN_PHASE9}
    out = []
    for name, B, S, chunk_len, steps, _ in BF16_ARCHS:
        if name in heads:
            out.append((name, B, S, phase9_max_len(S, chunk_len, steps), chunk_len,
                        phase9_extend_lens(name, B, chunk_len), *heads[name]))
    return out


def bf16_kernel_cases(ops, ref, gen, dev):
    """Phase 3 in bf16: each forward kernel at the shapes of its f32 row
    (qwen3-0.6b's q/k/v/o at S = 256, 2016 and 1; sgmv at S = 2016 and 1;
    ragged_extend 8 x 256 over T = 2048; paged_attention at phase 3's and
    the engine's lengths; flash_prefill 8 x 2016 and flash_prefill_ragged
    at its ragged lengths), then ragged_extend and paged_attention at
    llama-7b (G = 1), qwen2-vl-7b (G = 7), stablelm-12b (D = 160) and
    gemma-2b (D = 256), both again at phase 9's extend and first decode
    step (``ATTN_PHASE9``), flash_prefill at the two wide heads and at
    seamless's 2 x 512 (``FLASH_FAMILIES``), and fused_sgmv at ranks 1 and
    128, at phase 9's other tiled shapes (``SGMV_PHASE9``) and at the
    recurrent families' and seamless's projections (``SGMV_FAMILIES``).
    Every launch counted. Returns {kernel: [case, ...]}."""
    out = {k: [] for k in ("fused_sgmv", "sgmv", "ragged_extend", "paged_attention",
                           "flash_prefill", "flash_prefill_ragged")}
    projections = PROJECTIONS
    before = ops.launch_counts()
    for S in (256, 2016, 1):
        for p, di, do in projections:
            out["fused_sgmv"].append(sgmv_case(ops, ref, p, di, do, S, gen, dev, dtype=BF16))
    for S in (2016, 1):
        for p, di, do in (projections[0], projections[2]):
            out["sgmv"].append(sgmv_case(ops, ref, p, di, do, S, gen, dev, base=False,
                                         dtype=BF16))
    for r in (1, 128):
        for S in (256, 1):
            m = sgmv_case(ops, ref, "q", 1024, 2048, S, gen, dev, r=r, dtype=BF16)
            out["fused_sgmv"].append({"arch": "qwen3-0.6b", **m})
    for arch, proj, B, S, d_in, d_out in SGMV_PHASE9:
        m = sgmv_case(ops, ref, proj, d_in, d_out, S, gen, dev, B=B, dtype=BF16)
        out["fused_sgmv"].append({"arch": arch, **m})
    rows = {name: (B, S) for name, B, S, _, _, _ in BF16_ARCHS}
    for arch, proj, d_in, d_out in SGMV_FAMILIES:
        B, S = rows[arch]
        for s in (S, 1):
            m = sgmv_case(ops, ref, proj, d_in, d_out, s, gen, dev, B=B, dtype=BF16)
            out["fused_sgmv"].append({"arch": f"{arch} phase 9", **m})
    # the cluster loop at its most rows and at llama-7b's and deepseek's q,
    # and deepseek's kv_a decode (a part-filled slab)
    for arch, proj, B, d_in, d_out in SGMV_DECODE:
        m = sgmv_case(ops, ref, proj, d_in, d_out, 1, gen, dev, B=B, dtype=BF16)
        out["fused_sgmv"].append({"arch": arch, **m})
    # a decode call on the cluster loop is one kernel: no second pass, no
    # copy or memset beside it
    q1 = next(c for c in out["fused_sgmv"] if c["case"] == SGMV_CLUSTER_CASE)
    q1["device_ops"] = sgmv_device_ops(ops, "q", 1024, 2048, gen, dev, B=16)
    require(q1["device_ops"]["per_call"] == 1
            and all("fused_sgmv_cluster" in k for k in q1["device_ops"]["names"]),
            f"bf16 fused_sgmv {q1['case']}: device operations a call "
            f"{q1['device_ops']}, not one cluster kernel")
    torch.cuda.empty_cache()
    out["ragged_extend"].append(ragged_case(ops, ref, gen, dev, 256, *RAGGED_BUCKETS[256],
                                            dtype=BF16))
    for k in ("table", "engine"):
        out["paged_attention"].append(paged_case(ops, ref, gen, dev, PAGED_LENGTHS[k],
                                                 dtype=BF16))
    for arch, H, Hkv, D in ARCH_HEADS[:4]:
        m = ragged_case(ops, ref, gen, dev, 256, *RAGGED_BUCKETS[256], H=H, Hkv=Hkv, D=D,
                        dtype=BF16)
        out["ragged_extend"].append({"arch": arch, **m})
        m = paged_case(ops, ref, gen, dev, PAGED_LENGTHS["engine"], H=H, Hkv=Hkv, D=D,
                       dtype=BF16)
        out["paged_attention"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
    for arch, B, S0, T, chunk_len, lens, H, Hkv, D in phase9_attention_shapes():
        m = ragged_case(ops, ref, gen, dev, chunk_len, lens, [S0] * B, B=B, T=T, H=H,
                        Hkv=Hkv, D=D, dtype=BF16)
        out["ragged_extend"].append({"arch": f"{arch} phase 9 extend", **m})
        m = paged_case(ops, ref, gen, dev, [S0 + n + 1 for n in lens], B=B, T=T, H=H,
                       Hkv=Hkv, D=D, dtype=BF16)
        out["paged_attention"].append({"arch": f"{arch} phase 9 decode", **m})
    out["flash_prefill"].append(flash_case(ops, ref, gen, dev, dtype=BF16))
    torch.cuda.empty_cache()
    out["flash_prefill_ragged"].append(flash_case(
        ops, ref, gen, dev, lens=[0, 1, 37, 1000, 2015, 2016, 2016, 2016], dtype=BF16))
    torch.cuda.empty_cache()
    for arch, B, S, H, Hkv, D in ARCH_FLASH[:2] + FLASH_FAMILIES:
        m = flash_case(ops, ref, gen, dev, B=B, S=S, H=H, Hkv=Hkv, D=D, dtype=BF16)
        out["flash_prefill"].append({"arch": arch, **m})
        torch.cuda.empty_cache()
    after = ops.launch_counts()
    require(all(after[k] > before[k] for k in out),
            f"a kernel never launched in bf16: {before} -> {after}")
    # fused_sgmv: every tiled case on csrc/fused_sgmv_wgmma.cu's loop, every
    # decode case (S = 1) on the loop the rule gives it: csrc/
    # fused_sgmv_cluster.cu's or fused_sgmv.cu's skinny one (sgmv.bf16_path)
    for c in out["fused_sgmv"]:
        B, S, d_in, d_out = c["shape"]
        want = decode_path(B, d_in, d_out) if S == 1 else "wgmma"
        require(c["path"] == want, f"bf16 fused_sgmv {c['case']} ran the {c['path']} loop")
    # qwen3-0.6b, stablelm-12b (D = 160), gemma-2b (D = 256) and the ragged
    # case run csrc/attention_wgmma.cuh's loop (flash_prefill.bf16_path), and
    # so does every ragged_extend case (ragged_extend_wgmma.cu,
    # ragged_extend.bf16_path), qwen3-0.6b's phase 9 extend split in 8 KV
    # parts (the most); paged_attention runs paged_attention.cu's split loop
    # at qwen3-0.6b, llama-7b and seamless (G·D 256, 128, 64) and the chunk loop at
    # qwen2-vl-7b, stablelm-12b and gemma-2b (G·D 896, 640, 2048: past
    # paged_attention.SPLIT_MAX_GD, where the chunk loop is faster)
    for k in ("flash_prefill", "flash_prefill_ragged", "ragged_extend"):
        for c in out[k]:
            require(c["path"] == "wgmma", f"bf16 {k} {c['case']} ran the {c['path']} loop")
    extend9 = next(c for c in out["ragged_extend"]
                   if c.get("arch") == "qwen3-0.6b phase 9 extend")
    require(extend9["kv_parts"] == 8, f"bf16 ragged_extend {extend9['case']}: "
                                      f"{extend9['kv_parts']} KV parts, not 8")
    chunk_archs = ("qwen2-vl-7b", "stablelm-12b", "gemma-2b")
    for c in out["paged_attention"]:
        want = "chunk" if c.get("arch") in chunk_archs else "split"
        require(c["path"] == want, f"bf16 paged_attention {c['case']} ran the "
                                   f"{c['path']} loop, not {want}")
    return out


# the attention kernels' log-sum-exp output (``return_lse``), which the
# sharded decode merges over the model axis where the cache is sharded in
# time: phase 11's time shard, gemma-2b's heads (8 on one kv head, D = 256)
# over T = 160 slots (320 positions over two ranks) in pages of 32, with
# rows whose local count is 0 (a rank whose slots all lie past the row's
# last position), a row that fills the shard and rows in between; the
# multi-token case shifts its queries as ``attention.gqa_cached`` does
LSE_SHARD = dict(B=4, T=160, H=8, Hkv=1, D=256, page=32)
LSE_SHARD_LENGTHS = [0, 1, 97, 160]  # paged_attention's local counts
LSE_SHARD_RAGGED = ([0, 1, 3, 4], [0, 0, 40, 157])  # (true_lens, starts), S = 4


def lse_check(what: str, got_lse, want_lse) -> float:
    """``got_lse`` against the plain version's: -inf exactly where it is
    -inf, and elsewhere within ATTN_TOL · max(1, |lse|)."""
    empty = torch.isneginf(want_lse)
    require(torch.equal(torch.isneginf(got_lse), empty),
            f"{what}: lse is -inf at other places than the plain version's")
    g, w = got_lse[~empty], want_lse[~empty]
    err = float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) if w.numel() else 0.0
    require(err <= ATTN_TOL, f"{what}: lse off by {err} (relative) > {ATTN_TOL}")
    return err


def lse_kernel_cases(ops, ref, gen, dev) -> list:
    """paged_attention and ragged_extend with ``return_lse`` against their
    plain versions, in every loop and both dtypes: phase 3's lengths
    (ragged: the 256-token bucket over T = 2048; paged: the table's
    lengths, an empty row among them), phase 9's shapes (qwen3-0.6b's 8 x 32
    extend over 2176 keys, split in KV parts and combined; its first decode
    step), and phase 11's time shard (``LSE_SHARD``: rows of local count 0),
    the bf16 ragged_extend also at D = 20 (the ``mma`` loop) and the bf16
    paged_attention also at gemma-2b's heads (the ``chunk`` loop). Each
    case: the output within ATTN_TOL (bf16: BF16_TOL and one bf16 rounding
    of the f32 plain value), lse by :func:`lse_check`, the output bitwise
    that of the same launch without the flag, and both timed. Run before
    any path's counts are reset."""
    cases = []
    (_, B9, S9, T9, chunk9, lens9, H9, Hkv9, _), = [
        a for a in phase9_attention_shapes() if a[0] == "qwen3-0.6b"]
    sh = LSE_SHARD
    rag_shapes = [("phase 3", 256, *RAGGED_BUCKETS[256], 8, 2048, 16, 8, 128),
                  ("phase 9 extend", chunk9, lens9, [S9] * B9, B9, T9, H9, Hkv9, 128),
                  ("phase 11 time shard", 4, *LSE_SHARD_RAGGED, sh["B"], sh["T"], sh["H"],
                   sh["Hkv"], sh["D"]),
                  ("D = 20", 64, *RAGGED_BUCKETS[64], 8, 512, 8, 2, 20)]
    pag_shapes = [("phase 3", PAGED_LENGTHS["table"], 8, 2048, 16, 8, 128, 128),
                  ("phase 9 decode", [S9 + n + 1 for n in lens9], B9, T9, H9, Hkv9, 128, 128),
                  ("phase 11 time shard", LSE_SHARD_LENGTHS, sh["B"], sh["T"], sh["H"],
                   sh["Hkv"], sh["D"], sh["page"]),
                  ("gemma-2b heads", PAGED_LENGTHS["table"], 8, 2048, 8, 1, 256, 128)]
    for dtype in (torch.float32, BF16):
        for name, S, lens, starts, B, T, H, Hkv, D in rag_shapes:
            if D == 20 and dtype == torch.float32:
                continue  # f32 takes the mma loop at every shape above
            q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
            tl = torch.tensor(lens, dtype=torch.int32, device=dev)
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            paths = ops.path_launch_counts()["ragged_extend"]
            n0 = ops.launch_counts()["ragged_extend"]
            got, got_lse = ops.ragged_extend(q, k, v, st, tl, return_lse=True)
            path = next(p for p, n in ops.path_launch_counts()["ragged_extend"].items()
                        if n > paths[p])
            plain = ops.ragged_extend(q, k, v, st, tl)
            require(ops.launch_counts()["ragged_extend"] == n0 + 2,
                    f"ragged_extend lse {name}: not one launch a call")
            want, want_lse = ref.ragged_extend_ref(q, k, v, st, tl, return_lse=True)
            want32 = (ref.ragged_extend_ref(*up(q, k, v), st, tl) if dtype != torch.float32
                      else None)
            torch.cuda.synchronize()
            what = f"ragged_extend lse {name} {dtype}"
            errs = check_out(what, got, want, want32, dtype, ATTN_TOL)
            require(torch.equal(got, plain), f"{what}: the output differs without the flag")
            es = esize(dtype)
            bnd, by = bound_ms(*work("ragged_extend", B=B, S=S, H=H, Hkv=Hkv, D=D,
                                     starts=starts, true_lens=lens, itemsize=es, lse=True),
                               dtype)
            cases.append({"kernel": "ragged_extend", "case": name, "path": path,
                          "shape": f"B={B}, S={S}, T={T}, {H}/{Hkv} heads, D={D}, "
                                   f"true_lens={lens}, starts={starts}",
                          "dtype": str(dtype), **errs,
                          "lse_rel_err": lse_check(what, got_lse, want_lse),
                          "empty_rows": int(torch.isneginf(want_lse).sum()),
                          "ms": time_ms(lambda: ops.ragged_extend(q, k, v, st, tl,
                                                                  return_lse=True))[0],
                          "ms_without_lse": time_ms(lambda: ops.ragged_extend(q, k, v, st,
                                                                              tl))[0],
                          "plain_ms": time_ms(lambda: ref.ragged_extend_ref(
                              q, k, v, st, tl, return_lse=True), **PLAIN)[0],
                          "bound_ms": bnd, "bound_by": by})
            del q, k, v
        for name, lens, B, T, H, Hkv, D, ps in pag_shapes:
            pages = T // ps
            q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
            kp = torch.randn((B * pages, ps, Hkv, D), generator=gen, device=dev).to(dtype)
            vp = torch.randn((B * pages, ps, Hkv, D), generator=gen, device=dev).to(dtype)
            tables = torch.arange(B * pages, dtype=torch.int32, device=dev).view(B, pages)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            paths = ops.path_launch_counts()["paged_attention"]
            n0 = ops.launch_counts()["paged_attention"]
            got, got_lse = ops.paged_attention(q, kp, vp, tables, ln, return_lse=True)
            path = next(p for p, n in ops.path_launch_counts()["paged_attention"].items()
                        if n > paths[p])
            plain = ops.paged_attention(q, kp, vp, tables, ln)
            require(ops.launch_counts()["paged_attention"] == n0 + 2,
                    f"paged_attention lse {name}: not one launch a call")
            want, want_lse = ref.paged_attention_ref(q, kp, vp, tables, ln, return_lse=True)
            want32 = (ref.paged_attention_ref(*up(q, kp, vp), tables, ln)
                      if dtype != torch.float32 else None)
            torch.cuda.synchronize()
            what = f"paged_attention lse {name} {dtype}"
            errs = check_out(what, got, want, want32, dtype, ATTN_TOL)
            require(torch.equal(got, plain), f"{what}: the output differs without the flag")
            for b, n in enumerate(lens):
                if n == 0:
                    require(bool((got[b] == 0).all()), f"{what}: a row of length 0 is not 0")
            es = esize(dtype)
            bnd, by = bound_ms(*work("paged_attention", B=B, H=H, Hkv=Hkv, D=D, T=T,
                                     page_size=ps, lengths=lens, itemsize=es, lse=True),
                               dtype)
            cases.append({"kernel": "paged_attention", "case": name, "path": path,
                          "shape": f"B={B}, T={T}, page={ps}, {H}/{Hkv} heads, D={D}, "
                                   f"lengths={lens}",
                          "dtype": str(dtype), **errs,
                          "lse_rel_err": lse_check(what, got_lse, want_lse),
                          "empty_rows": int(torch.isneginf(want_lse).sum()),
                          "ms": time_ms(lambda: ops.paged_attention(
                              q, kp, vp, tables, ln, return_lse=True))[0],
                          "ms_without_lse": time_ms(lambda: ops.paged_attention(
                              q, kp, vp, tables, ln))[0],
                          "plain_ms": time_ms(lambda: ref.paged_attention_ref(
                              q, kp, vp, tables, ln, return_lse=True), **PLAIN)[0],
                          "bound_ms": bnd, "bound_by": by})
            del q, kp, vp
        torch.cuda.empty_cache()
    # every loop ran with the flag, and rows of local count 0 were met
    loops = {(c["kernel"], c["path"]) for c in cases}
    want_loops = {("ragged_extend", "mma"), ("ragged_extend", "wgmma"),
                  ("paged_attention", "chunk"), ("paged_attention", "split")}
    require(want_loops <= loops, f"lse cases ran the loops {sorted(loops)}")
    require(all(c["empty_rows"] > 0 for c in cases if c["case"] == "phase 11 time shard"),
            "the time shard's lse cases have no row of local count 0")
    require(any(c["kernel"] == "ragged_extend" and c["dtype"] == str(BF16)
                and c["path"] == "mma" for c in cases), "bf16 ragged_extend's mma loop "
                                                        "never ran with the flag")
    return cases


def cast_tree(tree, dtype):
    """The float leaves of ``tree`` in ``dtype``, but the MoE router, which
    the reference keeps in f32 in a bf16 model."""
    if isinstance(tree, dict):
        return {k: v if k == "router" else cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def rel_l2(got, want):
    """Each row's (last dim's) |got − want| / |want|, in f32."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)


class PinnedRouting:
    """The MoE router's expert choices of one call replayed in later calls
    on the same rows (``repro_torch.models.ffn.route`` wrapped while in
    use). ``record(B)`` before a call over B rows keeps each MoE layer's
    (B, S, k) choices; ``replay(B, start)`` before a call over positions
    ``start``.. of those rows takes each layer's choices from there, with
    the call's own router softmax at those experts as gates, renormalised.
    A replayed call thus differs from the recorded one only by rounding."""

    def __init__(self):
        self.choices, self.mode, self.B, self.start, self.layer = [], "record", 1, 0, 0

    def __enter__(self):
        from repro_torch.models import ffn

        self._ffn, self._route = ffn, ffn.route
        ffn.route = self.route
        return self

    def __exit__(self, *exc):
        self._ffn.route = self._route

    def record(self, B: int) -> None:
        self.choices, self.mode, self.B, self.layer = [], "record", B, 0

    def replay(self, B: int, start: int) -> None:
        self.mode, self.B, self.start, self.layer = "replay", B, start, 0

    def route(self, router, xt, k):
        probs, gates, experts = self._route(router, xt, k)
        if self.mode == "record":
            self.choices.append(experts.reshape(self.B, -1, k))
        else:
            S = xt.shape[0] // self.B
            experts = self.choices[self.layer][:, self.start:self.start + S].reshape(-1, k)
            require(experts.shape[0] == xt.shape[0], "pinned routing: the call's rows "
                                                     "are not the recorded ones")
            gates = probs.gather(-1, experts)
            gates = gates / gates.sum(-1, keepdim=True)
        self.layer += 1
        return probs, gates, experts


class PlainKernels:
    """While in use, the kernel wrappers the models call
    (``repro_torch.kernels.ops``) are their plain versions, on whatever
    device the tensors lie; no launch is counted."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self.ops, self.saved = ops, {}
        plain = {
            "fused_sgmv": lambda x, w, a, b, ids, *, scale=1.0:
                ref.fused_sgmv_ref(x, w, a, b, ids, scale),
            "ragged_extend": ref.ragged_extend_ref,
            "paged_attention": ref.paged_attention_ref,
            "flash_prefill": ref.flash_prefill_ref,
        }
        for name, fn in plain.items():
            self.saved[name] = getattr(ops, name)
            setattr(ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def bf16_identities(model, params, lora, tokens, ids, frames=None) -> dict:
    """forward / prefill / decode of a bf16 model against each other (an
    encoder-decoder's after ``frames``), each row within BF16_IDENT_TOL
    relative L2 and the greedy token equal wherever the forward's top-2 gap
    exceeds twice the row's largest difference; raises if either fails. An
    MoE config runs with its expert choices pinned to the forward's, and
    its free-routing errors are reported beside. Returns the errors."""
    out = {"bound": BF16_IDENT_TOL}
    if model.cfg.moe is None:
        pairs = identity_logits(model, params, lora, tokens, ids, frames=frames)
    else:
        with PinnedRouting() as pin:
            pairs = identity_logits(model, params, lora, tokens, ids, pin)
        out["routing"] = "pinned to the forward's"
        free = identity_logits(model, params, lora, tokens, ids)
        out["free_routing_max_rel_l2"] = {
            what: float(rel_l2(*pair).max()) for what, pair in zip(("prefill", "decode"), free)}
    for what, (got, want) in zip(("prefill", "decode"), pairs):
        got, want = got.float(), want.float()
        rel = rel_l2(got, want)
        diff = (got - want).abs().amax(-1)
        clear = top2_gap(want) > 2 * diff
        same = got.argmax(-1) == want.argmax(-1)
        out[what] = {"max_abs_err": float(diff.max()), "max_rel_l2": float(rel.max()),
                     "clear_rows": int(clear.sum()), "argmax_equal": int((same & clear).sum())}
        require(float(rel.max()) <= BF16_IDENT_TOL and bool(same[clear].all()),
                f"{model.cfg.name} bf16 {what} against forward: {out}")
    return out


def decode_windows(model, params, lora, cache, tok, ids, windows: int = DECODE_WINDOWS,
                   steps: int = 8) -> list:
    """``windows`` runs of ``steps`` greedy decode steps from ``cache`` after
    token ``tok`` (B,), each timed on its own (synchronised). Returns the
    ms a step of each window, the cache and the last token."""
    tok = tok.to(model.device)
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = model.decode(params, cache, tok[:, None], lora=lora, adapter_ids=ids)
            tok = lg[:, -1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / steps * 1e3)
    return out, cache, tok


def static_run(ops, model, params, lora, tokens, chunk, lens, ids, max_len, steps,
               feed=None, frames=None):
    """The static path once: ``prefill`` of ``tokens`` (an
    encoder-decoder's after ``frames``), one ``extend`` of ``chunk`` with
    token mask ``lens`` (rows left ragged; with ``frames``, unmasked, as the
    encoder-decoder's extend takes no mask: ``lens`` must be whole rows),
    then ``steps`` decode steps, greedy or fed the tokens ``feed`` (B,
    steps), launch counts reset just before and read just after. Returns
    the prefill's last logits, each later call's logits at each row's last
    real position (on the card), the tokens fed, the seconds of each part
    (synchronised) and the launches."""
    B, S = tokens.shape
    start = torch.full((B,), S, dtype=torch.int32)
    last = (lens.long() - 1).clamp(min=0)[:, None]
    src = ()
    extend_kw = dict(true_lens=lens, logit_positions=last)
    if frames is not None:
        require(bool((lens == chunk.shape[1]).all()), "an unmasked extend takes whole rows")
        src, extend_kw = (frames,), {}
    if feed is not None:  # on the card before the clock: a host copy a step would sync
        feed = feed.to(model.device)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plog, cache = model.prefill(params, *src, tokens, max_len, lora=lora, adapter_ids=ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    elog, cache = model.extend(params, cache, chunk, start, lora=lora, adapter_ids=ids,
                               **extend_kw)
    tok = elog[:, -1].argmax(-1).to(torch.int32) if feed is None else feed[:, 0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    before_decode = dict(launches=ops.launch_counts(), paths=ops.path_launch_counts())
    logits, fed = [elog[:, -1]], [tok]
    for i in range(steps):
        lg, cache = model.decode(params, cache, tok[:, None], lora=lora, adapter_ids=ids)
        logits.append(lg[:, -1])
        if i + 1 < steps:
            tok = lg[:, -1].argmax(-1).to(torch.int32) if feed is None else feed[:, i + 1]
            fed.append(tok)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return dict(prefill_logits=plog[:, -1], logits=logits, fed=torch.stack(fed, 1).cpu(),
                prefill_s=t1 - t0, extend_s=t2 - t1, decode_s=t3 - t2,
                launches=ops.launch_counts(), paths=ops.path_launch_counts(),
                before_decode=before_decode, cache=cache)


def bf16_phase(ops, configs, dev, name, B, S, chunk_len, steps, with_f32, seed: int = 0):
    """Phase 9, one config at full width and depth in bf16: weights drawn on
    the card (in f32 and carried to bf16 where the f32 run goes beside it),
    8 LoRA slots with a row of id -1, :func:`static_run` (once to warm up,
    then timed) with exact launch counts, :func:`decode_windows`, 8 more
    decode steps under ``torch.profiler`` (the device's busy share), and
    :func:`bf16_identities` at B = 2. With ``with_f32`` the same path runs
    in f32 on the same weights first; the bf16 run is fed the f32 run's
    tokens, its prefill logits must lie within BF16_F32_TOL of f32's, and
    its greedy choice must equal the f32 one at every position where the
    f32 top-2 gap exceeds twice the largest bf16-against-f32 prefill logit
    difference, which must be MIN_CLEAR_SHARE of the positions at least (a
    family of BF16_F32_FAMILY: its own tolerance and share, and its bf16
    prefill within BF16_PLAIN_MULT times the distance from f32 of a bf16
    prefill through the plain versions, plus BF16_PLAIN_FLOOR). An
    encoder-decoder's prefill and identities take frames (as many as its
    prompt tokens) and its extend is unmasked. Returns (its JSON line, the
    bf16 run's launches)."""
    from repro_torch.models import build_model

    cfg = configs.get(name)
    L = cfg.num_layers
    max_len = phase9_max_len(S, chunk_len, steps)
    gen = torch.Generator().manual_seed(seed + 2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    chunk = torch.randint(0, cfg.vocab_size, (B, chunk_len), generator=gen)
    lens = torch.tensor(phase9_extend_lens(name, B, chunk_len), dtype=torch.int32)
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 6, -1][:B - 1] + [-1], dtype=torch.int32)
    line = {"phase": "bf16", "arch": name, "layers": L, "batch": B, "prompt_tokens": S,
            "extend_chunk": chunk_len, "extend_true_lens": lens.tolist(),
            "decode_steps": steps, "adapter_ids": ids.tolist(), "max_len": max_len}
    frames = None  # an encoder-decoder's: as many frames as prompt tokens, on the card
    if cfg.is_encdec:
        frames = torch.randn((B, S, cfg.d_model),
                             generator=torch.Generator().manual_seed(seed + 3)).to(dev)
        line.update(encoder_layers=cfg.encoder_layers, frames=S)
    torch.cuda.empty_cache()
    f32 = None
    torch.cuda.reset_peak_memory_stats()
    if with_f32:
        m32 = build_model(cfg, dtype=torch.float32, device=dev)
        p32 = m32.init_params(torch.Generator(device=dev).manual_seed(seed))
        lora32 = random_lora(m32, 8, seed + 1)
        args = (tokens, chunk, lens, ids, max_len, steps)
        static_run(ops, m32, p32, lora32, *args, frames=frames)  # warm-up: the timed run
        torch.cuda.reset_peak_memory_stats()  # finds every library kernel loaded
        f32 = static_run(ops, m32, p32, lora32, *args, frames=frames)
        peak32 = torch.cuda.max_memory_allocated() / 1e9
        windows = decode_windows(m32, p32, lora32, f32.pop("cache"), f32["fed"][:, -1],
                                 ids)[0]
        line["f32"] = {"prefill_s": f32["prefill_s"], "extend_s": f32["extend_s"],
                       "decode_ms_per_step": f32["decode_s"] / steps * 1e3,
                       "decode_ms_per_step_windows": windows, "peak_gb": peak32,
                       "weights_gb": sum(t.numel() * 4 for t in tree_leaves(p32)) / 1e9}
        model = build_model(cfg, device=dev)  # bf16, the default
        params, lora = cast_tree(p32, BF16), cast_tree(lora32, BF16)
        del m32, p32, lora32
    else:
        model = build_model(cfg, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
        lora = random_lora(model, 8, seed + 1)
    require(model.dtype == BF16, f"{name}: build_model's default dtype is {model.dtype}")
    torch.cuda.empty_cache()
    feed = None if f32 is None else f32["fed"]
    args = (tokens, chunk, lens, ids, max_len, steps, feed, frames)
    static_run(ops, model, params, lora, *args)
    torch.cuda.reset_peak_memory_stats()
    run = static_run(ops, model, params, lora, *args)
    launches = run["launches"]
    want = expected_launches(model, launches, 1, steps, fresh_prefills=1)
    require(launches == want, f"{name} bf16 launches {launches}, expected {want}")
    # every bf16 prefill attention on the wgmma loop (gqa_full's transposed views)
    paths = run["paths"]["flash_prefill"]
    require(paths["wgmma"] == launches["flash_prefill"],
            f"{name} bf16: flash_prefill launches by loop {paths}, not all wgmma")
    line["flash_prefill_paths"] = paths
    # every fused_sgmv launch of the prefill and the extend on the wgmma
    # loop, every decode launch on the loop the rule gives its projection
    # (sgmv.bf16_path: each LoRA target the same count of launches); the
    # f32 run's decode launches on the skinny one
    pre = run["before_decode"]["paths"]["fused_sgmv"]
    n_pre = run["before_decode"]["launches"]["fused_sgmv"]
    dec = {p: n - pre[p] for p, n in run["paths"]["fused_sgmv"].items()}
    n_dec = launches["fused_sgmv"] - n_pre
    dims = model.lora_dims()
    n_cluster = n_dec * sum(decode_path(B, *dims[t]) == "cluster" for t in dims) // len(dims)
    require(pre == {"wgmma": n_pre, "mma": 0, "skinny": 0, "cluster": 0}
            and dec == {"wgmma": 0, "mma": 0, "skinny": n_dec - n_cluster, "cluster": n_cluster},
            f"{name} bf16: fused_sgmv launches by loop {pre} (prefill, extend), {dec} "
            f"(decode), not all wgmma, then {n_cluster} cluster and the rest skinny")
    line["fused_sgmv_paths"] = {"prefill_extend": pre, "decode": dec}
    if f32 is not None:
        pre32 = f32["before_decode"]["paths"]["fused_sgmv"]
        dec32 = {p: n - pre32[p] for p, n in f32["paths"]["fused_sgmv"].items()}
        n_dec32 = f32["launches"]["fused_sgmv"] - f32["before_decode"]["launches"]["fused_sgmv"]
        require(n_dec32 > 0 and dec32 == {"wgmma": 0, "mma": 0, "skinny": n_dec32, "cluster": 0},
                f"{name} f32: fused_sgmv decode launches by loop {dec32}, not all skinny")
        line["fused_sgmv_paths_f32"] = {"prefill_extend": pre32, "decode": dec32}
    # every extend attention on ragged_extend_wgmma.cu, every decode
    # attention on paged_attention.cu's split loop (MLA calls neither)
    att = {k: run["paths"][k] for k in ("ragged_extend", "paged_attention")}
    require(att["ragged_extend"] == {"wgmma": launches["ragged_extend"], "mma": 0}
            and att["paged_attention"] == {"split": launches["paged_attention"], "chunk": 0},
            f"{name} bf16: attention launches by loop {att}, not all wgmma and split")
    line["attention_paths"] = att
    line["paths"] = run["paths"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    cache = run.pop("cache")
    windows, cache, tok = decode_windows(model, params, lora, cache, run["fed"][:, -1], ids)

    def decode8():
        nonlocal tok, cache
        for _ in range(8):
            lg, cache = model.decode(params, cache, tok[:, None], lora=lora, adapter_ids=ids)
            tok = lg[:, -1].argmax(-1).to(torch.int32)

    prof = profiled(decode8)
    del cache
    for lg in [run["prefill_logits"]] + run["logits"]:
        require(bool(torch.isfinite(lg).all()), f"{name} bf16: logits not finite")
    line.update({
        "prefill_s": run["prefill_s"], "prefill_tokens_per_s": B * S / run["prefill_s"],
        "extend_s": run["extend_s"], "decode_ms_per_step": run["decode_s"] / steps * 1e3,
        "decode_ms_per_step_windows": windows, "peak_gb": peak, "weights_gb": sum(
            t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9,
        "launches": launches, "profile_decode_8_steps": prof,
        "decode_device_busy_share": prof["device_busy_share"]})
    if f32 is not None:
        tol, min_share = BF16_F32_FAMILY.get(name, (BF16_F32_TOL, MIN_CLEAR_SHARE))
        rel = float(rel_l2(run["prefill_logits"], f32["prefill_logits"]).max())
        d = float((run["prefill_logits"].float() - f32["prefill_logits"]).abs().max())
        top = float(f32["prefill_logits"].abs().max())
        require(rel <= tol and d <= tol * top,
                f"{name}: bf16 prefill logits off f32's by {rel} of a row's norm, "
                f"{d} of max {top} (limit {tol} of each)")
        if name in BF16_F32_FAMILY:  # anchored on bf16 through the plain versions
            with PlainKernels():
                plain = model.prefill(params, *(() if frames is None else (frames,)),
                                      tokens, max_len, lora=lora, adapter_ids=ids)[0][:, -1]
            p_rel = float(rel_l2(plain, f32["prefill_logits"]).max())
            p_d = float((plain.float() - f32["prefill_logits"]).abs().max())
            require(rel <= BF16_PLAIN_MULT * p_rel + BF16_PLAIN_FLOOR
                    and d <= BF16_PLAIN_MULT * p_d + BF16_PLAIN_FLOOR * top,
                    f"{name}: bf16 prefill logits off f32's by {rel} of a row's norm and "
                    f"{d}, through the plain versions by {p_rel} and {p_d}")
            line["plain_against_f32"] = {"prefill_logit_max_rel_l2": p_rel,
                                         "prefill_logit_max_abs_diff": p_d}
            del plain
        checked = equal = 0
        for got, want in zip(run["logits"], f32["logits"]):
            clear = top2_gap(want) > 2 * d
            same = got.float().argmax(-1) == want.argmax(-1)
            checked += int(clear.sum())
            equal += int((same & clear).sum())
        positions = len(run["logits"]) * B
        require(equal == checked, f"{name}: bf16 greedy tokens differ from f32 at "
                                  f"{checked - equal} of {checked} clear positions")
        require(checked >= min_share * positions,
                f"{name}: only {checked} of {positions} positions clear of 2 x {d}")
        line["against_f32"] = {
            "prefill_logit_max_rel_l2": rel, "prefill_logit_max_abs_diff": d,
            "prefill_logit_max_abs_f32": top, "tolerance": tol, "positions": positions,
            "clear_positions": checked, "argmax_equal": equal}
    line["identities"] = bf16_identities(no_drop_model(model), params, lora,
                                         tokens[:2, :256], ids[:2],
                                         None if frames is None else frames[:2])
    if cfg.moe is not None:
        line["identities_capacity_factor"] = float(cfg.moe.num_experts)
    del model, params, lora, run, f32
    torch.cuda.empty_cache()
    return line, launches


# -------------------------------------------------------------- 10. link
LINK_BLOCKS = (1, 8, 64)  # KV blocks a swap call moves
LINK_RANKS = (8, 32, 128)  # adapter ranks a load moves (32: the configs' rank)
LINK_ITERS = 10  # timed round trips of each size (their medians are kept)


def event_ms(fn) -> tuple[float, float, float]:
    """(device ms, enqueue ms, wall ms) of one call of ``fn`` on an idle
    stream: CUDA events around it, the host's clock until ``fn`` returns,
    and until its work has finished."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    e0.record()
    fn()
    h1 = time.perf_counter()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), (h1 - h0) * 1e3, (time.perf_counter() - h0) * 1e3


def fit_link(points) -> dict:
    """Least squares ``ms = latency + bytes / rate`` over (bytes, device
    ms) points: the rate in GB/s and the fixed cost in µs."""
    n = len(points)
    mx = sum(b for b, _ in points) / n
    my = sum(t for _, t in points) / n
    slope = (sum((b - mx) * (t - my) for b, t in points)
             / sum((b - mx) ** 2 for b, _ in points))  # ms a byte
    return {"gb_per_s": 1e-6 / slope, "latency_us": (my - slope * mx) * 1e3}


def link_timings(sizes) -> dict:
    """{name: {"points": [...], fit}} from {name: [(bytes, [(device ms,
    enqueue ms, wall ms), ...]), ...]}: each size's median times and
    GB/s, and the fit over the sizes' device medians."""
    out = {}
    for name, rows in sizes.items():
        points = []
        for nbytes, times in rows:
            dev_ms = statistics.median(t[0] for t in times)
            points.append({"bytes": nbytes, "ms": dev_ms,
                           "enqueue_ms": statistics.median(t[1] for t in times),
                           "wall_ms": statistics.median(t[2] for t in times),
                           "ms_range": [min(t[0] for t in times), max(t[0] for t in times)],
                           "gb_per_s": nbytes / dev_ms * 1e-6})
        out[name] = {"points": points,
                     **fit_link([(p["bytes"], p["ms"]) for p in points])}
    return out


def link_phase(configs, dev, smi: str, phase: str = "link") -> dict:
    """The port's own host link on qwen3-0.6b at full width in the
    engine's f32: ``PagedKVPool.swap_out`` then ``swap_in`` of 1, 8 and 64
    of the engine's KV blocks (block 16, as phase 4), and
    ``AdapterStore.load`` of one adapter at ranks 8, 32 and 128, each
    :data:`LINK_ITERS` times on fresh data, every round trip checked bit
    for bit (gated on that alone)."""
    from repro_torch.kvcache import PagedKVPool
    from repro_torch.lora import AdapterStore
    from repro_torch.models import build_model
    from repro_torch.serving.engine import kv_pool_spec

    cfg = configs.get("qwen3-0.6b")
    spec = kv_pool_spec(cfg, 16)
    n = max(LINK_BLOCKS)
    pool = PagedKVPool(spec, 2 * n, n, device=dev)  # the round trips land in [n, 2n)
    gen = torch.Generator(device=dev).manual_seed(10)
    kv = {"swap_out": [], "swap_in": []}
    for nb in LINK_BLOCKS:
        blocks, back = list(range(nb)), list(range(n, n + nb))
        outs, ins = [], []
        for _ in range(LINK_ITERS):
            for t in (pool.k_hbm, pool.v_hbm):
                t[:nb].normal_(generator=gen)
                t[n:n + nb].zero_()
            outs.append(event_ms(lambda: pool.swap_out(blocks, blocks)))
            ins.append(event_ms(lambda: pool.swap_in(blocks, back)))
            require(all(torch.equal(t[n:n + nb], t[:nb]) for t in (pool.k_hbm, pool.v_hbm)),
                    f"link: {nb} KV blocks differ after swap_out and swap_in")
        kv["swap_out"].append((nb * spec.block_bytes, outs))
        kv["swap_in"].append((nb * spec.block_bytes, ins))
    del pool
    loads = []
    cpu = torch.Generator().manual_seed(10)
    for r in LINK_RANKS:
        rcfg = dataclasses.replace(cfg, lora=dataclasses.replace(cfg.lora, rank=r))
        store = AdapterStore(build_model(rcfg, dtype=torch.float32, device=dev), 2)
        L = rcfg.num_layers
        times = []
        for i in range(LINK_ITERS):
            aid = f"link-r{r}-{i}"
            aw = store.register(aid, weights={
                t: (torch.randn((L, di, r), generator=cpu), torch.randn((L, r, do), generator=cpu))
                for t, (di, do) in store.model.lora_dims().items()})
            for a, b in store.slots.values():
                a.zero_()
                b.zero_()
            times.append(event_ms(lambda: store.load(aid)))
            slot = store.slot_of(aid)
            require(all(torch.equal(store.slots[t][0][:, slot].cpu(), a)
                        and torch.equal(store.slots[t][1][:, slot].cpu(), b)
                        for t, (a, b) in aw.weights.items()),
                    f"link: the rank-{r} adapter differs in its device slot")
            store.unload(aid)
        loads.append((aw.nbytes, times))
        del store
    return {"phase": phase, "nvidia_smi": smi, "kv_block_bytes": spec.block_bytes,
            "blocks": LINK_BLOCKS, "ranks": LINK_RANKS, "iters": LINK_ITERS,
            **link_timings({**kv, "adapter_load": loads})}


def h100_spec_line(configs, link: dict, llama_bf16: dict) -> dict:
    """The simulator's H100 spec as measured in this run: the card's
    memory, the host's, ``swap_in``'s fit from ``link`` (the phase 2b
    line), and phase 9's llama-7b bf16 prefill and decode (its prefill
    efficiency, and its decode steps' time past the simulator's own, the
    timed run's and each window's), beside ``sim/h100.py``'s recorded
    spec."""
    from repro_torch.sim import h100

    llama = configs.get("llama-7b")
    B, S, steps = llama_bf16["batch"], llama_bf16["prompt_tokens"], llama_bf16["decode_steps"]
    # the decode steps' mean context: the prompts, the extend's rows, half the steps
    ctx = sum(S + n for n in llama_bf16["extend_true_lens"]) + B * (steps - 1) // 2

    def overhead(ms):
        return h100.measured_decode_overhead(llama, B, ctx, ms / 1e3)

    swap_in = link["swap_in"]
    return {"phase": "h100_spec", "card": h100.CARD,
            "recorded": dataclasses.asdict(h100.h100_spec()),
            "measured": {
                "hbm_bytes": torch.cuda.get_device_properties(0).total_memory,
                "host_bytes": host_mem_total(),
                "pcie_bw": swap_in["gb_per_s"] * 1e9,
                "pcie_latency": swap_in["latency_us"] * 1e-6,
                "prefill_mfu": h100.measured_prefill_mfu(llama, B * S, llama_bf16["prefill_s"]),
                "decode_overhead": overhead(llama_bf16["decode_ms_per_step"]),
                "decode_overhead_windows": [overhead(w) for w in
                                            llama_bf16["decode_ms_per_step_windows"]],
                "decode_ctx_tokens": ctx}}


# -------------------------------------------------------------------- dist
DIST_STEPS = 3
DIST_STEP0 = 500  # train_batch seeds of the dist steps
DIST_DIR = HERE / "build" / "repro_torch_train" / "dist_smoke"
# the train launcher's two runs: 2 steps and a checkpoint, then a restart
# to step 4 that must resume from it
DIST_LAUNCH = ["--arch", TRAIN_ARCH, "--full-config", "--ckpt-every", "2", "--compress"]
DIST_GRAD_NORM_TOL = 1e-4  # relative


# phase 11's kernels at the local shapes tensor parallelism gives them, on
# the last rank of a model axis of M: (config, M). One card runs the
# qwen3-0.6b path on a 1 × 1 mesh and the families on two ranks (M = 2), so
# these shapes are checked here, apart from the path: deepseek's MLA LoRA
# targets, rwkv6's r/k/v/o, phi3.5-moe's 8 of 32 heads on 2 kv heads,
# seamless's 8 of 16 heads at D = 64.
TP_SHAPES = (("qwen3-0.6b", 2), ("qwen3-0.6b", 4), ("gemma-2b", 2),
             ("deepseek-v2-lite-16b", 2), ("rwkv6-1.6b", 2), ("phi3.5-moe-42b-a6.6b", 4),
             ("seamless-m4t-large-v2", 2))
# phase 11's families: (config, field overrides cutting its depth for time,
# kernel launches a step on each rank: fused_sgmv and lora_grad on every
# LoRA projection, flash_prefill and flash_prefill_bwd on every causal
# window-free GQA layer; MLA and the encoder attend through the plain sdpa,
# recurrentgemma's attention layer has a window). Two unsharded steps on
# the card, then the same two on a (1, 2) mesh of two gloo ranks on it.
FAMILY_RUNS = (
    ("deepseek-v2-lite-16b", {"num_layers": 2}, {"fused_sgmv": 6, "lora_grad": 6}),
    ("rwkv6-1.6b", {"num_layers": 2}, {"fused_sgmv": 8, "lora_grad": 8}),
    ("recurrentgemma-2b", {"num_layers": 3}, {"fused_sgmv": 4, "lora_grad": 4}),
    ("seamless-m4t-large-v2", {"num_layers": 2, "encoder_layers": 2},
     {"fused_sgmv": 8, "lora_grad": 8, "flash_prefill": 2, "flash_prefill_bwd": 2}))
FAMILY_STEPS = 2
FAMILY_B, FAMILY_S = 4, 128  # 512 tokens a step (seamless: 32 frames a row)
FAMILY_MESH = (1, 2)
# the families' grad norms against the unsharded steps, relative, a step.
# Two f32 computations of one step differ by f32's own spread, which is
# wider here than phase 11's 1 x 1 (bitwise) check: rwkv6's unsharded f32
# step at full width lies 1.6e-4 under a float64 step of the host on the
# same weights, the same step with a plain fused_sgmv 1.0e-4 over it
# (scripts/family_precision.py). The second step starts from weights that
# AdamW's first update moved apart: an element whose gradient is below that
# spread moves by up to lr in either direction
FAMILY_GRAD_NORM_TOL = (1e-3, 1e-2)


def lora_bases(cfg) -> dict[str, str]:
    """Each LoRA target's base projection, by its param path name."""
    if cfg.mla is not None:
        return {"q": "layers/mixer/wq", "kv_a": "layers/mixer/w_kv_a", "o": "layers/mixer/wo"}
    if cfg.rwkv is not None:
        return {t: f"layers/mixer/w{t}" for t in ("r", "k", "v", "o")}
    home = "decoder/attn" if cfg.is_encdec else "layers/mixer"
    return {t: f"{home}/w{t}" for t in ("q", "k", "v", "o")}


def grad_check(what: str, kernel, plain, inputs, gen, out_tol: float, out_abs: bool) -> dict:
    """A kernel's forward and backward (autograd) against its plain
    version's on the same inputs: the output within ``out_tol`` (absolute
    under ``out_abs``, else times the plain output's largest magnitude),
    every gradient within GRAD_TOL of the plain gradient's largest
    magnitude; with the forward-and-backward times of both."""
    got, want = kernel(*inputs), plain(*inputs)
    dy = torch.randn(got.shape, generator=gen, device=got.device)
    out_err = float((got - want).detach().abs().max())
    tol = out_tol if out_abs else out_tol * float(want.detach().abs().max())
    require(out_err <= tol, f"{what}: output off by {out_err} > {tol}")
    g_got = torch.autograd.grad(got, inputs, dy)
    g_want = torch.autograd.grad(want, inputs, dy)
    grad_errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                 for g, w in zip(g_got, g_want)]
    require(max(grad_errs) <= GRAD_TOL, f"{what}: gradients off the plain backward's "
                                        f"by {max(grad_errs)} of max")
    return {"max_abs_err": out_err, "grad_rel_errs": grad_errs,
            "ms": time_ms(lambda: torch.autograd.grad(kernel(*inputs), inputs, dy),
                          iters=5)[0],
            "plain_ms": time_ms(lambda: torch.autograd.grad(plain(*inputs), inputs, dy),
                                **PLAIN)[0]}


def fwd_bwd_bound(kernel: str, **shape) -> tuple[float, str]:
    """The bound of a training kernel's forward and backward together (what
    ``grad_check`` times): the sum of ``counting.work`` of the forward and
    of its backward; ``fused_sgmv``'s backward is ``lora_grad`` (the delta's
    dx, dA, dB) and the base term's two products, dx = dy·Wᵀ and dW = xᵀ·dy
    (dy, W and x read, dW written), ``flash_prefill``'s ``flash_prefill_bwd``."""
    if kernel == "fused_sgmv":
        B, S, d_in, d_out = shape["B"], shape["S"], shape["d_in"], shape["d_out"]
        fb, ff = work("fused_sgmv", B=B, S=S, d_in=d_in, d_out=d_out, r=shape["r"],
                      ids=shape["ids"])
        bb, bf = work("lora_grad", **shape)
        M = B * S
        nbytes = fb + bb + 4 * (M * d_out + 2 * d_in * d_out + M * d_in)
        return bound_ms(nbytes, ff + bf + 4 * M * d_in * d_out)
    fb, ff = work("flash_prefill", **shape)
    bb, bf = work("flash_prefill_bwd", **shape)
    return bound_ms(fb + bb, ff + bf)


def tp_kernel_cases(ops, ref, configs, gen, dev) -> list:
    """fused_sgmv (its backward through lora_grad) on each LoRA projection
    and flash_prefill (its backward through flash_prefill_bwd) on the
    rank's heads, at the local shapes of the last rank of each TP_SHAPES
    model axis: the base weight's shard by the rules (``spec_for_param``
    without ``cfg``, as the launcher places it), LoRA A/B as
    ``TensorParallel.prepare`` cuts them (B's columns for q/k/v/r, A's rows
    for o; MLA's kv_a whole), the heads ``TensorParallel.heads`` gives
    (gemma-2b at 2: four query heads on one kv head; no flash case for MLA
    and RWKV, which attend without it). f32, TRAIN_B rows of TRAIN_S tokens
    with TRAIN_IDS, rank 32 on 4 slots. Run before the path's counts are
    reset, so none of these launches is counted as the path's."""
    from repro_torch.distributed.sharding import make_shardings, spec_for_param
    from repro_torch.distributed.tensor_parallel import TensorParallel
    from repro_torch.models import build_model

    ids = torch.tensor(TRAIN_IDS, dtype=torch.int32, device=dev)
    cases = []
    for arch, M in TP_SHAPES:
        cfg = configs.get(arch)
        meta = build_model(cfg, dtype=torch.float32, device=torch.device("meta"))
        dims, r, N, scale = meta.lora_dims(), cfg.lora.rank, 4, meta.lora_scale
        mesh = {"data": 1, "model": M}
        names = lora_bases(cfg)
        whole_shapes = {t: (cfg.num_layers, *dims[t]) for t in names}
        specs = {names[t]: spec_for_param(names[t], whole_shapes[t], mesh) for t in names}
        shard = make_shardings(specs, mesh)
        tp = TensorParallel(None, M, M - 1, specs)
        whole = {t: (torch.randn((N, i, r), generator=gen, device=dev) * i ** -0.5,
                     torch.randn((N, r, o), generator=gen, device=dev) * 0.1)
                 for t, (i, o) in dims.items() if t in names}
        _, lora = tp.prepare({}, whole, cfg)
        for t in names:
            d_in, d_out = shard[names[t]].local_shape(whole_shapes[t])[1:]
            a, b = lora[t]
            require(a.shape[1] == d_in and b.shape[2] == d_out,
                    f"{arch} model {M} {t}: LoRA {tuple(a.shape)}, {tuple(b.shape)} "
                    f"against the shard {d_in} x {d_out}")
            x = torch.randn((TRAIN_B, TRAIN_S, d_in), generator=gen, device=dev)
            w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
            inputs = [z.detach().contiguous().requires_grad_(True) for z in (x, w, a, b)]
            what = f"fused_sgmv {arch} model {M} {t} {d_in}->{d_out}"
            bnd, by = fwd_bwd_bound("fused_sgmv", B=TRAIN_B, S=TRAIN_S, d_in=d_in,
                                    d_out=d_out, r=r, slots=N, ids=list(TRAIN_IDS))
            cases.append({"kernel": "fused_sgmv", "arch": arch, "model_axis": M, "proj": t,
                          "d_in": d_in, "d_out": d_out, "whole": list(dims[t]),
                          **grad_check(what, lambda *z: ops.fused_sgmv(*z, ids, scale=scale),
                                       lambda *z: ref.fused_sgmv_ref(*z, ids, scale),
                                       inputs, gen, SGMV_TOL, False),
                          "bound_ms": bnd, "bound_by": by, "library_ms": None})
        if cfg.mla is not None or cfg.rwkv is not None:
            torch.cuda.empty_cache()
            continue
        q0, q1, k0, k1 = tp.heads(cfg)
        D = cfg.resolved_head_dim
        # (B, S, heads, D) leaves, handed over head-major as gqa_full does
        inputs = [torch.randn((TRAIN_B, TRAIN_S, h, D), generator=gen,
                              device=dev).requires_grad_(True)
                  for h in (q1 - q0, k1 - k0, k1 - k0)]
        what = f"flash_prefill {arch} model {M} {q1 - q0}/{k1 - k0}x{D}"
        bnd, by = fwd_bwd_bound("flash_prefill", B=TRAIN_B, S=TRAIN_S, H=q1 - q0,
                                Hkv=k1 - k0, D=D)
        # SDPA's f32 forward and backward on the same inputs, head-major
        sdpa_in = [u.detach().transpose(1, 2).contiguous().requires_grad_(True)
                   for u in inputs]
        dy = torch.randn(sdpa_in[0].shape, generator=gen, device=dev)

        def sdpa_fwd_bwd():
            o = torch.nn.functional.scaled_dot_product_attention(
                *sdpa_in, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, sdpa_in, dy)

        cases.append({"kernel": "flash_prefill", "arch": arch, "model_axis": M,
                      "heads": q1 - q0, "kv_heads": k1 - k0, "head_dim": D,
                      **grad_check(what, lambda *z: ops.flash_prefill(
                                       *(u.transpose(1, 2) for u in z)),
                                   lambda *z: ref.flash_prefill_ref(
                                       *(u.transpose(1, 2) for u in z)),
                                   inputs, gen, ATTN_TOL, True),
                      "bound_ms": bnd, "bound_by": by,
                      "library_ms": time_ms(sdpa_fwd_bwd, iters=5)[0]})
        torch.cuda.empty_cache()
    return cases


def dist_rank(rank: int, world: int, cfg, device_type: str) -> dict:
    """Phase 11 on one rank of the default process group: phase 8's model
    and weights (seed 0, on this rank's card), placed by the rules on the
    ``plan_mesh`` mesh, DIST_STEPS sharded steps on ``train_batch``'s
    batches with the launch counts reset just before and read just after."""
    from repro_torch.distributed import (batch_specs, build_mesh, make_shardings,
                                         plan_mesh, wire_bytes)
    from repro_torch.distributed.sharded_step import (make_sharded_train_step,
                                                      train_state_specs)
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, make_train_state

    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device(device_type))
    model = build_model(cfg, dtype=torch.float32, device=dev)
    full = make_train_state(model, torch.Generator(device=dev).manual_seed(0), n_lora_slots=4)
    plan = plan_mesh(world, preferred_model=min(4, cfg.num_heads))
    mesh = build_mesh(plan, device_type)
    shardings = make_shardings(train_state_specs(full, mesh), mesh)
    state = shard_tree(full, shardings)
    del full
    step_fn = make_sharded_train_step(model, shardings, lr=3e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics, seconds = [], []
    for step in range(DIST_STEPS):
        t0 = time.perf_counter()
        batch = train_batch(cfg, DIST_STEP0 + step, dev)
        local = shard_tree(batch, make_shardings(batch_specs(batch, mesh), mesh))
        state, met = step_fn(state, local)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append(met)
    launches = ops.launch_counts()
    local = {"params": state.params, "lora": state.lora}
    return {"backend": torch.distributed.get_backend(), "world": world,
            "plan": dataclasses.asdict(plan), "coordinate": mesh.get_coordinate(),
            "losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "step_seconds": seconds, "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wire_bytes": {"f32": wire_bytes(local, compressed=False),
                           "int8": wire_bytes(local, compressed=True)}}


def family_cfg(configs, arch: str, cut: dict):
    return dataclasses.replace(configs.get(arch), **cut)


def family_batch(cfg, step: int, dev) -> dict:
    """``train_batch``'s FAMILY_B x FAMILY_S batch, with an
    encoder-decoder's frames (FAMILY_S / 4 a row) drawn from the same
    generator after it."""
    batch = train_batch(cfg, DIST_STEP0 + step, dev, FAMILY_B, FAMILY_S)
    if cfg.is_encdec:
        gen = torch.Generator(device=dev).manual_seed(2000 + step)
        batch["frames"] = torch.randn((FAMILY_B, FAMILY_S // 4, cfg.d_model),
                                      generator=gen, device=dev)
    return batch


def family_rank(rank: int, world: int, cfgs: list, device_type: str) -> list:
    """Phase 11's families on one rank of a (1, world) mesh over gloo, all
    ranks on one card: for each config, the seed-0 train state drawn on the
    card (``make_train_state``'s draws; its zero moments made on the
    shards) and cut to this rank's shards by the rules (the ranks in turn,
    so one whole set of weights at a time is on the card), FAMILY_STEPS sharded steps
    on ``family_batch``'s batches with the launch counts reset just before
    and read just after; the metrics, the local and whole shapes, the
    launches, seconds a step and the peak GB."""
    from repro_torch.distributed import batch_specs, build_mesh, make_shardings
    from repro_torch.distributed.elastic import ElasticPlan
    from repro_torch.distributed.sharded_step import (make_sharded_train_step,
                                                      train_state_specs)
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import ops
    from repro_torch.models import TrainState, build_model
    from repro_torch.optim import OptState, adamw_init
    from repro_torch.tree import flatten_with_names, tree_map

    on_card = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device(device_type))
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it
    mesh = build_mesh(ElasticPlan(data=FAMILY_MESH[0], model=FAMILY_MESH[1],
                                  dropped_devices=0), device_type)
    axes = {"data": FAMILY_MESH[0], "model": FAMILY_MESH[1]}
    out = []
    for cfg in cfgs:
        model = build_model(cfg, dtype=torch.float32, device=dev)
        for turn in range(world):
            if turn == rank:
                # make_train_state's draws, its zero moments made on the shards
                gen = torch.Generator(device=dev).manual_seed(0)
                params, lora = model.init_params(gen), model.init_lora(gen, 4)
                full = TrainState(params=params, lora=lora, opt=adamw_init(tree_map(
                    lambda t: t.to("meta"), {"params": params, "lora": lora})),
                    step=torch.zeros((), dtype=torch.int32))
                whole = {n: tuple(t.shape) for n, t in flatten_with_names(full)}
                rules = {n: sh.local_shape(whole[n]) for n, sh in make_shardings(
                    train_state_specs(full, axes), axes).items()}
                shardings = make_shardings(train_state_specs(full, mesh), mesh)
                state = shard_tree(full, shardings)
                zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev)  # noqa: E731
                state = dataclasses.replace(state, opt=OptState(
                    m=tree_map(zeros, state.opt.m), v=tree_map(zeros, state.opt.v),
                    step=torch.zeros((), dtype=torch.int32)))
                del full, params, lora
                if on_card:
                    torch.cuda.empty_cache()
            torch.distributed.barrier()
        step_fn = make_sharded_train_step(model, shardings, lr=3e-4)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        metrics, seconds = [], []
        for step in range(FAMILY_STEPS):
            t0 = time.perf_counter()
            batch = family_batch(cfg, step, dev)
            local = shard_tree(batch, make_shardings(batch_specs(batch, mesh), mesh))
            state, met = step_fn(state, local)
            if on_card:
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append(met)
        out.append({"arch": cfg.name, "coordinate": mesh.get_coordinate(),
                    "losses": [float(m["loss"]) for m in metrics],
                    "grad_norms": [float(m["grad_norm"]) for m in metrics],
                    "local_shapes": {n: tuple(t.shape) for n, t in flatten_with_names(state)},
                    "whole_shapes": whole, "rules": rules, "launches": ops.launch_counts(),
                    "step_seconds": seconds,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0})
        del state, step_fn, model
        if on_card:
            torch.cuda.empty_cache()
    return out


def family_runs(configs, dev) -> tuple[list, dict]:
    """FAMILY_RUNS: FAMILY_STEPS unsharded ``make_train_step`` steps of each
    config on the card, then (one spawn for all) the same steps through
    ``make_sharded_train_step`` on a (1, 2) mesh of two ranks on this card
    over gloo (NCCL refuses two ranks on one device; gloo carries the CUDA
    tensors of ``all_reduce`` and ``all_gather`` through the host, so the
    step times are no tensor-parallel timings). Held: losses within
    TRAIN_LOSS_TOL and grad norms within FAMILY_GRAD_NORM_TOL of the
    unsharded steps, both ranks' losses equal, every rank's local shapes the
    rules' shards, launches a step exact on each rank. Returns (a line a
    config, launches summed over the ranks)."""
    from repro_torch.distributed.runner import run_ranks
    from repro_torch.models import build_model, make_train_state, make_train_step

    cfgs = [family_cfg(configs, arch, cut) for arch, cut, _ in FAMILY_RUNS]
    unsharded = []
    for cfg in cfgs:
        t0 = time.perf_counter()
        model = build_model(cfg, dtype=torch.float32, device=dev)
        state = make_train_state(model, torch.Generator(device=dev).manual_seed(0),
                                 n_lora_slots=4)
        step_fn = make_train_step(model, lr=3e-4)
        mets = []
        for step in range(FAMILY_STEPS):
            state, met = step_fn(state, family_batch(cfg, step, dev))
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        unsharded.append({"metrics": mets, "seconds": time.perf_counter() - t0})
        del state, model, step_fn
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(family_rank, FAMILY_MESH[1], DIST_DIR / "family_stores",
                      backend="gloo", args=(cfgs, dev.type), timeout=600)
    spawn_s = time.perf_counter() - t0
    lines, launches = [], {}
    for i, ((arch, cut, per_step), cfg, one) in enumerate(zip(FAMILY_RUNS, cfgs, unsharded)):
        runs = [r[i] for r in ranks]
        r0 = runs[0]
        rules = r0["rules"]
        for r in runs:
            require(r["local_shapes"] == rules,
                    f"{arch}: rank {r['coordinate']} local shapes off the rules' shards")
            want = dict.fromkeys(r["launches"], 0)
            want.update({k: n * FAMILY_STEPS for k, n in per_step.items()})
            require(r["launches"] == want, f"{arch} rank {r['coordinate']} launches "
                                           f"{r['launches']} != {want}")
            require(r["losses"] == r0["losses"], f"{arch}: the ranks' losses differ")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        loss_err = max(abs(a - b[0]) / abs(b[0]) for a, b in zip(r0["losses"], one["metrics"]))
        norm_errs = [abs(a - b[1]) / b[1] for a, b in zip(r0["grad_norms"], one["metrics"])]
        require(loss_err <= TRAIN_LOSS_TOL, f"{arch} sharded losses {r0['losses']} against "
                                            f"the unsharded {one['metrics']}")
        require(all(e <= tol for e, tol in zip(norm_errs, FAMILY_GRAD_NORM_TOL)),
                f"{arch} sharded grad norms {r0['grad_norms']} against the unsharded "
                f"{one['metrics']}")
        sharded = {n: list(s) for n, s in rules.items()
                   if n.startswith("params/") and s != r0["whole_shapes"][n]}
        require(bool(sharded), f"{arch}: no parameter is sharded over model")
        lines.append({"arch": arch, "cut": cut, "mesh": list(FAMILY_MESH), "backend": "gloo",
                      "batch": FAMILY_B, "seq": FAMILY_S, "losses": r0["losses"],
                      "grad_norms": r0["grad_norms"], "unsharded": one["metrics"],
                      "loss_rel_err": loss_err, "grad_norm_rel_errs": norm_errs,
                      "sharded_param_shapes": sharded,
                      "launches_per_step": {k: v // FAMILY_STEPS
                                            for k, v in r0["launches"].items() if v},
                      "unsharded_seconds": one["seconds"],
                      "step_seconds_gloo": [r["step_seconds"] for r in runs],
                      "peak_gb_per_rank": [r["peak_gb"] for r in runs]})
    lines.append({"spawn_seconds": spawn_s})
    return lines, launches


# phase 11's serving runs: the sharded prefill and decode steps
# (``make_sharded_prefill_step`` / ``make_sharded_decode_step``) of each
# family on a (1, 2) mesh of two gloo ranks on the one card, against the
# unsharded steps on the card, at full width: (config, depth cut for time,
# dtype, kernel launches of the prefill and the decode steps on each rank).
# qwen3-0.6b at all 28 layers: its cache sharded by kv heads, decoded
# through paged_attention; gemma-2b (one kv head) at 4: its cache sharded in
# time, decoded through paged_attention with lse and merged over the model
# axis; deepseek-v2-lite-16b (MLA's latent in time), rwkv6-1.6b (wkv by
# heads), recurrentgemma-2b (the RG-LRU's state replicated; its attention
# layer's cache in time, attended through the plain path for its window)
# and seamless-m4t-large-v2 (its cross cache by heads; its prefill through
# ragged_extend) at phase 11's training depths; qwen3-0.6b and gemma-2b
# again in bf16, the static path's default.
SERVE_RUNS = (
    ("qwen3-0.6b", {}, torch.float32,
     {"fused_sgmv": 112 * 9, "flash_prefill": 28, "paged_attention": 28 * 8}),
    ("gemma-2b", {"num_layers": 4}, torch.float32,
     {"fused_sgmv": 16 * 9, "flash_prefill": 4, "paged_attention": 4 * 8}),
    ("deepseek-v2-lite-16b", {"num_layers": 2}, torch.float32, {"fused_sgmv": 6 * 9}),
    ("rwkv6-1.6b", {"num_layers": 2}, torch.float32, {"fused_sgmv": 8 * 9}),
    ("recurrentgemma-2b", {"num_layers": 3}, torch.float32, {"fused_sgmv": 4 * 9}),
    ("seamless-m4t-large-v2", {"num_layers": 2, "encoder_layers": 2}, torch.float32,
     {"fused_sgmv": 8 * 9, "ragged_extend": 2, "paged_attention": 2 * 8}),
    ("qwen3-0.6b", {}, torch.bfloat16,
     {"fused_sgmv": 112 * 9, "flash_prefill": 28, "paged_attention": 28 * 8}),
    ("gemma-2b", {"num_layers": 4}, torch.bfloat16,
     {"fused_sgmv": 16 * 9, "flash_prefill": 4, "paged_attention": 4 * 8}))
# B rows of S-token prompts on SERVE_IDS' 4 adapters into a cache of T
# positions, then STEPS decode steps: at model 2 a time shard's boundary
# (T / 2 = 160) is crossed at the fifth step, so a time-sharded cache meets
# both an empty partial on rank 1 and a change of the writing rank
SERVE_B, SERVE_S, SERVE_T, SERVE_STEPS, SERVE_SRC = 4, 156, 320, 8, 32
SERVE_IDS = (0, 1, 2, 3)
# the bf16 runs' bound on a logit row's relative L2 error against the
# unsharded bf16 steps: about 3x the largest reading (0.0146 on qwen3-0.6b,
# 0.0077 on gemma-2b, an H100 80GB HBM3 at 700 W), which the different
# rounding of the sharded GEMMs and of the merge account for. The f32 runs
# are the ones that catch a small fault, such as a rank's partial dropped
SERVE_BF16_TOL = 0.05


def serve_inputs(cfg) -> dict:
    """The serving runs' prompts (and an encoder-decoder's frames), drawn on
    the host from a fixed seed: the same on every rank and device."""
    gen = torch.Generator().manual_seed(3000)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S), generator=gen,
                                   dtype=torch.int64).to(torch.int32),
           "adapter_ids": torch.tensor(SERVE_IDS, dtype=torch.int32)}
    if cfg.is_encdec:
        out["frames"] = torch.randn((SERVE_B, SERVE_SRC, cfg.d_model), generator=gen)
    return out


def serve_unsharded(model, params, lora, inputs) -> dict:
    """The unsharded prefill into SERVE_T positions and SERVE_STEPS greedy
    decode steps on the card: each call's last logits (host, f32) and
    greedy tokens, the tokens fed to the decode steps, and the seconds."""
    from repro_torch.tree import flatten_with_names

    dev = model.device
    tokens = inputs["tokens"].to(dev)
    ids = inputs["adapter_ids"].to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        if model.cfg.is_encdec:
            lg, cache = model.prefill(params, inputs["frames"].to(dev, model.dtype), tokens,
                                      SERVE_T, lora=lora, adapter_ids=ids)
        else:
            lg, cache = model.prefill(params, tokens, SERVE_T, lora=lora, adapter_ids=ids)
        logits = [lg[:, -1].float().cpu()]
        tok = logits[0].argmax(-1).to(torch.int32)
        fed = []
        for _ in range(SERVE_STEPS):
            fed.append(tok)
            lg, cache = model.decode(params, cache, tok[:, None].to(dev), lora=lora,
                                     adapter_ids=ids)
            logits.append(lg[:, -1].float().cpu())
            tok = logits[-1].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return {"logits": logits, "fed": fed, "seconds": time.perf_counter() - t0,
            "cache_shapes": {n: list(t.shape) for n, t in flatten_with_names(cache)}}


def serve_rank(rank: int, world: int, runs: list, device_type: str) -> list:
    """Phase 11's serving runs on one rank of a (1, world) mesh over gloo,
    all ranks on one card: for each (config, dtype, the unsharded run's
    decode inputs), the seed-0 weights and LoRA drawn on the card (the
    ranks in turn, so one whole set is on the card at a time) and cut to
    this rank's shards by the rules, then ``make_sharded_prefill_step`` into
    SERVE_T positions and SERVE_STEPS decode steps of the ``sharded_model``
    both steps share, fed the unsharded run's tokens, the launch counts
    reset just before and read just after: the last logits of each call
    (rank 0; every rank's digest), the local cache's shapes and bytes
    beside the rules' and the dry run's, the launches by kernel and by
    loop, the seconds and the peak GB; then, uncounted, whether one
    ``make_sharded_decode_step`` step gives that model's decode's greedy
    token and cache bitwise."""
    import hashlib

    from repro_torch.distributed import (build_mesh, make_sharded_decode_step,
                                         make_sharded_prefill_step, make_shardings,
                                         serve_state_specs, sharded_model, whole_cache)
    from repro_torch.distributed.elastic import ElasticPlan
    from repro_torch.distributed.sharding import cache_specs, shard_tree
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import device_bytes
    from repro_torch.models import build_model
    from repro_torch.tree import flatten_with_names, leaves, tree_map

    on_card = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device(device_type))
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it
    mesh = build_mesh(ElasticPlan(data=1, model=world, dropped_devices=0), device_type)
    axes = {"data": 1, "model": world}
    out = []
    for cfg, dtype, fed in runs:
        model = build_model(cfg, dtype=dtype, device=dev)
        inputs = serve_inputs(cfg)
        src = SERVE_SRC if cfg.is_encdec else None
        cache = whole_cache(model, SERVE_B, SERVE_T, src)
        for turn in range(world):
            if turn == rank:
                params = model.init_params(torch.Generator(device=dev).manual_seed(0))
                lora = random_lora(model, 4, 1)
                shardings = make_shardings(serve_state_specs(params, lora, cache, mesh), mesh)
                sub = {p: {n[len(p):]: sh for n, sh in shardings.items() if n.startswith(p)}
                       for p in ("params/", "lora/")}
                lp, ll = shard_tree(params, sub["params/"]), shard_tree(lora, sub["lora/"])
                del params, lora
                if on_card:
                    torch.cuda.empty_cache()
            torch.distributed.barrier()
        smodel = sharded_model(model, shardings)
        prefill = make_sharded_prefill_step(smodel, shardings, cache)
        decode = make_sharded_decode_step(smodel, shardings)
        batch = {k: v.to(dev) for k, v in inputs.items()}
        if "frames" in batch:
            batch["frames"] = batch["frames"].to(dtype)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, c = prefill(lp, ll, batch)
            logits = [lg[:, -1].float()]
            prefill_paths = ops.path_launch_counts()
            for tok in fed:
                lg, c = smodel.decode(lp, c, torch.from_numpy(tok)[:, None].to(dev), lora=ll,
                                      adapter_ids=batch["adapter_ids"])
                logits.append(lg[:, -1].float())
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, paths = ops.launch_counts(), ops.path_launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        with torch.no_grad():  # the decode step, after the counts: the model's decode, bitwise
            step_in = {"tokens": logits[-1].argmax(-1).to(torch.int32)[:, None],
                       "adapter_ids": batch["adapter_ids"]}
            step_tok, step_c = decode(lp, ll, tree_map(torch.clone, c), step_in)
            lg, c = smodel.decode(lp, c, step_in["tokens"], lora=ll,
                                  adapter_ids=batch["adapter_ids"])
            step_agrees = bool(torch.equal(step_tok, lg[:, -1].argmax(-1).to(torch.int32))) and all(
                torch.equal(a, b) for a, b in zip(leaves(step_c), leaves(c)))
        decode_paths = {k: {p: n - prefill_paths[k][p] for p, n in v.items()}
                        for k, v in paths.items()}
        logits = [x.cpu().numpy() for x in logits]  # numpy: no shared memory to outlive the rank
        digest = hashlib.sha1(b"".join(x.tobytes() for x in logits)).hexdigest()
        specs = cache_specs(cache, axes)
        whole = dict(flatten_with_names(cache))
        rules = {n: list(sh.local_shape(tuple(whole[n].shape)))
                 for n, sh in make_shardings(specs, axes).items()}
        out.append({"arch": cfg.name, "dtype": str(dtype), "coordinate": mesh.get_coordinate(),
                    "logits": logits if rank == 0 else None, "digest": digest,
                    "local_cache_shapes": {n: list(t.shape) for n, t in flatten_with_names(c)},
                    "rules": rules,
                    "local_cache_bytes": sum(t.numel() * t.element_size()
                                             for _, t in flatten_with_names(c)),
                    "dryrun_cache_bytes": device_bytes(cache, specs, axes),
                    "time_sharded": sorted(n for n, sp in specs.items()
                                           if n in ("k", "v", "ck", "cv", "latent", "krope")
                                           and len(sp) > 2 and sp[2] == "model"),
                    "launches": {k: n for k, n in launches.items() if n},
                    "path_launches": {k: {p: n for p, n in v.items() if n}
                                      for k, v in paths.items() if any(v.values())},
                    "decode_path_launches": {k: {p: n for p, n in v.items() if n}
                                             for k, v in decode_paths.items()
                                             if any(v.values())},
                    "seconds": seconds, "peak_gb": peak_gb, "decode_step_agrees": step_agrees})
        del lp, ll, c, step_c, prefill, decode, smodel, model
        if on_card:
            torch.cuda.empty_cache()
    return out


def serve_runs(configs, dev) -> tuple[list, dict]:
    """SERVE_RUNS: the unsharded prefill and decode steps of each config on
    the card, then (one spawn for all) the sharded steps on a (1, 2) mesh of
    two ranks on this card over gloo, fed the unsharded run's tokens. Held:
    both ranks' logits bitwise equal; in f32 every logit within
    ARCH_TOL·(1 + |unsharded|), in bf16 each logit row within
    SERVE_BF16_TOL of its norm (relative L2); the greedy token equal to the
    unsharded one at every position whose unsharded top-2 gap exceeds twice
    the row's largest logit difference, which must be every position in
    f32 and MIN_CLEAR_SHARE of them in bf16; the decode step equal to the
    model's decode;
    every rank's local cache shapes the rules' shards and its bytes the dry
    run's ``device_bytes``; the launches of each rank exact. Returns (a line
    a run, launches summed over the ranks)."""
    from repro_torch.distributed.runner import run_ranks
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfgs, runs, unsharded = [], [], []
    for arch, cut, dtype, _ in SERVE_RUNS:
        cfg = family_cfg(configs, arch, cut)
        model = build_model(cfg, dtype=dtype, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        one = serve_unsharded(model, params, random_lora(model, 4, 1), serve_inputs(cfg))
        del params, model
        torch.cuda.empty_cache()
        cfgs.append(cfg)
        unsharded.append(one)
        runs.append((cfg, dtype, [t.numpy() for t in one["fed"]]))
    t_one = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = run_ranks(serve_rank, 2, DIST_DIR / "serve_stores", backend="gloo",
                      args=(runs, dev.type), timeout=600)
    spawn_s = time.perf_counter() - t1
    lines, launches = [], {}
    for i, ((arch, cut, dtype, want_launches), one) in enumerate(zip(SERVE_RUNS, unsharded)):
        per = [r[i] for r in ranks]
        r0 = per[0]
        what = f"serve {arch} {dtype}"
        require(all(r["digest"] == r0["digest"] for r in per), f"{what}: the ranks' logits differ")
        errs, compared, worst, worst_rel = [], 0, 0.0, 0.0
        for got, want in zip(r0["logits"], one["logits"]):
            got = torch.from_numpy(got)
            diff = (got - want).abs()
            if dtype == torch.float32:
                excess = float((diff - ARCH_TOL * (1 + want.abs())).max())
                require(excess <= 0, f"{what}: a logit {excess} past ARCH_TOL·(1 + |logit|)")
            rel = float(rel_l2(got, want).max())
            worst_rel = max(worst_rel, rel)
            if dtype != torch.float32:
                require(rel <= SERVE_BF16_TOL, f"{what}: a logit row {rel} off its norm")
            worst = max(worst, float(diff.max()))
            clear = top2_gap(want) > 2 * diff.max(dim=-1).values
            compared += int(clear.sum())
            require(bool((got.argmax(-1) == want.argmax(-1))[clear].all()),
                    f"{what}: a greedy token differs where the top-2 gap is clear")
            errs.append(float(diff.max()))
        positions = SERVE_B * (SERVE_STEPS + 1)
        need = positions if dtype == torch.float32 else MIN_CLEAR_SHARE * positions
        require(compared >= need, f"{what}: {positions - compared} of {positions} "
                                  f"tokens within the logits' difference of a tie")
        for r in per:
            require(r["decode_step_agrees"], f"{what}: rank {r['coordinate']}'s decode step "
                                             f"differs from the model's decode")
            require(r["local_cache_shapes"] == r["rules"],
                    f"{what}: rank {r['coordinate']} local cache {r['local_cache_shapes']} "
                    f"!= the rules' {r['rules']}")
            require(r["local_cache_bytes"] == r["dryrun_cache_bytes"],
                    f"{what}: local cache bytes {r['local_cache_bytes']} != the dry run's "
                    f"{r['dryrun_cache_bytes']}")
            want = {k: n for k, n in want_launches.items()}
            require(r["launches"] == want, f"{what} rank {r['coordinate']} launches "
                                           f"{r['launches']} != {want}")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        lines.append({"arch": arch, "cut": cut, "dtype": str(dtype), "mesh": [1, 2],
                      "backend": "gloo", "batch": SERVE_B, "prompt": SERVE_S,
                      "cache_positions": SERVE_T, "decode_steps": SERVE_STEPS,
                      "time_sharded": r0["time_sharded"],
                      "max_logit_diff_per_call": errs, "max_logit_diff": worst,
                      "max_row_rel_l2": worst_rel,
                      "tokens_compared": compared, "tokens": positions,
                      "whole_cache_shapes": one["cache_shapes"],
                      "local_cache_shapes": [r["local_cache_shapes"] for r in per],
                      "local_cache_bytes": [r["local_cache_bytes"] for r in per],
                      "dryrun_cache_bytes": r0["dryrun_cache_bytes"],
                      "peak_gb_per_rank": [r["peak_gb"] for r in per],
                      "launches_per_rank": r0["launches"],
                      "launches_per_decode_step_by_loop": {
                          k: {p: n / SERVE_STEPS for p, n in v.items()}
                          for k, v in r0["decode_path_launches"].items()},
                      "path_launches_per_rank": [r["path_launches"] for r in per],
                      "unsharded_seconds": one["seconds"],
                      "sharded_seconds_gloo": [r["seconds"] for r in per]})
    lines.append({"unsharded_seconds": t_one, "spawn_seconds": spawn_s,
                  "seconds": time.perf_counter() - t0})
    return lines, launches


def dist_phase(ops, ref, configs, dev, smi: str) -> tuple[dict, dict]:
    """Phase 11: the multi-device layer on every card of the machine, one
    rank a card over NCCL (in this process on one card, through the rank
    runner on more). First the kernels at tensor parallelism's local
    shapes (:func:`tp_kernel_cases`); then DIST_STEPS sharded steps of qwen3-0.6b at full width in
    f32 held against phase 8's unsharded step on the same weights and
    batches (the loss within TRAIN_LOSS_TOL, grad_norm within
    DIST_GRAD_NORM_TOL, relative), exact launches a step on every rank;
    then the train launcher in a subprocess (``torchrun`` on more cards):
    2 steps with ``--compress`` and a checkpoint, then a restart to step 4
    that must resume from it. Returns (line, launches of the sharded steps
    summed over the ranks)."""
    from repro_torch.distributed.runner import run_ranks, single_rank
    from repro_torch.models import build_model, make_train_state, make_train_step

    t_start = time.perf_counter()
    tp_cases = tp_kernel_cases(ops, ref, configs, torch.Generator(device=dev).manual_seed(11),
                               dev)
    torch.cuda.empty_cache()
    cfg = configs.get(TRAIN_ARCH)
    L = cfg.num_layers
    world = torch.cuda.device_count()
    model = build_model(cfg, dtype=torch.float32, device=dev)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0), n_lora_slots=4)
    step_fn = make_train_step(model, lr=3e-4)
    unsharded = []
    for step in range(DIST_STEPS):
        state, met = step_fn(state, train_batch(cfg, DIST_STEP0 + step, dev))
        unsharded.append(met)
    unsharded = [(float(m["loss"]), float(m["grad_norm"])) for m in unsharded]
    del state, model, step_fn
    torch.cuda.empty_cache()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if world == 1:
        with single_rank(backend):
            ranks = [dist_rank(0, 1, cfg, dev.type)]
    else:
        ranks = run_ranks(dist_rank, world, DIST_DIR / "stores", backend=backend,
                          args=(cfg, dev.type), timeout=600)
    per_step = {"fused_sgmv": 4 * L, "flash_prefill": L, "flash_prefill_bwd": L,
                "lora_grad": 4 * L}
    launches = dict.fromkeys(ranks[0]["launches"], 0)
    for r in ranks:
        want = dict.fromkeys(r["launches"], 0)
        want.update({k: n * DIST_STEPS for k, n in per_step.items()})
        require(r["launches"] == want, f"dist rank launches {r['launches']} != {want}")
        for k, n in r["launches"].items():
            launches[k] += n
    ranks_launches = dict(launches)
    loss_err = max(abs(a - b[0]) / abs(b[0]) for a, b in zip(ranks[0]["losses"], unsharded))
    norm_err = max(abs(a - b[1]) / b[1] for a, b in zip(ranks[0]["grad_norms"], unsharded))
    require(all(r["losses"] == ranks[0]["losses"] for r in ranks), "ranks' losses differ")
    require(loss_err <= TRAIN_LOSS_TOL, f"dist losses {ranks[0]['losses']} against the "
                                        f"unsharded {unsharded}")
    require(norm_err <= DIST_GRAD_NORM_TOL, f"dist grad norms {ranks[0]['grad_norms']} "
                                            f"against the unsharded {unsharded}")

    # the families on two gloo ranks on this card
    torch.cuda.empty_cache()
    t_fam = time.perf_counter()
    families, fam_launches = family_runs(configs, dev)
    families.append({"seconds": time.perf_counter() - t_fam})
    for k, n in fam_launches.items():
        launches[k] += n

    # the families' sharded prefill and decode steps on two gloo ranks
    torch.cuda.empty_cache()
    serving, serve_launches = serve_runs(configs, dev)
    for k, n in serve_launches.items():
        launches[k] += n

    # the train launcher: 2 steps and a checkpoint, then a restart to step 4
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    head = ([sys.executable, "-m", "repro_torch.launch.train"] if world == 1 else
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", "-m", "repro_torch.launch.train"])
    env = {**os.environ, "PYTHONPATH": str(HERE / "src")}
    runs = []
    for steps in (2, 4):
        t0 = time.perf_counter()
        proc = subprocess.run(head + DIST_LAUNCH + ["--device", dev.type, "--steps", str(steps),
                                                    "--ckpt-dir", str(DIST_DIR / "ckpt")],
                              capture_output=True, text=True, env=env, timeout=300)
        require(proc.returncode == 0, f"train launcher --steps {steps} exited "
                                      f"{proc.returncode}: {proc.stderr[-3000:]}")
        runs.append({"steps": steps, "seconds": time.perf_counter() - t0,
                     "stdout": proc.stdout.strip().splitlines()})
    require("resumed from step 2 (re-sharded onto current mesh)" in runs[1]["stdout"],
            f"the launcher's restart did not resume from step 2: {runs[1]['stdout']}")
    require(any("gradient compression" in ln for ln in runs[0]["stdout"]),
            f"--compress was not reported: {runs[0]['stdout']}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    r0 = ranks[0]
    line = {"phase": "dist", "nvidia_smi": smi, "backend": r0["backend"], "world": world,
            "plan": r0["plan"], "arch": TRAIN_ARCH, "layers": L, "batch": TRAIN_B,
            "seq": TRAIN_S, "losses": r0["losses"], "grad_norms": r0["grad_norms"],
            "unsharded": unsharded, "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "step_seconds": [r["step_seconds"] for r in ranks],
            "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
            "wire_bytes_per_rank": [r["wire_bytes"] for r in ranks],
            "launches_per_step": {k: v // (DIST_STEPS * world)
                                  for k, v in ranks_launches.items()},
            "launcher": runs, "tp_kernel_cases": tp_cases, "families": families,
            "serving": serving,
            "seconds": time.perf_counter() - t_start}
    return line, launches


def kernel_phase(ops, ref, dev) -> dict:
    """Phase 3: every kernel against its plain version at qwen3-0.6b's
    shapes in f32 (the engine's buckets and decode steps, the generate
    path's prefill), then :func:`arch_kernel_cases`,
    :func:`encdec_kernel_cases`, :func:`backward_kernel_cases` with
    :func:`grad_guard`, :func:`bf16_kernel_cases` and
    :func:`lse_kernel_cases`. Returns the kernels line's fields, with
    ``seconds``: each part's wall seconds."""
    gen = torch.Generator(device=dev).manual_seed(0)
    projections = PROJECTIONS
    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        t = time.perf_counter()
        seconds[part] = t - t0
        t0 = t

    # the engine's 256-token buckets and decode steps, then the generate
    # path's prefill: 2016 is no multiple of the 128-row tile, so tiles
    # straddle rows of different adapters (and of id -1); then the engine's
    # 64-token buckets, too few tiles for the card, where the kernel splits
    # d_in over blocks
    sgmv_cases = [sgmv_case(ops, ref, p, di, do, S, gen, dev)
                  for S in (256, 1, 2016, 64) for p, di, do in projections]
    rag_cases = [ragged_case(ops, ref, gen, dev, S, *RAGGED_BUCKETS[S])
                 for S in (256, 64, 8)]
    pag_cases = [paged_case(ops, ref, gen, dev, PAGED_LENGTHS[k])
                 for k in ("table", "engine")]
    torch.cuda.empty_cache()
    delta_cases = [sgmv_case(ops, ref, p, di, do, S, gen, dev, base=False)
                   for S in (2016, 1)
                   for p, di, do in (projections[0], projections[2])]
    torch.cuda.empty_cache()
    fla = flash_case(ops, ref, gen, dev)
    torch.cuda.empty_cache()
    flr = flash_case(ops, ref, gen, dev,
                     lens=[0, 1, 37, 1000, 2015, 2016, 2016, 2016])
    torch.cuda.empty_cache()
    lap("qwen3_f32")
    arch_cases = arch_kernel_cases(ops, ref, gen, dev)
    lap("arch_kernel_cases")
    for kernel, m in encdec_kernel_cases(ops, ref, gen, dev):
        arch_cases[kernel].append({"arch": ENCDEC_ARCH, "path": "encdec", **m})
    torch.cuda.empty_cache()
    lap("encdec_kernel_cases")
    bwd_cases = backward_kernel_cases(ops, ref, gen, dev)
    refused, grad_errors = grad_guard(ops, ref, dev)
    lap("backward_kernel_cases")
    bf16_cases = bf16_kernel_cases(ops, ref, gen, dev)
    lap("bf16_kernel_cases")
    lse_cases = lse_kernel_cases(ops, ref, gen, dev)
    lap("lse_kernel_cases")
    # every f32 attention launch stays on its own loop
    for c in rag_cases + [m for m in arch_cases["ragged_extend"] if "path" in m]:
        require(c["path"] == "mma", f"f32 ragged_extend {c['case']} ran the {c['path']} loop")
    for c in pag_cases + [m for m in arch_cases["paged_attention"] if "path" in m]:
        require(c["path"] == "chunk", f"f32 paged_attention {c['case']} ran the "
                                      f"{c['path']} loop")
    return {"fused_sgmv": sgmv_cases, "ragged_extend": rag_cases,
            "paged_attention": pag_cases, "sgmv": delta_cases, "flash_prefill": fla,
            "flash_prefill_ragged": flr, "arch_cases": arch_cases, "backward": bwd_cases,
            "refuse_autograd": refused, "training_kernel_grad_errors": grad_errors,
            "bf16": bf16_cases, "lse": lse_cases, "seconds": seconds}


def main() -> None:
    t_script = time.perf_counter()
    # ---------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 library products sum in f32, as the reference's dots do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    per_kernel = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per_kernel, "dir": str(build.BUILD_DIR)})

    # ---------------------------------------------------------- 2b. link
    link = link_phase(configs, dev, smi)
    emit(link)

    # ---------------------------------------------------------- 3. kernels
    k3 = kernel_phase(ops, ref, dev)
    emit({"phase": "kernels_seconds", "seconds": k3.pop("seconds")})
    sgmv_cases, delta_cases = k3["fused_sgmv"], k3["sgmv"]
    rag_cases, pag_cases = k3["ragged_extend"], k3["paged_attention"]
    rag, pag = rag_cases[0], pag_cases[0]
    fla, flr = k3["flash_prefill"], k3["flash_prefill_ragged"]
    arch_cases, bwd_cases, bf16_cases, lse_cases = (
        k3["arch_cases"], k3["backward"], k3["bf16"], k3["lse"])
    projections = PROJECTIONS
    emit({"phase": "kernels", **k3})

    # ----------------------------------------------------------- 4. engine
    torch.cuda.reset_peak_memory_stats()  # the engine's own peak
    cfg = configs.get("qwen3-0.6b")
    ecfg = EngineConfig(hbm_bytes=4 << 30, host_bytes=8 << 30, block_size=16,
                        max_batch_slots=8, max_seq_len=2048, prefill_chunk=256,
                        step_token_budget=512)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, ecfg, seed=0, device=dev)
    adapters = [f"lora-{i}" for i in range(6)]
    for aid in adapters:
        engine.register_adapter(aid)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wave1, wave2 = make_trace(Request, cfg.vocab_size)
    reqs = wave1 + wave2
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in wave1:
        engine.submit(r)
    engine.run()
    for r in wave2:
        engine.submit(r)
    report = engine.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    decode_calls = engine._decode_calls
    prefill_calls = engine.prefill.stats.calls
    L = cfg.num_layers
    row = report.row()
    emit({"phase": "engine", "setup_s": setup_s, "run_s": run_s,
          "report": row, "launches": launches,
          "steps": engine._step_count, "decode_calls": decode_calls,
          "prefill_calls": prefill_calls,
          "swap_out_bytes": engine.kv_pool.swap_out_bytes,
          "swap_in_bytes": engine.kv_pool.swap_in_bytes,
          "prompt_tokens": sum(len(r.prompt) for r in reqs),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    require(row["n_finished"] == len(reqs) and row["n_unfinished"] == 0,
            f"finished {row['n_finished']} of {len(reqs)}")
    engine_kernels = ("fused_sgmv", "ragged_extend", "paged_attention")
    require(all(launches[n] > 0 for n in engine_kernels),
            f"a kernel of the engine never ran: {launches}")
    require(row["kv_hit_rate"] > 0, "kv_hit_rate is 0")
    require(launches["paged_attention"] == L * decode_calls
            and launches["ragged_extend"] == L * prefill_calls
            and launches["fused_sgmv"] == 4 * L * (decode_calls + prefill_calls),
            f"launches {launches} do not match {decode_calls} decode and "
            f"{prefill_calls} prefill calls of {L} layers")

    picked = pick_requests(engine.finished)
    wave = make_trace(Request, cfg.vocab_size, seed=1, N1=12, tag="prof")[0]
    emit({"phase": "profile", **profile_steps(engine, wave)})

    # -------------------------------------------------------------- 5. cpu
    adapter_weights = {aid: engine.adapters._host[aid].weights for aid in adapters}
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total, exact, worst, min_gap = check_against_cpu(cfg, ecfg.max_seq_len, picked,
                                                     adapter_weights)
    emit({"phase": "cpu", "requests": [r.request_id for r in picked],
          "shared_prefix": [r.shared_prefix_len for r in picked],
          "matched_tokens": [r.matched_tokens for r in picked],
          "tokens": total, "argmax_equal": exact,
          "largest_deficit": worst, "smallest_top2_gap": min_gap,
          "seconds": time.perf_counter() - t0})

    # ---------------------------------------------------------- 6. generate
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    line, gen_launches = generate_phase(ops, cfg, dev)
    emit(line)
    torch.cuda.empty_cache()
    line, var_launches = variants_phase(ops, cfg, dev)
    emit(line)

    # ------------------------------------------------------------- 7. archs
    emit({"phase": "archs_host", "mem_total": host_mem_total()})
    arch_launches = dict.fromkeys(gen_launches, 0)
    for name, layers in ARCHS:
        line, counts = arch_phase(ops, configs, EngineConfig, ServingEngine, Request,
                                  dev, name, layers)
        emit(line)
        for k, n in counts.items():
            arch_launches[k] += n + line.get("static", {}).get("launches", {}).get(k, 0)

    # -------------------------------------------------- 7b. state, 7c. encdec
    state_launches = dict.fromkeys(gen_launches, 0)
    for name in STATE_ARCHS:
        line, counts = state_arch_phase(ops, configs, EngineConfig, ServingEngine,
                                        Request, dev, name)
        emit(line)
        for k, n in counts.items():
            state_launches[k] += n
    line, encdec_launches = encdec_phase(ops, configs, dev)
    emit(line)

    # ------------------------------------------------------------- 8. train
    torch.cuda.empty_cache()
    line, train_launches = train_phase(ops, configs, dev)
    emit(line)

    # -------------------------------------------------------------- 9. bf16
    bf16_launches = dict.fromkeys(gen_launches, 0)
    bf16_lines = {}
    t0 = time.perf_counter()
    for name, B, S, chunk_len, steps, with_f32 in BF16_ARCHS:
        line, counts = bf16_phase(ops, configs, dev, name, B, S, chunk_len, steps, with_f32)
        emit(line)
        bf16_lines[name] = line
        for k, n in counts.items():
            bf16_launches[k] += n
    emit({"phase": "bf16_total", "seconds": time.perf_counter() - t0})

    # ---------------------------------------------------- 10. link_late, spec
    torch.cuda.empty_cache()
    emit(link_phase(configs, dev, smi, "link_late"))
    emit(h100_spec_line(configs, link, bf16_lines["llama-7b"]))

    # -------------------------------------------------------------- 11. dist
    torch.cuda.empty_cache()
    line, dist_launches = dist_phase(ops, ref, configs, dev, smi)
    emit(line)

    # ---------------------------------------------------------- 12. summary
    kernels = []
    for name, src, tpu, m in (
            # the q projection in a 256-token bucket
            ("fused_sgmv", "fused_sgmv.cu", "src/repro/kernels/sgmv.py:115",
             sgmv_cases[0]),
            # the q projection of 8 rows of 2016 tokens
            ("sgmv", "fused_sgmv.cu", "src/repro/kernels/sgmv.py:47",
             delta_cases[0]),
            ("ragged_extend", "ragged_extend.cu",
             "src/repro/kernels/ragged_extend.py:121", rag),
            ("paged_attention", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:99", pag),
            ("flash_prefill", "flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:143", fla),
            ("flash_prefill_ragged", "flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:252", flr),
            # the backward passes: no TPU kernel has one; they pair with these
            ("flash_prefill_bwd", "flash_prefill_bwd.cu",
             "src/repro/kernels/flash_prefill.py:143", bwd_cases["flash_prefill_bwd"][0]),
            ("lora_grad", "lora_grad.cu", "src/repro/kernels/sgmv.py:115",
             bwd_cases["lora_grad"][0])):
        by_path = {"engine": launches[name], "generate": gen_launches[name],
                   "variants": var_launches[name], "archs": arch_launches[name],
                   "state": state_launches[name], "encdec": encdec_launches[name],
                   "train": train_launches[name], "bf16": bf16_launches[name],
                   "dist": dist_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": tpu,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "case": m["case"]})
    # bf16 fused_sgmv's wgmma loop (csrc/fused_sgmv_wgmma.cu), its own
    # source: qwen3-0.6b's q over 8 x 2016 tokens, launches of phase 9
    wq = next(m for m in bf16_cases["fused_sgmv"]
              if m["case"].startswith("q ") and ", S=2016," in m["case"])
    wgmma_launches = sum(line["fused_sgmv_paths"]["prefill_extend"]["wgmma"]
                         for line in bf16_lines.values())
    require(wgmma_launches > 0, "fused_sgmv's wgmma loop never ran in phase 9")
    kernels.append({
        "name": "fused_sgmv_wgmma", "kernel": "fused_sgmv", "path": "wgmma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sgmv_wgmma.cu",
        "replaces": "src/repro/kernels/sgmv.py:115", "launches": wgmma_launches,
        "launches_by_path": {"bf16": wgmma_launches},
        **{k: wq[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "case", "cublas_xw_ms")}})
    # bf16 fused_sgmv's cluster loop (csrc/fused_sgmv_cluster.cu), its own
    # source: qwen3-0.6b's q at a decode step of 16 rows, launches of phase 9
    cq = next(m for m in bf16_cases["fused_sgmv"] if m["case"] == SGMV_CLUSTER_CASE)
    cluster_launches = sum(line["fused_sgmv_paths"]["decode"]["cluster"]
                           for line in bf16_lines.values())
    require(cluster_launches > 0, "fused_sgmv's cluster loop never ran in phase 9")
    kernels.append({
        "name": "fused_sgmv_cluster", "kernel": "fused_sgmv", "path": "cluster",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/fused_sgmv_cluster.cu",
        "replaces": "src/repro/kernels/sgmv.py:115", "launches": cluster_launches,
        "launches_by_path": {"bf16": cluster_launches},
        **{k: cq[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "case", "cublas_xw_ms", "cold", "device_ops")}})
    # the bf16 attention loops of this port's own design (their launches:
    # phase 9's): paged_attention's split loop at phase 3's table lengths,
    # ragged_extend's wgmma loop at the engine's 256-token bucket
    for name, kernel, path, src, tpu in (
            ("paged_attention_split", "paged_attention", "split", "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:99"),
            ("ragged_extend_wgmma", "ragged_extend", "wgmma", "ragged_extend_wgmma.cu",
             "src/repro/kernels/ragged_extend.py:121")):
        m = bf16_cases[kernel][0]
        n = sum(line["attention_paths"][kernel][path] for line in bf16_lines.values())
        require(n > 0, f"{kernel}'s {path} loop never ran in phase 9")
        kernels.append({
            "name": name, "kernel": kernel, "path": path, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": tpu, "launches": n,
            "launches_by_path": {"bf16": n},
            **{k: m[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "case")}})
    # each kernel's launches by loop in phase 9 (build.PATHS)
    for k in kernels:
        if k["name"] in build.PATHS:
            k["bf16_paths"] = {p: sum(line["paths"][k["name"]][p] for line in bf16_lines.values())
                               for p in build.PATHS[k["name"]]}
    # fused_sgmv's shapes differ by path: beside the engine's bucket, the q
    # projection of the generate path's prefill
    n = len(projections)
    kernels[0]["generate_path_case"] = {
        k: sgmv_cases[2 * n][k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
    # ragged_extend beside the 256-token bucket: the 64- and 8-token ones
    kernels[2]["bucket_cases"] = [
        {k: m[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for m in rag_cases[1:]]
    # the decode kernels with a cold L2 beside the warm times: fused_sgmv at
    # the four projections of a decode step, sgmv at q and o, and
    # paged_attention at the engine's decode lengths
    keys = ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cold")
    kernels[0]["decode_cases"] = [{k: m[k] for k in keys} for m in sgmv_cases[n:2 * n]]
    kernels[1]["decode_cases"] = [{k: m[k] for k in keys} for m in delta_cases[2:]]
    kernels[3]["cold"] = pag["cold"]
    kernels[3]["engine_case"] = {k: pag_cases[1][k] for k in keys}
    # every kernel at the other dense configs' shapes and ranks (phase 3)
    for k in kernels[:6]:
        k["arch_cases"] = [{key: m[key] for key in ("arch", "path") + keys if key in m}
                           for m in arch_cases[k["name"]]]
    # the forward kernels in bf16 (phase 3's bf16 cases; their launches on
    # the bf16 path are launches_by_path["bf16"])
    for k in kernels[:6]:
        k["bf16_cases"] = [{key: m[key] for key in ("arch", "path", "kv_parts") + keys
                            + ("max_abs_err_f32", "one_rounding_excess")
                            if key in m} for m in bf16_cases[k["name"]]]
    # the attention kernels with their log-sum-exp output (phase 3's lse
    # cases: every loop, both dtypes, the time shard's rows of local count 0)
    for k in kernels[2:4]:
        k["lse_cases"] = [m for m in lse_cases if m["kernel"] == k["name"]]
    # the backward kernels' other cases: flash_prefill_bwd at the other
    # configs' heads and over a long row, lora_grad at k/v/o and ranks 1,
    # 12, 128
    for k in kernels[6:8]:
        k["other_cases"] = [{key: m[key] for key in ("arch",) + keys if key in m}
                            for m in bwd_cases[k["name"]][1:]]
    emit({"phase": "total", "seconds": time.perf_counter() - t_script})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
