"""Cache-aware attention (PyTorch counterpart of ``repro.models.attention``):
GQA/MQA with RoPE or Qwen2-VL's M-RoPE, qk-norm, an int8 KV cache, a
logit softcap and a sliding window with its ring of slots, and DeepSeek's
multi-head latent attention (MLA).

Conventions follow the reference: ``p`` is one layer's parameter dict,
``lora`` maps a target to ``(A (slots, d_in, r), B (slots, r, d_out))`` and
``adapter_ids`` (B,) picks the slot per row.

The rotary tables of a step are built once (:func:`step_rope`) and every
layer rotates q and k by them: M-RoPE tables
where the config has ``mrope_sections`` and the caller gives
``mrope_positions`` (3, B, S), as the reference's ``_qkv`` applies
``apply_mrope`` there, and plain RoPE tables at the token positions
otherwise; MLA rotates only its rope slice of q and the shared k_rope.

Kernel routing is the reference's: plain causal GQA goes through
``flash_prefill`` (:func:`gqa_full`) and ``paged_attention`` /
``ragged_extend`` (:func:`gqa_cached`); a window, an int8 cache or a
softcap goes to the plain :func:`sdpa` (or, in ``gqa_full`` with
``q_chunk``, :func:`sdpa_blockwise`), and MLA is einsums and
:func:`sdpa`, as the reference computes them outside every kernel. Every
LoRA-targeted projection goes through ``fused_sgmv`` (:func:`_proj`).
``fused_sgmv`` and ``flash_prefill`` are differentiable (their backward
kernels on the card), so ``gqa_full`` and ``mla_full`` train.

Unlike the reference, which returns a new cache, :func:`gqa_cached` and
:func:`mla_cached` write the new rows into the cache in place. Where they
write is decided once per ``extend`` call by :func:`cached_step`, on the
host: only real tokens of kept rows, and only slots inside the cache (the
reference's scatter drops out-of-range rows without a word; torch
indexing would raise).

Under tensor parallelism (``tp``, the sharded serving steps of
:mod:`repro_torch.distributed.sharded_serve`) the cache is this rank's
shard, as ``cache_specs`` places it. A cache whose kv heads the model axis
divides holds this rank's kv heads, which its query heads attend. One
sharded in time holds the rank's slots [o, o + T/M) of every kv head
(:func:`cached_step` with ``shard``): only the rank that owns a slot writes
it, the query and the new K/V are made whole, every head attends the
local slots through the same kernels with their log-sum-exp (a rank whose
slots all lie past a row's position gets 0 and −inf), and the partials are
merged over the model axis (``TensorParallel.merge``); the cache itself
never crosses it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops as kernel_ops
from .common import (causal_mask, dense_init, init_rms, mrope_tables, rms_norm,
                     rope_tables, rotate, scaled, window_mask)


def _proj(x, w, lora, name, adapter_ids, scale):
    """Base projection plus optional multi-LoRA delta. LoRA-targeted
    projections go through :func:`~repro_torch.kernels.fused_sgmv` (the CUDA
    kernel on the card, its plain version on the CPU); the rest are a plain
    matrix product."""
    if lora is not None and name in lora and adapter_ids is not None:
        a, b = lora[name]
        return kernel_ops.fused_sgmv(x, w, a, b, adapter_ids, scale=scale)
    return x @ w


def _page_size_for(T: int) -> int:
    """Largest preferred page size dividing the cache length."""
    for ps in (128, 64, 32, 16, 8):
        if T % ps == 0:
            return ps
    return 0  # no clean paging — caller falls back to ragged_extend


def step_rope(cfg: ModelConfig, positions: torch.Tensor, mrope_positions=None):
    """The (cos, sin) tables every layer of a step rotates q and k by:
    M-RoPE at ``mrope_positions`` (3, B, S) where the config has sections
    and the caller gives them, else RoPE at ``positions`` (..., S). They
    are as wide as the head dim, or as MLA's ``qk_rope_head_dim`` (MLA
    rotates only that slice of q and the shared k_rope)."""
    hd = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    if cfg.mrope_sections is not None and mrope_positions is not None:
        mpos = torch.as_tensor(mrope_positions).to(positions.device, torch.int64)
        return mrope_tables(mpos, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_tables(positions, hd, cfg.rope_theta)


# =============================================================== GQA / MQA
def init_gqa(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype=torch.float32, device=None) -> dict:
    """Layer-stacked GQA parameters, (n_layers, ...) per leaf."""
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, n_layers
    p = {
        "wq": dense_init(gen, (L, d, cfg.num_heads * hd), dtype, device),
        "wk": dense_init(gen, (L, d, cfg.num_kv_heads * hd), dtype, device),
        "wv": dense_init(gen, (L, d, cfg.num_kv_heads * hd), dtype, device),
        "wo": dense_init(gen, (L, cfg.num_heads * hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, dtype, device).expand(L, hd).contiguous()
        p["k_norm"] = init_rms(hd, dtype, device).expand(L, hd).contiguous()
    return p


def _qkv(p, x, cfg: ModelConfig, rope, lora, adapter_ids, lora_scale, tp=None,
         whole: bool = False, whole_kv: bool = False):
    """q, k, v of one layer; ``rope`` is the step's (cos, sin) tables.
    Under tensor parallelism (``tp``, a
    :class:`~repro_torch.distributed.tensor_parallel.TensorParallel`) they
    hold this rank's heads; every head with ``whole``; k and v every head
    with ``whole_kv``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim

    def proj(h, w, name):
        return _proj(h, w, lora, name, adapter_ids, lora_scale)

    if tp is None:
        q, k, v = (proj(x, p[f"w{t}"], t) for t in "qkv")
        hq, hk = cfg.num_heads, cfg.num_kv_heads
    else:
        (q, k, v), (hq, hk) = tp.qkv(proj, p, x, cfg, whole=whole, whole_kv=whole_kv)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hk, hd)
    v = v.reshape(B, S, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rotate(q, *rope), rotate(k, *rope), v


def _gqa_logits(q: torch.Tensor, k: torch.Tensor, softcap: float) -> torch.Tensor:
    """The scaled (and, with ``softcap``, capped) scores (B, Hkv, G, S, T)
    f32 of q (B, S, Hq, D) against k (B, T, Hkv, D), the query heads
    grouped by their kv head."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, S, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() / math.sqrt(D)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def _partial_softmax(logits: torch.Tensor, valid: torch.Tensor):
    """The softmax of ``logits`` over the ``valid`` entries of the last
    axis, and its log-sum-exp (the partial that ``merge_partials`` of
    :mod:`repro_torch.distributed.tensor_parallel` merges): (weights,
    lse). A row without a valid entry gets weights 0 and lse −inf."""
    lse = torch.logsumexp(torch.where(valid, logits, float("-inf")), dim=-1)
    top = torch.where(torch.isfinite(lse), lse, 0.0)[..., None]
    return torch.where(valid, torch.exp(logits - top), 0.0), lse


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """GQA scaled-dot-product attention, written out (the plain form), with
    the logits capped at ``softcap`` (tanh) where it is set.

    q: (B,S,Hq,D)  k/v: (B,T,Hkv,D)  mask: (B,S,T) or (1,S,T) bool. The v
    head dim may differ from D (MLA).
    """
    B, S, Hq, _ = q.shape
    logits = _gqa_logits(q, k, softcap)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, Hq, v.shape[-1])


def sdpa_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor, softcap: float = 0.0):
    """:func:`sdpa` over a part of the keys, with each query's log-sum-exp
    (B, S, Hq) f32 of its scaled (and capped) scores over the unmasked
    keys, for ``TensorParallel.merge``: a query with no unmasked key gets 0
    and −inf."""
    B, S, Hq, _ = q.shape
    w, lse = _partial_softmax(_gqa_logits(q, k, softcap), mask[:, None, None, :, :])
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v).reshape(B, S, Hq, v.shape[-1])
    return out, lse.permute(0, 3, 1, 2).reshape(B, S, Hq)


def sdpa_blockwise(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    q_pos: torch.Tensor,  # (B, S) int
    k_pos: torch.Tensor,  # (B, T) int
    *,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Memory-efficient causal attention, the reference's ``sdpa_blockwise``
    written in plain PyTorch: query chunks of ``q_chunk`` each walk the key
    chunks of ``k_chunk`` with a running max, sum and accumulator (online
    softmax), so the live logits are (B, Hkv, G, q_chunk, k_chunk), not
    (…, S, T). Under autograd each query chunk runs under
    ``torch.utils.checkpoint``, so the backward recomputes its logits chunk
    by chunk instead of keeping every one. S and T are padded to chunk
    multiples with positions that mask the pads (query −1, key 2^30);
    ``window`` > 0 also masks keys at or past ``window`` behind the query,
    and ``softcap`` caps the logits (tanh)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qc, kc = min(q_chunk, S), min(k_chunk, T)
    pad_s, pad_t = (-S) % qc, (-T) % kc
    ns, nt = (S + pad_s) // qc, (T + pad_t) // kc
    F = torch.nn.functional
    qg = F.pad(q, (0, 0, 0, 0, 0, pad_s)).reshape(B, ns, qc, Hkv, G, D)
    qp = F.pad(q_pos, (0, pad_s), value=-1).reshape(B, ns, qc)
    kk = F.pad(k, (0, 0, 0, 0, 0, pad_t)).reshape(B, nt, kc, Hkv, D)
    vv = F.pad(v, (0, 0, 0, 0, 0, pad_t)).reshape(B, nt, kc, Hkv, D)
    kp = F.pad(k_pos, (0, pad_t), value=2 ** 30).reshape(B, nt, kc)

    def one_q_chunk(qb, qpb):  # (B, qc, Hkv, G, D), (B, qc)
        m = torch.full((B, Hkv, G, qc), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, qc, D), dtype=torch.float32, device=q.device)
        qpm = qpb[:, None, None, :, None]
        for j in range(nt):
            kpb = kp[:, j][:, None, None, None, :]
            s = torch.einsum("bqkgd,btkd->bkgqt", qb.float(), kk[:, j].float()) / math.sqrt(D)
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            mask = kpb <= qpm
            if window > 0:
                mask = mask & (kpb > qpm - window)
            mask = mask & (kpb >= 0)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p_ = torch.exp(s - m_new[..., None])
            l = l * alpha + p_.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p_,
                                                        vv[:, j].float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]  # (B, Hkv, G, qc, D)
        return out.permute(0, 3, 1, 2, 4)  # (B, qc, Hkv, G, D)

    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    outs = [torch.utils.checkpoint.checkpoint(one_q_chunk, qg[:, i], qp[:, i],
                                              use_reentrant=False)
            if grad else one_q_chunk(qg[:, i], qp[:, i]) for i in range(ns)]
    out = torch.cat(outs, dim=1).reshape(B, S + pad_s, Hq, D)[:, :S]
    return out.to(q.dtype)


def gqa_full(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    rope: tuple[torch.Tensor, torch.Tensor],
    cfg: ModelConfig,
    *,
    lora=None,
    adapter_ids=None,
    lora_scale: float = 1.0,
    window: int = 0,
    q_chunk: int = 0,
    tp=None,
    whole_kv: bool = False,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention (train / fresh prefill). ``rope`` is
    the (cos, sin) tables at positions 0 .. S-1, so causality by index is
    causality by position, as the reference's kernel path assumes.

    With M-RoPE, ``rope`` holds its tables (:func:`step_rope`). Plain
    causal attention goes through ``flash_prefill`` in the head-major
    layout (the transposes are views, which the kernel reads by their
    strides). A sliding ``window`` or a logit softcap goes to
    :func:`sdpa_blockwise` with ``q_chunk`` > 0 and to the plain
    :func:`sdpa` without, as the reference routes them. One routing
    difference: the reference's kernel path also leaves plain causal
    attention for ``sdpa_blockwise`` when ``q_chunk`` > 0; here it keeps
    ``flash_prefill``, which is already blockwise (its backward recomputes
    the probabilities tile by tile). Returns ``(out, (k, v))`` with k/v
    ``(B, S, Hkv, D)``, so a caller can seed a decode cache. Under tensor
    parallelism (``tp``) the attention runs on this rank's heads and the o
    projection is completed over the model axis (k/v: this rank's, or
    every kv head with ``whole_kv``, for a cache that holds them all)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, rope, lora, adapter_ids, lora_scale, tp, whole_kv=whole_kv)
    ka, va = k, v
    heads = None if tp is None else tp.heads(cfg)
    if whole_kv and heads is not None:  # this rank's kv heads attend
        ka, va = k[:, :, heads[2]:heads[3]], v[:, :, heads[2]:heads[3]]
    if window == 0 and cfg.logit_softcap == 0.0:
        out = kernel_ops.flash_prefill(
            q.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2)
        ).transpose(1, 2)
    elif q_chunk > 0:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        out = sdpa_blockwise(q, ka, va, pos, pos, window=window,
                             softcap=cfg.logit_softcap, q_chunk=q_chunk,
                             k_chunk=q_chunk)
    else:
        pos = torch.arange(S, device=x.device)
        mask = (window_mask(pos, pos, window) if window > 0
                else causal_mask(pos, pos))
        out = sdpa(q, ka, va, mask[None], cfg.logit_softcap)
    out = out.reshape(B, S, -1)
    if tp is not None:
        return tp.out_proj(lambda h, w, name: _proj(h, w, lora, name, adapter_ids,
                                                    lora_scale), out, p["wo"], cfg), (k, v)
    return _proj(out, p["wo"], lora, "o", adapter_ids, lora_scale), (k, v)


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 quantization of K/V rows: (int8
    values, f32 scales of shape ``x.shape[:-1]``)."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / s[..., None]).clamp(-127, 127)
    return q.to(torch.int8), s


@dataclasses.dataclass
class CachedStep:
    """Where one ``extend`` call reads and writes the dense cache, shared by
    every layer. Index tensors live on the model's device."""

    rope: tuple[torch.Tensor, torch.Tensor]  # (cos, sin): step_rope
    positions: torch.Tensor  # (B, S) int64 — absolute position of each token
    start: torch.Tensor  # (B,) int32 — cache length before the chunk
    true_lens: Optional[torch.Tensor]  # (B,) int32; None: no token mask
    last: torch.Tensor  # (B, 1) int64 — each row's last real position
    dst: torch.Tensor  # (n,) flat b·T + slot of every written token
    src: torch.Tensor  # (n,) flat b·S + s of the same tokens
    restore: Optional[torch.Tensor]  # (m,) flat b·T + slot put back after the step
    window: int  # > 0: sliding window
    ring: bool  # slots are positions modulo T (window == T)
    page_size: int  # > 0: S == 1 without mask decodes through the pages
    tables: Optional[torch.Tensor]  # (B, T / page_size) int32
    lengths: Optional[torch.Tensor]  # (B,) int32 = start + 1 (a shard: its count)
    # a time shard of the cache (``cached_step``'s ``shard``): its first
    # slot, and ragged_extend's view of it (start, true_lens; the queries
    # moved down by ``shift`` where the row's first ones see no local slot)
    offset: int = 0
    time_sharded: bool = False
    rag_start: Optional[torch.Tensor] = None  # (B,) int32 >= 0
    rag_lens: Optional[torch.Tensor] = None  # (B,) int32
    shift: Optional[torch.Tensor] = None  # (B,) int64; None: no row moves


def cached_step(start, S: int, T: int, device, cfg: ModelConfig,
                true_lens=None, keep_rows=None, mrope_positions=None,
                window: int = 0, shard=None) -> CachedStep:
    """Plan one ``extend`` of S tokens per row at offsets ``start``, with
    the rotary tables of ``cfg`` at those positions (M-RoPE at
    ``mrope_positions`` (3, B, S) where given, see :func:`step_rope`).

    ``start``, ``true_lens`` (B,) and ``keep_rows`` (B,) bool are host-side
    values (numpy or CPU tensors; a CUDA tensor is copied to the host), so
    the plan costs no device round trip. A token is written iff it is real
    (``s < true_lens[b]``, or all S without ``true_lens``), its row is kept,
    and its slot lies inside the cache: its position, or with a ``window``
    equal to T the position modulo T (a ring; the reference refuses a
    row-masked chunk wider than the ring, whose pads would land on its own
    writes, and of an unmasked one only the last T tokens survive).

    On an MoE config the rows of a step are coupled (the experts' capacity
    is shared by every token of the batch, pads and idle rows included), so
    a row that is not kept must reach the experts with the hidden states the
    reference gives it: its tokens are written as the reference writes them
    and the slots they overwrote are put back after the step (``restore``).
    On every other config a row's outputs depend on that row alone, and an
    unkept row is simply not written.

    ``shard`` (o, n): the cache holds slots [o, o + n) of the T slots (a
    time shard under tensor parallelism). Only the tokens whose slot lies
    there are written, at slot − o; the pages and ``lengths`` count the
    local slots a query sees, clamp(start + 1 − o, 0, n); ragged_extend
    sees start − o, and a row whose first queries precede o has them moved
    down (``shift``) so that its start is 0."""
    start_h = torch.as_tensor(start).to("cpu", torch.int64)
    B = start_h.shape[0]
    ar = torch.arange(S)
    pos = start_h[:, None] + ar[None, :]  # (B, S)
    ring = window > 0 and T == window
    if ring:
        if true_lens is not None and S > window:
            raise ValueError(
                f"row-masked chunk of {S} tokens exceeds ring window {window}")
        slots = pos % window
        write = (ar >= S - window)[None, :].expand(B, S).clone()
    else:
        slots = pos
        write = pos < T
    if true_lens is not None:
        tl_h = torch.as_tensor(true_lens).to("cpu", torch.int64)
        write &= ar[None, :] < tl_h[:, None]
        last = start_h + tl_h.clamp_min(1) - 1
    else:
        last = pos[:, -1]
    o, n_local = (0, T) if shard is None else shard
    if shard is not None:
        write &= (slots >= o) & (slots < o + n_local)
    restore = None
    if keep_rows is not None:
        keep = torch.as_tensor(keep_rows).to("cpu", torch.bool)
        if cfg.moe is not None:
            rb, rs = (write & ~keep[:, None]).nonzero(as_tuple=True)
            if len(rb):
                restore = rb * n_local + slots[rb, rs] - o
        else:
            write &= keep[:, None]
    b_idx, s_idx = write.nonzero(as_tuple=True)
    ps = _page_size_for(n_local) if (S == 1 and true_lens is None) else 0
    tables = lengths = None
    if ps:
        pages = n_local // ps
        tables = torch.arange(B * pages, dtype=torch.int32).reshape(B, pages)
        lengths = (start_h + 1 - o).clamp(0, n_local).to(torch.int32)
    rag_start = rag_lens = shift = None
    if shard is not None:
        local = start_h - o
        sh = (-local).clamp(0, S)
        n_real = tl_h if true_lens is not None else torch.full((B,), S)
        rag_start = (local + sh).to(torch.int32)
        rag_lens = (n_real - sh).clamp_min(0).to(torch.int32)
        shift = sh if bool(sh.any()) else None

    def dev(t):
        return None if t is None else t.to(device, non_blocking=True)

    pos_d = dev(pos)
    return CachedStep(
        rope=step_rope(cfg, pos_d, mrope_positions),
        positions=pos_d,
        start=dev(start_h.to(torch.int32)),
        true_lens=None if true_lens is None else dev(tl_h.to(torch.int32)),
        last=dev(last[:, None]),
        dst=dev(b_idx * n_local + slots[b_idx, s_idx] - o),
        src=dev(b_idx * S + s_idx),
        restore=dev(restore),
        window=window,
        ring=ring,
        page_size=ps,
        tables=dev(tables),
        lengths=dev(lengths),
        offset=o,
        time_sharded=shard is not None,
        rag_start=dev(rag_start),
        rag_lens=dev(rag_lens),
        shift=dev(shift),
    )


def _write(step: CachedStep, pairs) -> list:
    """Write each ``(cache (B, T, ...), new (B, S, ...))`` pair as ``step``
    says, in place; returns what the writes overwrote at ``step.restore``
    (see :func:`cached_step`), for :func:`_restore`."""
    saved = []
    for cache, new in pairs:
        B, T = cache.shape[:2]
        flat = cache.view(B * T, *cache.shape[2:])
        if step.restore is not None:
            saved.append(flat.index_select(0, step.restore))
        S = new.shape[1]
        flat.index_copy_(0, step.dst, new.reshape(B * S, *new.shape[2:])
                         .index_select(0, step.src).to(cache.dtype))
    return saved


def _restore(step: CachedStep, caches, saved) -> None:
    for cache, old in zip(caches, saved):
        B, T = cache.shape[:2]
        cache.view(B * T, *cache.shape[2:]).index_copy_(0, step.restore, old)


def _key_positions(step: CachedStep, T: int) -> torch.Tensor:
    """(B, T) absolute position of each of the T local cache slots (slot
    ``step.offset`` + j): the slot index, or on a ring the largest position
    <= the row's last real one that maps to the slot. Under a token mask
    the trailing pads wrote nothing, so the labels anchor on each row's
    last REAL position (``step.last``)."""
    j = step.offset + torch.arange(T, device=step.last.device)[None, :]
    if step.ring:
        return step.last - ((step.last - j) % step.window)
    return j.expand(step.last.shape[0], T)


def gqa_cached(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    step: CachedStep,
    cache_k: torch.Tensor,  # (B, T, Hkv, D), f32 or int8 — updated in place
    cache_v: torch.Tensor,
    cfg: ModelConfig,
    *,
    lora=None,
    adapter_ids=None,
    lora_scale: float = 1.0,
    cache_k_scale: Optional[torch.Tensor] = None,  # (B, T, Hkv): int8 KV
    cache_v_scale: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """Suffix attention against the dense cache (decode S=1, or chunked
    prefill). Writes the chunk's K/V into the cache as ``step`` says (int8
    with per-(token, head) scales where the scale arrays are given; ring
    slots under ``step.ring``), then attends on the reference's own routing
    (``repro.models.attention.gqa_cached``). Plain causal attention goes
    through the kernels: S == 1 without a token mask and a page size
    dividing T decodes through ``paged_attention`` over the cache viewed as
    contiguous pages (tables = arange, lengths = start + 1), every other
    case through ``ragged_extend``. A sliding window, an int8 cache
    (dequantised first) or a logit softcap goes to the plain :func:`sdpa`
    over the whole cache, with keys past each row's last real position
    masked.

    Under tensor parallelism (``tp``) the cache is this rank's shard: of
    its kv heads, which its query heads attend; or of every kv head (a time
    shard, ``step.time_sharded``, or a replicated cache), which every query
    head attends, a time shard's partials merged over the model axis, and
    the rank keeps its heads for ``wo``'s row shard."""
    B, S, _ = x.shape
    T, Hkv, Dh = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    quant = cache_k_scale is not None
    whole = tp is not None and Hkv == cfg.num_kv_heads
    q, k, v = _qkv(p, x, cfg, step.rope, lora, adapter_ids, lora_scale, tp, whole)
    if quant:
        (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        caches = (cache_k, cache_v, cache_k_scale, cache_v_scale)
        saved = _write(step, zip(caches, (kq, vq, ks, vs)))
        k_eff = cache_k.to(x.dtype) * cache_k_scale[..., None].to(x.dtype)
        v_eff = cache_v.to(x.dtype) * cache_v_scale[..., None].to(x.dtype)
    else:
        caches = (cache_k, cache_v)
        saved = _write(step, zip(caches, (k, v)))
        k_eff, v_eff = cache_k, cache_v
    use_kernels = step.window == 0 and not quant and cfg.logit_softcap == 0.0
    lse = None
    if use_kernels and S == 1 and step.true_lens is None and step.page_size > 0:
        pages = T // step.page_size
        out = kernel_ops.paged_attention(
            q[:, 0],
            k_eff.view(B * pages, step.page_size, Hkv, Dh),
            v_eff.view(B * pages, step.page_size, Hkv, Dh),
            step.tables,
            step.lengths,
            return_lse=step.time_sharded,
        )
        if step.time_sharded:
            out, lse = out[0], out[1][:, None]
        out = out[:, None]
    elif use_kernels and step.time_sharded:
        out, lse = _ragged_shard(q, k_eff, v_eff, step)
    elif use_kernels and S == 1 and step.true_lens is None:
        out = kernel_ops.ragged_extend(
            q, k_eff, v_eff, step.start,
            torch.ones_like(step.start))
    elif use_kernels:
        true_lens = step.true_lens
        if true_lens is None:
            true_lens = torch.full_like(step.start, S)
        out = kernel_ops.ragged_extend(q, k_eff, v_eff, step.start, true_lens)
    else:
        kpos = _key_positions(step, T)
        valid = (kpos <= step.last) & (kpos >= 0)
        if step.window > 0:
            mask = window_mask(step.positions, kpos, step.window) & valid[:, None, :]
        else:
            mask = causal_mask(step.positions, kpos, valid)
        if step.time_sharded:
            out, lse = sdpa_lse(q, k_eff, v_eff, mask, cfg.logit_softcap)
        else:
            out = sdpa(q, k_eff, v_eff, mask, cfg.logit_softcap)
    if saved:
        _restore(step, caches, saved)
    if lse is not None:
        out = tp.merge(out, lse)
    if whole:  # fused_sgmv takes a contiguous x
        out = tp.own_heads(out, cfg).contiguous()
    out = out.reshape(B, S, -1)
    if tp is not None:
        return tp.out_proj(lambda h, w, name: _proj(h, w, lora, name, adapter_ids,
                                                    lora_scale), out, p["wo"], cfg)
    return _proj(out, p["wo"], lora, "o", adapter_ids, lora_scale)


def _ragged_shard(q, k, v, step: CachedStep):
    """``ragged_extend`` of q (B, S, H, D) over a time shard of the cache,
    with its log-sum-exp: the kernel sees start − o (``step.rag_start``);
    a row whose first queries precede the shard has its queries moved down
    by ``step.shift`` for the launch and back after it, those first ones
    coming out as 0 and −inf."""
    S = q.shape[1]
    ar = torch.arange(S, device=q.device)[None, :]
    if step.shift is not None:
        src = (ar + step.shift[:, None]).clamp_max(S - 1)
        q = q.gather(1, src[:, :, None, None].expand_as(q))
    out, lse = kernel_ops.ragged_extend(q, k, v, step.rag_start, step.rag_lens,
                                        return_lse=True)
    if step.shift is not None:
        back = ar - step.shift[:, None]
        seen = back >= 0
        back = back.clamp_min(0)
        out = torch.where(seen[..., None, None],
                          out.gather(1, back[:, :, None, None].expand_as(out)), 0.0)
        lse = torch.where(seen[..., None], lse.gather(1, back[:, :, None].expand_as(lse)),
                          float("-inf"))
    return out, lse


# ====================================================================== MLA
def init_mla(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype=torch.float32, device=None) -> dict:
    """Layer-stacked DeepSeek-V2 latent attention parameters."""
    m = cfg.mla
    if m is None:
        raise ValueError("init_mla requires cfg.mla to be configured")
    d, H, L = cfg.d_model, cfg.num_heads, n_layers
    return {
        "wq": dense_init(gen, (L, d, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                         dtype, device),
        "w_kv_a": dense_init(gen, (L, d, m.kv_lora_rank + m.qk_rope_head_dim),
                             dtype, device),
        "kv_norm": init_rms(m.kv_lora_rank, dtype, device).expand(
            L, m.kv_lora_rank).contiguous(),
        "w_kv_b": dense_init(gen, (L, m.kv_lora_rank,
                                   H * (m.qk_nope_head_dim + m.v_head_dim)),
                             dtype, device),
        "wo": dense_init(gen, (L, H * m.v_head_dim, d), dtype, device),
    }


def _mla_q(p, x, cfg: ModelConfig, rope, lora, adapter_ids, lora_scale, tp=None,
           part=None):
    """(q_nope, q_rope) (B, S, H, ·); ``rope`` is the rope slice's width.
    Under ``tp``, the heads ``part`` (None: all)."""
    m = cfg.mla
    B, S, _ = x.shape
    width = m.qk_nope_head_dim + m.qk_rope_head_dim
    if tp is None:
        q = _proj(x, p["wq"], lora, "q", adapter_ids, lora_scale)
    else:
        q = tp.column(lambda h, w: _proj(h, w, lora, "q", adapter_ids, lora_scale), x,
                      p["wq"], cfg.num_heads * width, scaled(part, width))
    q = q.reshape(B, S, -1, width)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, rotate(q_rope, *rope)


def _mla_latent(p, x, cfg: ModelConfig, rope, lora, adapter_ids, lora_scale):
    """The normed latent (B, S, kv_lora) and the shared rotated k_rope
    (B, S, rope)."""
    m = cfg.mla
    ckv = _proj(x, p["w_kv_a"], lora, "kv_a", adapter_ids, lora_scale)
    latent = rms_norm(ckv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = rotate(ckv[..., m.kv_lora_rank:][:, :, None, :], *rope)[:, :, 0, :]
    return latent, k_rope


def mla_full(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    rope: tuple[torch.Tensor, torch.Tensor],
    cfg: ModelConfig,
    *,
    lora=None,
    adapter_ids=None,
    lora_scale: float = 1.0,
    tp=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence MLA in the expanded form (the reference's
    ``mla_full``): the latent is up-projected to per-head K and V and
    attended through the plain :func:`sdpa` (score scale 1/√(nope + rope);
    the v head dim differs), as the reference computes it outside every
    kernel. Returns ``(out, (latent, k_rope))``, the cache's layout.

    Under tensor parallelism (``tp``) the latent and k_rope are computed
    whole on every rank (``w_kv_a`` and its LoRA are replicated), then each
    rank up-projects and attends over its heads where the axis divides
    them (``wq`` and ``w_kv_b`` column shards hold whole heads; the shared
    k_rope enters them through ``copy_to``) and ``wo``'s partial sums are
    completed over the axis."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    part = None if tp is None else tp.units(H)
    q_nope, q_rope = _mla_q(p, x, cfg, rope, lora, adapter_ids, lora_scale, tp, part)
    latent, k_rope = _mla_latent(p, x, cfg, rope, lora, adapter_ids, lora_scale)
    kv_width = m.qk_nope_head_dim + m.v_head_dim
    if tp is None:
        kv = latent @ p["w_kv_b"]
    else:
        kv = tp.column(torch.matmul, latent, p["w_kv_b"], H * kv_width,
                       scaled(part, kv_width))
        if part is not None:
            k_rope = tp.fan(k_rope)
    kv = kv.reshape(B, S, -1, kv_width)
    Hl = kv.shape[2]
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, Hl, m.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    pos = torch.arange(S, device=x.device)
    out = sdpa(q, k, v, causal_mask(pos, pos)[None]).reshape(B, S, -1)
    if tp is not None:
        out = tp.row(lambda h, w: _proj(h, w, lora, "o", adapter_ids, lora_scale), out,
                     p["wo"], H * m.v_head_dim, scaled(part, m.v_head_dim))
        return out, (latent, k_rope)
    return _proj(out, p["wo"], lora, "o", adapter_ids, lora_scale), (latent, k_rope)


def mla_cached(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    step: CachedStep,
    cache_latent: torch.Tensor,  # (B, T, kv_lora) — updated in place
    cache_krope: torch.Tensor,  # (B, T, rope)
    cfg: ModelConfig,
    *,
    lora=None,
    adapter_ids=None,
    lora_scale: float = 1.0,
    tp=None,
) -> torch.Tensor:
    """Cached MLA in the ABSORBED form (the reference's ``mla_cached``):
    ``w_kv_b`` folds into the query and output sides, so the step attends
    the compressed latent directly. The chunk's latent and k_rope are
    written in place through ``step`` (its rope tables are
    ``qk_rope_head_dim`` wide); keys past each row's last real position are
    masked.

    Under tensor parallelism (``tp``) each rank absorbs its heads' query
    (``wq`` and ``w_kv_b`` column shards) and, on a time shard of the
    latent (``step.time_sharded``), gathers every head's absorbed query,
    attends its slots with the log-sum-exp and merges the partials over the
    model axis; then its heads' context meets ``w_kv_b``'s value side and
    ``wo``'s row shard."""
    m = cfg.mla
    B, S, _ = x.shape
    H, T = cfg.num_heads, cache_latent.shape[1]
    part = None if tp is None else tp.units(H)
    q_nope, q_rope = _mla_q(p, x, cfg, step.rope, lora, adapter_ids, lora_scale, tp, part)
    latent, k_rope = _mla_latent(p, x, cfg, step.rope, lora, adapter_ids, lora_scale)
    caches = (cache_latent, cache_krope)
    saved = _write(step, zip(caches, (latent, k_rope)))
    width = m.qk_nope_head_dim + m.v_head_dim
    w_kv_b = p["w_kv_b"]
    if tp is not None:  # the columns of this rank's heads (all of them where part is None)
        h0, h1 = (0, H) if part is None else part
        if w_kv_b.shape[-1] not in (H * width, (h1 - h0) * width):
            w_kv_b = tp.gather(w_kv_b)
        if w_kv_b.shape[-1] == H * width:
            w_kv_b = w_kv_b[..., h0 * width:h1 * width]
    w_b = w_kv_b.reshape(m.kv_lora_rank, -1, width)
    w_bk, w_bv = w_b[..., :m.qk_nope_head_dim], w_b[..., m.qk_nope_head_dim:]
    q_eff = torch.einsum("bshn,lhn->bshl", q_nope, w_bk)
    if step.time_sharded and part is not None:  # every head attends this rank's slots
        q_eff, q_rope = tp.gather(q_eff, dim=2), tp.gather(q_rope, dim=2)
    scores = torch.einsum("bshl,btl->bhst", q_eff, cache_latent)
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope, cache_krope)
    scores = scores.float() / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    kpos = _key_positions(step, T)
    mask = causal_mask(step.positions, kpos, kpos <= step.last)  # (B, S, T)
    if step.time_sharded:
        w, lse = _partial_softmax(scores, mask[:, None])
        ctx = tp.merge(torch.einsum("bhst,btl->bshl", w.to(x.dtype), cache_latent),
                       lse.transpose(1, 2))
        if part is not None:
            ctx = ctx[:, :, part[0]:part[1]]
    else:
        scores = torch.where(mask[:, None], scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btl->bshl", w, cache_latent)
    if saved:
        _restore(step, caches, saved)
    out = torch.einsum("bshl,lhv->bshv", ctx, w_bv).reshape(B, S, -1)
    if tp is not None:
        return tp.row(lambda h, w: _proj(h, w, lora, "o", adapter_ids, lora_scale), out,
                      p["wo"], H * m.v_head_dim, scaled(part, m.v_head_dim))
    return _proj(out, p["wo"], lora, "o", adapter_ids, lora_scale)
