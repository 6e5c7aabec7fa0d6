"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor operations. Every input is widened to float32 (float64 stays) and
every intermediate is kept there; only the output takes the input's dtype,
as the reference's kernels compute on bf16 inputs. The wrappers in
``kernels/`` take these for tensors that lie on the CPU (the tests), and
``chip_smoke.py`` holds every CUDA kernel against them on the card. Nothing on the main path calls them while a card
is present.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the dtype the plain versions sum in: float32, or float64
    for a float64 input (the tests hold the backward versions against
    autograd in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def sgmv_ref(
    x: torch.Tensor,  # (B, S, d_in)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float = 1.0,
) -> torch.Tensor:
    """Multi-LoRA delta alone: ``scale·(x·A[id])·B[id]``.

    A negative id gives a zero delta; the id is clamped only for the
    gather."""
    return _delta(x, lora_a, lora_b, adapter_ids, scale).to(x.dtype)


def _delta(x, lora_a, lora_b, adapter_ids, scale):
    """The delta of :func:`sgmv_ref` in the summing dtype: h = x·A kept
    there and B promoted, as the reference's kernel does on bf16 inputs."""
    ids = adapter_ids.long()
    safe = ids.clamp(min=0)
    h = torch.einsum("bsd,bdr->bsr", _acc(x), _acc(lora_a[safe]))
    delta = torch.einsum("bsr,bro->bso", h, _acc(lora_b[safe])) * scale
    return delta * (ids >= 0).to(delta.dtype)[:, None, None]


def fused_sgmv_ref(
    x: torch.Tensor,  # (B, S, d_in)
    w: torch.Tensor,  # (d_in, d_out)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float = 1.0,
) -> torch.Tensor:
    """Fused base + LoRA projection: ``x·W + scale·(x·A[id])·B[id]``.

    A negative id keeps the base term and drops the delta. The sum is
    rounded to x's dtype once: the delta is not rounded first."""
    base = torch.einsum("bsd,do->bso", _acc(x), _acc(w))
    return (base + _delta(x, lora_a, lora_b, adapter_ids, scale)).to(x.dtype)


def ragged_extend_ref(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    start: torch.Tensor,  # (B,) int
    true_lens: torch.Tensor,  # (B,) int
    return_lse: bool = False,
):
    """Suffix attention against the cache; padded query positions are zero.

    Query ``s`` of row ``b`` attends cache positions
    ``0 .. start[b] + s`` for ``s < true_lens[b]``. With ``return_lse``
    also each query's log-sum-exp (B, S, H) f32 of its scaled scores
    (:func:`lse_of`): −inf for a padded query or one without a key."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    start = start.to(dev).long()
    true_lens = true_lens.to(dev).long()
    qg = _acc(q).reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, _acc(k)) / math.sqrt(D)
    q_pos = start[:, None] + torch.arange(S, device=dev)  # (B, S)
    k_pos = torch.arange(T, device=dev)
    valid = (k_pos[None, None, :] <= q_pos[:, :, None]) & (
        k_pos[None, None, :] < (start + true_lens)[:, None, None]
    )  # (B, S, T)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid[:, None, None], w, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", w, _acc(v))
    live = torch.arange(S, device=dev)[None, :] < true_lens[:, None]  # (B, S)
    out = out * live[:, :, None, None, None]
    out = out.reshape(B, S, H, D).to(q.dtype)
    if not return_lse:
        return out
    valid = valid & live[:, :, None]
    lse = lse_of(logits, valid[:, None, None])  # (B, Hkv, G, S)
    return out, lse.permute(0, 3, 1, 2).reshape(B, S, H)


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (P, page_size, Hkv, D)
    v_pages: torch.Tensor,  # (P, page_size, Hkv, D)
    block_tables: torch.Tensor,  # (B, pages_per_seq) int
    lengths: torch.Tensor,  # (B,) int — tokens in each sequence
    return_lse: bool = False,
):
    """Single-token decode attention over a paged KV pool. A row whose
    length is 0 emits zeros, not mean(V). With ``return_lse`` also each
    query's log-sum-exp (B, H) f32 of its scaled scores (:func:`lse_of`):
    −inf for a row of length 0."""
    B, H, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    G = H // Hkv
    dev = q.device
    tables = block_tables.to(dev).long()
    lengths = lengths.to(dev).long()
    T = pages_per_seq * page
    k = k_pages[tables].reshape(B, T, Hkv, D).float()
    v = v_pages[tables].reshape(B, T, Hkv, D).float()
    qg = _acc(q).reshape(B, Hkv, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(D)
    valid = torch.arange(T, device=dev)[None, :] < lengths[:, None]  # (B, T)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(valid[:, None, None, :], w, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", w, v).reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    return out, lse_of(logits, valid[:, None, None, :]).reshape(B, H)


def lse_of(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The natural log of the softmax's denominator over the last dim,
    ``m + log(l)`` in the units of the scaled scores, over the ``valid``
    keys only, in f32: −inf where a row has no valid key."""
    x = torch.where(valid, logits, float("-inf"))
    return torch.logsumexp(x, dim=-1).float()

def flash_prefill_ragged_ref(
    q: torch.Tensor,  # (B, H, S, D) — S is the padded length
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    true_lens: torch.Tensor,  # (B,) int — live tokens per row (may be 0)
) -> torch.Tensor:
    """Causal attention over padded rows in the head-major layout; padded
    query positions and rows of length 0 are zeros. This is
    :func:`ragged_extend_ref` of a fresh sequence (start 0, T = S)."""
    start = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    out = ragged_extend_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), start, true_lens)
    return out.transpose(1, 2)


def flash_prefill_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
) -> torch.Tensor:
    """Causal full-sequence GQA attention (fresh prefill)."""
    B, _, S, _ = q.shape
    full = torch.full((B,), S, dtype=torch.int64, device=q.device)
    return flash_prefill_ragged_ref(q, k, v, full)


def flash_prefill_lse_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
) -> torch.Tensor:
    """Each query's log-sum-exp (B, H, S) of its causal scores times 1/√D,
    as ``flash_prefill`` writes it for the backward pass."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    qg = _acc(q).reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, _acc(k)) / math.sqrt(D)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_prefill_bwd_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    o: torch.Tensor,  # (B, H, S, D) — the forward's output
    lse: torch.Tensor,  # (B, H, S) — :func:`flash_prefill_lse_ref`
    do: torch.Tensor,  # (B, H, S, D) — the gradient of o
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_prefill_ref`, written out:
    ``P = exp(Q·Kᵀ/√D − lse)`` (causal), ``Δ = rowsum(dO ∘ O)``,
    ``dV = Pᵀ·dO``, ``dS = P ∘ (dO·Vᵀ − Δ)``, ``dQ = dS·K/√D`` and
    ``dK = dSᵀ·Q/√D``, with dK and dV summed over the G query heads of a
    kv head. Returns (dq, dk, dv) in the shapes and dtypes of q, k, v."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = _acc(q).reshape(B, Hkv, G, S, D)
    og = _acc(o).reshape(B, Hkv, G, S, D)
    dog = _acc(do).reshape(B, Hkv, G, S, D)
    kf, vf = _acc(k), _acc(v)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    p = torch.where(causal, torch.exp(s - _acc(lse).reshape(B, Hkv, G, S, 1)), 0.0)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def lora_grad_ref(
    x: torch.Tensor,  # (B, S, d_in)
    dy: torch.Tensor,  # (B, S, d_out) — the gradient of the output
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float,
):
    """The adapter-indexed part of the backward of :func:`fused_sgmv_ref`,
    written out: with ``h = x·A[id]`` and ``g = dy·B[id]ᵀ`` over the rows
    of a live id, the delta of dx ``scale·g·A[id]ᵀ``, ``dA[n] =
    scale·Σ_{b: id_b = n} x_bᵀ·g_b`` and ``dB[n] = scale·Σ_{b: id_b = n}
    h_bᵀ·dy_b``. A negative id adds nothing to any of them. Returns
    (dx delta, da, db)."""
    ids = adapter_ids.to(x.device).long()
    safe = ids.clamp(min=0)
    xf, dyf = _acc(x), _acc(dy)
    live = (ids >= 0)[:, None, None].to(xf.dtype)
    a_rows, b_rows = _acc(lora_a[safe]), _acc(lora_b[safe])
    h = torch.einsum("bsd,bdr->bsr", xf, a_rows) * live
    g = torch.einsum("bso,bro->bsr", dyf, b_rows) * live
    dx = scale * torch.einsum("bsr,bdr->bsd", g, a_rows)
    da = torch.zeros(lora_a.shape, dtype=xf.dtype, device=x.device).index_add_(
        0, safe, scale * torch.einsum("bsd,bsr->bdr", xf, g))
    db = torch.zeros(lora_b.shape, dtype=xf.dtype, device=x.device).index_add_(
        0, safe, scale * torch.einsum("bsr,bso->bro", h, dyf))
    return dx, da.to(lora_a.dtype), db.to(lora_b.dtype)


def fused_sgmv_bwd_ref(
    x: torch.Tensor,  # (B, S, d_in)
    w: torch.Tensor,  # (d_in, d_out)
    lora_a: torch.Tensor,  # (N, d_in, r)
    lora_b: torch.Tensor,  # (N, r, d_out)
    adapter_ids: torch.Tensor,  # (B,) int — negative marks a base-model row
    scale: float,
    dy: torch.Tensor,  # (B, S, d_out) — the gradient of the output
    need_dw: bool = True,
):
    """The backward of :func:`fused_sgmv_ref`, written out: ``dx = dy·Wᵀ``
    plus the delta of :func:`lora_grad_ref`, ``dW = Σ_b x_bᵀ·dy_b`` (None
    unless ``need_dw``), and dA, dB of :func:`lora_grad_ref`. Returns (dx,
    dw, da, db)."""
    delta, da, db = lora_grad_ref(x, dy, lora_a, lora_b, adapter_ids, scale)
    dx = _acc(dy) @ _acc(w).T + delta
    dw = None
    if need_dw:
        dw = torch.einsum("bsd,bso->do", _acc(x), _acc(dy)).to(w.dtype)
    return dx.to(x.dtype), dw, da, db
