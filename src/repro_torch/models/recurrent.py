"""Recurrent mixers (PyTorch counterpart of ``repro.models.recurrent``):
RWKV-6 (Finch) time and channel mix, and Griffin's RG-LRU block.

Both carry an O(1) state per row instead of a per-token KV cache; the
serving engine caches it at prefix boundaries as state snapshots
(:mod:`repro_torch.kvcache.state_cache`). The reference's simplifications
hold here too: RWKV-6 has the data-dependent decay LoRA but a static
token-shift lerp for r/k/v/g; RG-LRU has full dense gates.

Routing. RWKV's LoRA targets r, k, v and o go through
:func:`~repro_torch.kernels.fused_sgmv` (``attention._proj``), where the
reference adds its gather einsum ``lora_delta`` to a plain product: the
kernel computes the same function (a negative id is a base-model row), and
the plain version of the einsum would keep the card's main path off the
kernel. Every other product is a plain matrix product, as in the
reference. The recurrences are plain PyTorch: the WKV scan is a loop over
time (the reference's ``lax.scan``), the RG-LRU's linear recurrence a
Hillis–Steele scan over log2(S + 1) doubling steps (the reference's
``associative_scan``; the sums group differently, within 1e-6 in f32).

Per-row masks (``token_mask`` (B, S) bool, real tokens first) follow the
reference: pad steps leave the WKV state and the RG-LRU state as they were
(the identity step a = 1, b = 0), the token-shift anchors are each row's
last real token (a row with none keeps its carried anchor), and the conv
carry is the window that ends at each row's last real token.

Weights are layer-stacked, (n_layers, ...) per leaf, in the reference's
tree: RWKV's ``{mu_r, mu_k, mu_v, mu_g, mu_w, w0, wa, wb, u, wr, wk, wv, wg,
wo, ln_x, mu_ck, mu_cr, w_ck, w_cv, w_cr}``, RG-LRU's ``{w_in, w_gel,
conv_w, conv_b, w_a, b_a, w_i, b_i, lam, w_out}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .attention import _proj
from .common import dense_init, scaled


# ================================================================== RWKV-6
def init_rwkv_layers(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                     dtype=torch.float32, device=None) -> dict:
    """Layer-stacked RWKV-6 weights. Unlike the reference, whose bonus
    ``u`` starts at zero, ``u`` is drawn (normal, 0.1): with random
    weights a fault in the bonus term then shows in the outputs."""
    r = cfg.rwkv
    if r is None:
        raise ValueError("init_rwkv_layers requires cfg.rwkv to be configured")
    d, L = cfg.d_model, n_layers
    H, N = d // r.head_dim, r.head_dim

    def lerp():
        u = torch.rand((L, d), generator=gen, device=gen.device) * 0.5
        return u.to(device=device, dtype=dtype)

    def dense(d_in, d_out):
        return dense_init(gen, (L, d_in, d_out), dtype, device)

    bonus = torch.randn((L, H, N), generator=gen, device=gen.device) * 0.1
    return {
        "mu_r": lerp(), "mu_k": lerp(), "mu_v": lerp(), "mu_g": lerp(),
        "mu_w": lerp(),
        "w0": torch.full((L, d), -6.0, dtype=dtype, device=device),
        "wa": dense(d, r.decay_rank), "wb": dense(r.decay_rank, d),
        "u": bonus.to(device=device, dtype=dtype),
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        "ln_x": torch.zeros((L, d), dtype=dtype, device=device),
        "mu_ck": lerp(), "mu_cr": lerp(),
        "w_ck": dense(d, cfg.d_ff), "w_cv": dense(cfg.d_ff, d), "w_cr": dense(d, d),
    }


def rwkv_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None, n_layers: int | None = None) -> dict:
    """Zero RWKV state of ``batch`` rows: {"tm_x", "wkv" (f32), "cm_x"},
    with a leading layer axis of ``n_layers`` where given."""
    r = cfg.rwkv
    d = cfg.d_model
    H, N = d // r.head_dim, r.head_dim
    lead = () if n_layers is None else (n_layers,)
    return {
        "tm_x": torch.zeros((*lead, batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((*lead, batch, H, N, N), dtype=torch.float32,
                           device=device),
        "cm_x": torch.zeros((*lead, batch, d), dtype=dtype, device=device),
    }


def _last_real(x: torch.Tensor, state_x: torch.Tensor,
               token_mask: torch.Tensor) -> torch.Tensor:
    """Each row's last real token (B, d), the next chunk's token-shift
    anchor; a row with no real token keeps its carried ``state_x``."""
    n_real = token_mask.sum(dim=1)  # (B,)
    idx = (n_real - 1).clamp_min(0)
    last = x[torch.arange(x.shape[0], device=x.device), idx]
    return torch.where((n_real > 0)[:, None], last, state_x)


def _shifted(x: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """The previous token of every position: ``carry`` (B, d), then x."""
    return torch.cat([carry[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_time_mix(p, x, state, cfg: ModelConfig, lora, adapter_ids,
                  lora_scale: float, token_mask=None, tp=None):
    """RWKV-6 time mix of x (B, S, d) from ``state``; returns (out, new
    state). The WKV recurrence S_t = w_t ⊙ S_{t-1} + k_t v_tᵀ runs as a
    loop over time with y_t = r_t·S_{t-1} + (r_t·(u ⊙ k_t)) v_t, the
    reference's r_t·(S_{t-1} + u ⊙ k_t v_tᵀ) with the bonus term taken out
    of the loop. A pad step is w = 1, k = 0: the state passes unchanged,
    exactly.

    Under tensor parallelism (``tp``) the heads are independent, so where
    the axis divides them each rank runs its own: r, k, v and g from the
    column shards, its heads of ``u``, ``ln_x`` and the decay (``w0`` and
    ``wb`` cut by ``TensorParallel.prepare``), its heads of the WKV state
    (a whole state is cut; a serving cache holds them already, as
    ``cache_specs`` shards ``wkv``), and ``wo``'s partial sums completed
    over the axis."""
    r = cfg.rwkv
    B, S, d = x.shape
    H, N = d // r.head_dim, r.head_dim
    part = None if tp is None else tp.units(H)
    cols = scaled(part, N)
    dx = _shifted(x, state["tm_x"]) - x

    def mix(mu):
        return x + dx * mu

    def col(h, w, name):
        if tp is None:
            return _proj(h, w, lora, name, adapter_ids, lora_scale)
        return tp.column(lambda a, b: _proj(a, b, lora, name, adapter_ids, lora_scale),
                         h, w, d, cols)

    rr = col(mix(p["mu_r"]), p["wr"], "r")
    kk = col(mix(p["mu_k"]), p["wk"], "k")
    vv = col(mix(p["mu_v"]), p["wv"], "v")
    gg = F.silu(col(mix(p["mu_g"]), p["wg"], "g"))
    H = rr.shape[-1] // N  # this rank's heads
    # data-dependent decay (Finch): w_t = exp(-exp(w0 + lora_w(x_w)))
    w_low = mix(p["mu_w"]) @ p["wa"]
    if part is not None:  # into this rank's columns of wb
        w_low = tp.fan(w_low)
    w_log = p["w0"].float() + (w_low @ p["wb"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(B, S, H, N)
    rr = rr.reshape(B, S, H, N).float()
    kk = kk.reshape(B, S, H, N).float()
    vv = vv.reshape(B, S, H, N).float()
    bonus = (rr * p["u"].float() * kk).sum(-1, keepdim=True) * vv  # (B,S,H,N)
    if token_mask is not None:
        m = token_mask[:, :, None, None]
        w = torch.where(m, w, 1.0)
        kk = torch.where(m, kk, 0.0)
    wkv0 = state["wkv"]
    if part is not None and wkv0.shape[1] != H:  # a whole state: this rank's heads
        wkv0 = wkv0[:, part[0]:part[1]]
    y, wkv = wkv_scan(rr, kk, vv, w, wkv0)
    y = y + bonus  # (B, S, H, N)
    # per-head group norm
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-5)
    y = y.reshape(B, S, H * N) * (1.0 + p["ln_x"].float())
    y = (y * gg.float()).to(x.dtype)
    if tp is None:
        out = _proj(y, p["wo"], lora, "o", adapter_ids, lora_scale)
    else:
        out = tp.row(lambda a, b: _proj(a, b, lora, "o", adapter_ids, lora_scale), y,
                     p["wo"], d, cols)
    tm_x = (x[:, -1, :] if token_mask is None
            else _last_real(x, state["tm_x"], token_mask))
    return out, {"tm_x": tm_x, "wkv": wkv, "cm_x": state["cm_x"]}


def wkv_scan(r, k, v, w, wkv):
    """The WKV recurrence over time, one step after another: y_t =
    r_t·S_{t-1} and S_t = w_t ⊙ S_{t-1} + k_t v_tᵀ for r, k, v, w (B, S, H,
    N) from ``wkv`` (B, H, N, N) f32. Returns (y (B, S, H, N), S_last)."""
    ys = []
    for t in range(r.shape[1]):
        ys.append(torch.matmul(r[:, t, :, None, :], wkv)[:, :, 0, :])
        wkv = torch.addcmul(w[:, t, :, :, None] * wkv, k[:, t, :, :, None],
                            v[:, t, :, None, :])
    return torch.stack(ys, dim=1), wkv


def rwkv_channel_mix(p, x, state, cfg: ModelConfig, token_mask=None, tp=None):
    """RWKV-6 channel mix of x (B, S, d); returns (out, new state). Under
    tensor parallelism (``tp``) the key runs on the rank's columns of
    ``w_ck``, the value is ``w_cv``'s partial sums completed over the axis,
    and the receptance, which gates every channel, is gathered whole."""
    dx = _shifted(x, state["cm_x"]) - x
    xk = x + dx * p["mu_ck"]
    xr = x + dx * p["mu_cr"]
    if tp is None:
        k = F.relu(xk @ p["w_ck"]).square()
        out = torch.sigmoid(xr @ p["w_cr"]) * (k @ p["w_cv"])
    else:
        part = tp.units(cfg.d_ff)
        k = F.relu(tp.column(torch.matmul, xk, p["w_ck"], cfg.d_ff, part)).square()
        gate = torch.sigmoid(tp.column(torch.matmul, xr, p["w_cr"], cfg.d_model, None))
        out = gate * tp.row(torch.matmul, k, p["w_cv"], cfg.d_ff, part)
    new_state = dict(state)
    new_state["cm_x"] = (x[:, -1, :] if token_mask is None
                         else _last_real(x, state["cm_x"], token_mask))
    return out, new_state


# ================================================================== RG-LRU
def init_rglru_layers(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
                      dtype=torch.float32, device=None) -> dict:
    """Layer-stacked RG-LRU block weights, the reference's init."""
    g = cfg.rglru
    if g is None:
        raise ValueError("init_rglru_layers requires cfg.rglru to be configured")
    d, L = cfg.d_model, n_layers
    w = g.lru_width or d
    conv = torch.randn((L, g.conv_width, w), generator=gen, device=gen.device) * 0.1

    def zeros():
        return torch.zeros((L, w), dtype=dtype, device=device)

    return {
        "w_in": dense_init(gen, (L, d, w), dtype, device),
        "w_gel": dense_init(gen, (L, d, w), dtype, device),
        "conv_w": conv.to(device=device, dtype=dtype),
        "conv_b": zeros(),
        "w_a": dense_init(gen, (L, w, w), dtype, device),
        "b_a": zeros(),
        "w_i": dense_init(gen, (L, w, w), dtype, device),
        "b_i": zeros(),
        "lam": torch.linspace(2.0, 5.0, w).repeat(L, 1).to(device=device, dtype=dtype),
        "w_out": dense_init(gen, (L, w, d), dtype, device),
    }


def rglru_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, n_layers: int | None = None) -> dict:
    """Zero RG-LRU state: {"h" (f32), "conv" (the last conv_width - 1
    inputs)}, with a leading layer axis of ``n_layers`` where given."""
    g = cfg.rglru
    w = g.lru_width or cfg.d_model
    lead = () if n_layers is None else (n_layers,)
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, g.conv_width - 1, w), dtype=dtype,
                            device=device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           carry: torch.Tensor, token_mask=None):
    """x (B, S, W); w (cw, W) depthwise; carry (B, cw - 1, W) the previous
    inputs. Returns (out, new carry): with ``token_mask`` the carry is the
    window that ends at each row's last real token (trailing pads must not
    reach the next chunk)."""
    cw, S = w.shape[0], x.shape[1]
    xx = torch.cat([carry, x], dim=1)  # (B, S + cw - 1, W)
    out = 0
    for i in range(cw):  # the reference's sum(...), in its order
        out = out + xx[:, i:i + S, :] * w[i]
    out = out + b
    if cw <= 1:
        return out, carry
    if token_mask is None:
        return out, xx[:, -(cw - 1):, :]
    # xx[j] holds the input at position j - (cw - 1): the window feeding the
    # step after the last real token is xx[n_real .. n_real + cw - 2]
    n_real = token_mask.sum(dim=1)
    idx = n_real[:, None] + torch.arange(cw - 1, device=x.device)[None, :]
    return out, torch.gather(xx, 1, idx[:, :, None].expand(-1, -1, xx.shape[2]))


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t ⊙ h_{t-1} + b_t along axis 1 (h_{-1} =
    0), as the Hillis–Steele doubling scan: after the step of offset o,
    each position holds the combination of the last 2o steps."""
    n, off = a.shape[1], 1
    while off < n:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], b[:, :-off], a[:, off:])],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def rglru_block(p, x, state, cfg: ModelConfig, token_mask=None, tp=None):
    """Griffin's recurrent block: (gelu gate) ⊙ RG-LRU(conv1d(W_in x)) →
    W_out. Returns (out, new state).

    Under tensor parallelism (``tp``) the recurrence is per channel, so
    where the axis divides the width each rank runs its channels: the gate
    and the conv input from the column shards of ``w_gel`` and ``w_in``,
    its channels of the conv, the biases and ``lam`` (cut by
    ``TensorParallel.prepare``) and of the state; ``w_a`` and ``w_i`` read
    every channel of the conv output, which is gathered; ``w_out``'s
    partial sums are completed over the axis."""
    g = cfg.rglru
    B = x.shape[0]
    width = g.lru_width or cfg.d_model
    part = None if tp is None else tp.units(width)
    if tp is None:
        gate_in, conv_in = x @ p["w_gel"], x @ p["w_in"]
    else:
        xs = tp.fan(x)
        gate_in, conv_in = (tp.column(torch.matmul, x, p[n], width, part, xs)
                            for n in ("w_gel", "w_in"))
    if part is not None:
        state = {k: v[..., part[0]:part[1]] for k, v in state.items()}
    gate = F.gelu(gate_in, approximate="tanh")
    u, conv_carry = _causal_depthwise_conv(conv_in, p["conv_w"], p["conv_b"],
                                           state["conv"], token_mask)
    if tp is None:
        r_in, i_in = u @ p["w_a"], u @ p["w_i"]
    else:
        whole = u if part is None else tp.gather(u)
        us = tp.fan(whole)
        r_in, i_in = (tp.column(torch.matmul, whole, p[n], width, part, us)
                      for n in ("w_a", "w_i"))
    r = torch.sigmoid(r_in + p["b_a"]).float()
    i = torch.sigmoid(i_in + p["b_i"]).float()
    log_a_base = -F.softplus(-p["lam"].float())  # log σ(Λ) < 0
    log_a = g.c_exponent * r * log_a_base  # (B, S, W)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) * (
        i * u.float())
    if token_mask is not None:  # pad steps: the identity a = 1, b = 0
        m3 = token_mask[:, :, None]
        a = torch.where(m3, a, 1.0)
        b = torch.where(m3, b, 0.0)
    # the carried state as a first pseudo-step (a = 1)
    a_all = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
    b_all = torch.cat([state["h"][:, None, :], b], dim=1)
    h_all = linear_scan(a_all, b_all)
    y = h_all[:, 1:].to(x.dtype) * gate
    y = y @ p["w_out"] if tp is None else tp.row(torch.matmul, y, p["w_out"], width, part)
    return y, {"h": h_all[:, -1], "conv": conv_carry}
