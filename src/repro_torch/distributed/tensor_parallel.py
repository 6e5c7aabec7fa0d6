"""Tensor and expert parallelism over the mesh's ``model`` axis: the
collectives that GSPMD inserts into the reference's train step under its
placements, written out for every family the port builds (dense GQA, MLA,
MoE, RWKV-6, the RG-LRU hybrid and the encoder-decoder).

Each rank holds its local shards as plain tensors and runs the model on
them, so the kernels' autograd Functions see plain local tensors (DTensor
could not see into them). Megatron's conjugate autograd Functions mark
the boundaries:

* :func:`copy_to` (identity; backward all-reduce) where a replicated
  tensor enters computation that differs by rank: its gradient there is a
  partial sum on each rank;
* :func:`reduce_from` (all-reduce; backward identity) after a row-sharded
  product or a sum over this rank's experts, whose per-rank outputs are
  partial sums;
* :func:`gather_from` (all-gather along a dim; backward: this rank's
  chunk) where sharded pieces become a replicated whole.

A replicated activation carries its whole gradient on every rank. Where a
replicated leaf is used on this rank's part of the heads or channels
(LoRA A and B beside a sharded projection, q_norm / k_norm on split heads,
RWKV's bonus ``u``, group norm ``ln_x`` and decay ``w0`` / ``wb``, the
RG-LRU's conv, gate biases and ``lam``), :meth:`TensorParallel.prepare`
passes it through :func:`copy_to` once per step, which sums its partial
gradients over the ``model`` group, and cuts it to the rank's part; a
replicated leaf used on replicated activations (the norms, ``w_kv_a``,
the router, RWKV's token-shift lerps and ``wa``) gets its whole gradient
on every rank and is not summed.

The layout, from the weights' local shapes against the config: every
projection the rules column-shard (``wq``/``wk``/``wv``, MLA's
``w_kv_b``, RWKV's ``wr``/``wk``/``wv``/``wg``/``w_ck``/``w_cr``, the
RG-LRU's ``w_in``/``w_gel``/``w_a``/``w_i``, ``lm_head``) computes this
rank's columns (:meth:`TensorParallel.column`); every row-sharded one
(``wo``, ``w_cv``, ``w_out``) gives a partial sum that an all-reduce
completes (:meth:`TensorParallel.row`); ``embed`` is vocab-sharded (a
masked local lookup, then an all-reduce; the logits all-gathered before
the cross-entropy); an MoE's expert stacks hold this rank's experts, whose
weighted outputs are summed over the axis. Heads, channels and experts run
on this rank's part where the model axis divides their count
(:meth:`TensorParallel.units`); a column shard that splits a head (a kv
head split inside, as GSPMD must handle too) is all-gathered and each rank
takes the heads it needs. The only leaves all-gathered whole are the
layer-stacked dense FFNs, an MoE's ``shared`` FFN included, whose LAYER
axis the reference's rule shards (:meth:`TensorParallel.gathered`).

Serving (the sharded prefill and decode steps) adds the cache's placement
(``cache_specs``): a KV cache whose kv heads the model axis divides holds
this rank's kv heads, and each rank attends its own query heads over them;
one whose time axis is sharded instead (decode context parallelism: fewer
kv heads than ranks) holds this rank's slots (:meth:`TensorParallel.
time_shard`). There the step's query is made whole (an all-gather of the
projection's columns, small at one token a row), each rank attends every
head over the keys it holds and returns the output with the softmax's
log-sum-exp, and :meth:`TensorParallel.merge` all-gathers the partials and
merges them on every rank in rank order (:func:`merge_partials`), so every
rank has the same bits and no cache leaf crosses the axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..models.common import scaled
from ..tree import flatten_with_names, unflatten
from .sharding import spec_axes

# leaves the tensor-parallel forward uses in their sharded form, and the dim
_NATIVE = {"embed": 0, "lm_head": -1, "wq": -1, "wk": -1, "wv": -1, "wo": -2,
           "w_kv_b": -1, "wr": -1, "wg": -1, "w_ck": -1, "w_cr": -1, "w_cv": -2,
           "w_in": -1, "w_gel": -1, "w_a": -1, "w_i": -1, "w_out": -2}
_EXPERTS = ("w_gate", "w_up", "w_down")  # (L, E, ., .): E is native
# LoRA target -> the projection it rides on
_LORA_BASE = {"q": "wq", "k": "wk", "v": "wv", "o": "wo", "r": "wr"}
# where those projections live: the decoder's mixer, the hybrid's attention
# layers, the encoder-decoder's decoder self-attention
_LORA_HOMES = ("layers/mixer/", "attn_layers/", "decoder/attn/")
# replicated leaves used on this rank's part of the channels: {leaf: dim};
# RWKV's (its heads) and the RG-LRU's (its channels)
_RWKV_PARTS = {"u": -2, "ln_x": -1, "w0": -1, "wb": -1}
_RGLRU_PARTS = {"conv_w": -1, "conv_b": -1, "b_a": -1, "b_i": -1, "lam": -1}

Part = Optional[tuple[int, int]]  # [lo, hi) of a whole dim this rank runs, None: all


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.index, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None, None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    return _ReduceFrom.apply(x, group)


def gather_from(x, dim, group):
    return _GatherFrom.apply(x, dim, group)


def merge_partials(outs, lses):
    """Attention over the union of disjoint parts of the keys from each
    part's attention ``outs[i]`` (..., H, D) and its log-sum-exp
    ``lses[i]`` (..., H) (−inf for a part without a key, whose output is
    0), summed in the order given: (out, lse). A query without a key in
    any part gets 0 and −inf, never NaN."""
    m = lses[0]
    for x in lses[1:]:
        m = torch.maximum(m, x)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc, norm = None, None
    for o, x in zip(outs, lses):
        w = torch.exp(x - m)  # 0 for an empty part
        term = w[..., None] * o.to(torch.promote_types(o.dtype, torch.float32))
        acc = term if acc is None else acc + term
        norm = w if norm is None else norm + w
    out = torch.where(norm[..., None] > 0, acc / norm.clamp_min(1e-30)[..., None], 0.0)
    return out.to(outs[0].dtype), m + torch.log(norm)


@dataclasses.dataclass
class TensorParallel:
    """The ``model`` axis as the model's forward sees it: its process
    group, its size and this rank's index on it, the parameters' specs
    (``param_specs`` of the params tree) and, for the sharded serving
    steps, the cache's (``cache_specs`` of the whole cache)."""

    group: Any
    size: int
    index: int
    specs: dict  # {param path name: spec}
    cache_specs: Optional[dict] = None  # {cache leaf name: spec}

    # -------------------------------------------------------------- layout
    def _sharded_dims(self, name: str) -> list[int]:
        return [d for d, e in enumerate(self.specs.get(name, ())) if "model" in spec_axes(e)]

    def _is_native(self, name: str, ndim: int) -> bool:
        leaf = name.rsplit("/", 1)[-1]
        dims = self._sharded_dims(name)
        if leaf in _EXPERTS:
            return ndim == 4 and dims == [1]
        return leaf in _NATIVE and dims == [_NATIVE[leaf] % ndim]

    def gathered(self, params) -> list[str]:
        """The leaves :meth:`prepare` all-gathers whole: those the rules
        shard over ``model`` that the forward does not use as shards."""
        return [n for n, t in flatten_with_names(params)
                if self._sharded_dims(n) and not self._is_native(n, t.dim())]

    def units(self, n: int) -> Part:
        """This rank's share [u0, u1) of ``n`` heads, channels or experts
        where the axis divides ``n``; None (every rank runs all) where not."""
        if n % self.size:
            return None
        k = n // self.size
        return self.index * k, (self.index + 1) * k

    def heads(self, cfg) -> Optional[tuple[int, int, int, int]]:
        """(first q head, end, first kv head, end) of this rank, or None
        where attention runs on every head (the axis does not divide the
        query heads, or their groups straddle ranks unevenly)."""
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        G, M = H // Hkv, self.size
        if H % M:
            return None
        hq = H // M
        q0 = self.index * hq
        if hq % G == 0:
            return q0, q0 + hq, q0 // G, (q0 + hq) // G
        if G % hq == 0:
            return q0, q0 + hq, q0 // G, q0 // G + 1
        return None

    def _parts(self, params, cfg) -> dict[str, tuple[int, int, int]]:
        """{leaf name: (dim, lo, hi)}: the replicated leaves the forward
        uses on this rank's part of RWKV's heads or the RG-LRU's channels."""
        out = {}
        if cfg.rwkv is not None and "layers" in params:
            N = cfg.rwkv.head_dim
            part = self.units(cfg.d_model // N)
            if part is not None:
                for leaf, dim in _RWKV_PARTS.items():
                    lo, hi = part if leaf == "u" else scaled(part, N)
                    out[f"layers/mixer/{leaf}"] = (dim, lo, hi)
        if cfg.rglru is not None and "rec_layers" in params:
            part = self.units(cfg.rglru.lru_width or cfg.d_model)
            if part is not None:
                out.update({f"rec_layers/{leaf}": (dim, *part)
                            for leaf, dim in _RGLRU_PARTS.items()})
        return out

    # ---------------------------------------------------------------- prep
    def prepare(self, params, lora, cfg):
        """(params, lora) for a forward: every sharded leaf kept as its
        shard except :meth:`gathered`'s, gathered whole; RWKV's and the
        RG-LRU's per-channel replicated leaves passed through
        :func:`copy_to` and cut to the rank's part where it runs part of
        them; LoRA A/B of a sharded projection and q_norm/k_norm on split
        heads passed through :func:`copy_to` (their gradients summed over
        the axis), with B's columns (q/k/v/r) or A's rows (o) cut to this
        rank's shard."""
        split = self.heads(cfg) is not None
        parts = self._parts(params, cfg)
        gather = set(self.gathered(params))
        out = []
        for name, t in flatten_with_names(params):
            if name in gather:
                for d in self._sharded_dims(name):
                    t = gather_from(t, d, self.group)
            elif name in parts:
                dim, lo, hi = parts[name]
                t = copy_to(t, self.group).narrow(dim, lo, hi - lo)
            elif split and name.rsplit("/", 1)[-1] in ("q_norm", "k_norm"):
                t = copy_to(t, self.group)
            out.append(t)
        params = unflatten(params, out)
        if not lora:
            return params, lora
        new = dict(lora)
        for target, base in _LORA_BASE.items():
            homes = [h + base for h in _LORA_HOMES if h + base in self.specs]
            if target not in lora or not homes or not self._sharded_dims(homes[0]):
                continue
            a, b = (copy_to(t, self.group) for t in lora[target])
            if target == "o":
                n = a.shape[-2] // self.size
                a = a[..., self.index * n:(self.index + 1) * n, :].contiguous()
            else:
                n = b.shape[-1] // self.size
                b = b[..., self.index * n:(self.index + 1) * n].contiguous()
            new[target] = (a, b)
        return params, new

    # ---------------------------------------------------------- products
    def fan(self, x):
        """``x`` entering computation that differs by rank."""
        return copy_to(x, self.group)

    def gather(self, y, dim: int = -1):
        """The whole of a tensor whose ``dim`` each rank holds a part of."""
        return gather_from(y, dim, self.group)

    def column(self, proj, x, w, width: int, part: Part, xs=None):
        """Columns ``part`` of ``proj(x, w)`` (None: all, replicated) for a
        ``w`` of ``width`` columns, column-sharded or whole; ``proj`` is
        the layer's product (base + LoRA). A part that is not exactly
        ``w``'s shard is cut from the gathered whole through
        :func:`copy_to`, as is a part that is the whole but feeds
        computation that differs by rank. ``xs``: ``fan(x)``, where the
        caller shares one between products."""
        n = w.shape[-1]
        if n != width:  # column-sharded
            y = proj(self.fan(x) if xs is None else xs, w)
            if part == (self.index * n, (self.index + 1) * n):
                return y  # the shard holds exactly this rank's part
            y = self.gather(y)
        else:
            y = proj(x, w)
        if part is None:
            return y
        return copy_to(y, self.group)[..., part[0]:part[1]]

    def row(self, proj, y, w, width: int, part: Part):
        """``proj(y, w)`` completed over the axis, for ``y`` the input's
        columns ``part`` (None: all) and ``w`` of ``width`` rows,
        row-sharded (a partial sum a rank) or whole."""
        n = w.shape[-2]
        if n != width:  # row-sharded
            rows = (self.index * n, (self.index + 1) * n)
            if part != rows:
                if part is not None:
                    y = self.gather(y)
                y = copy_to(y, self.group)[..., rows[0]:rows[1]]
            return reduce_from(proj(y, w), self.group)
        if part is not None:
            y = self.gather(y)
        return proj(y, w)

    def reduce(self, y):
        """The sum over the axis of each rank's partial ``y``."""
        return reduce_from(y, self.group)

    # ----------------------------------------------------------- embedding
    def embed(self, table, tokens, vocab: int):
        """Token embeddings from a vocab-sharded (or whole) table."""
        n = table.shape[0]
        if n == vocab:
            return table[tokens]
        local = tokens - self.index * n
        hit = (local >= 0) & (local < n)
        x = table[local.clamp(0, n - 1)] * hit[..., None].to(table.dtype)
        return reduce_from(x, self.group)

    def logits(self, x, w, vocab: int, transposed: bool):
        """x · w (w: (d, V), or (V, d) with ``transposed``), all-gathered
        over the vocab where w is sharded."""
        n = w.shape[0] if transposed else w.shape[-1]
        if n == vocab:
            return x @ (w.T if transposed else w)
        y = copy_to(x, self.group) @ (w.T if transposed else w)
        return gather_from(y, -1, self.group)

    # ----------------------------------------------------------- attention
    def qkv(self, proj, p, x, cfg, kv_x=None, whole: bool = False,
            whole_kv: bool = False):
        """(q, k, v) of this rank's heads as (B, S, cols), and (query
        heads, kv heads). With ``whole``, every head's (a cache sharded in
        time, or replicated, takes every kv head of its slots, and the
        query is attended there whole); with ``whole_kv``, k and v of every
        head beside this rank's q (a prefill that fills such a cache).
        ``proj(x, w, name)`` is the layer's projection (base + LoRA); k and
        v project ``kv_x`` where given (cross attention), else ``x``."""
        hd, H, Hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        heads = None if whole else self.heads(cfg)
        q0, q1, k0, k1 = heads if heads is not None else (0, H, 0, Hkv)
        if whole_kv:
            k0, k1 = 0, Hkv
        xs = self.fan(x)
        kv_x, kvs = (x, xs) if kv_x is None else (kv_x, self.fan(kv_x))
        out = []
        for t, src, fanned, width, lo, hi in (("q", x, xs, H, q0, q1),
                                              ("k", kv_x, kvs, Hkv, k0, k1),
                                              ("v", kv_x, kvs, Hkv, k0, k1)):
            part = None if heads is None or (t != "q" and whole_kv) else (lo * hd, hi * hd)
            out.append(self.column(lambda h, w, t=t: proj(h, w, t), src, p[f"w{t}"],
                                   width * hd, part, fanned))
        return out, (q1 - q0, k1 - k0)

    def out_proj(self, proj, out, wo, cfg):
        """The o projection of this rank's attention output (its heads, or
        every head), completed over the axis."""
        hd = cfg.resolved_head_dim
        heads = self.heads(cfg)
        part = None if heads is None else (heads[0] * hd, heads[1] * hd)
        return self.row(lambda h, w: proj(h, w, "o"), out, wo, cfg.num_heads * hd, part)

    # --------------------------------------------------------------- cache
    def time_shard(self, name: str, local_slots: int) -> Optional[tuple[int, int]]:
        """(first slot, slots) of this rank's part of the cache leaf
        ``name`` (``k``, ``latent``, ``ck``, ...) where ``cache_specs``
        shards its time axis (dim 2) over ``model``; None where it holds
        every slot."""
        spec = (self.cache_specs or {}).get(name, ())
        if len(spec) > 2 and "model" in spec_axes(spec[2]):
            return self.index * local_slots, local_slots
        return None

    def own_heads(self, out, cfg):
        """This rank's query heads (:meth:`heads`) of ``out`` (B, S, H, D),
        which holds every head; all of them where the rank runs every
        head."""
        heads = self.heads(cfg)
        if heads is None:
            return out
        return out[:, :, heads[0]:heads[1]]

    def merge(self, out, lse):
        """Each rank's attention ``out`` (..., H, D) over its slots with its
        log-sum-exp ``lse`` (..., H), all-gathered over the axis and merged
        in rank order (:func:`merge_partials`): the attention over every
        slot, the same bits on every rank. Serving only (no gradient)."""
        outs = [torch.empty_like(out) for _ in range(self.size)]
        lses = [torch.empty_like(lse) for _ in range(self.size)]
        dist.all_gather(outs, out.contiguous(), group=self.group)
        dist.all_gather(lses, lse.contiguous(), group=self.group)
        return merge_partials(outs, lses)[0]
