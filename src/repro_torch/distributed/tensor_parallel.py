"""Tensor parallelism over the mesh's ``model`` axis: the collectives that
GSPMD inserts into the reference's train step under its placements,
written out for the port's dense GQA decoders.

Each rank holds its local shards as plain tensors and runs the model on
them, so the kernels' autograd Functions see plain local tensors (DTensor
could not see into them). Megatron's conjugate autograd Functions mark
the boundaries:

* :func:`copy_to` (identity; backward all-reduce) where a replicated
  tensor enters computation that differs by rank: its gradient there is a
  partial sum on each rank;
* :func:`reduce_from` (all-reduce; backward identity) after a row-sharded
  product, whose per-rank outputs are partial sums;
* :func:`gather_from` (all-gather along a dim; backward: this rank's
  chunk) where sharded pieces become a replicated whole.

A replicated activation carries its whole gradient on every rank. Where a
replicated leaf is used on disjoint shards of the activations (LoRA A and
B beside a sharded projection, q_norm / k_norm on split heads), it goes
through :func:`copy_to` once per step, which sums its partial gradients
over the ``model`` group; a replicated leaf used on replicated activations
(norm1, norm2, final_norm) gets its whole gradient on every rank and is
not summed.

The layout, from the weights' local shapes against the config:
``wq``/``wk``/``wv`` and ``lm_head`` column-sharded, ``wo`` row-sharded,
``embed`` vocab-sharded (a masked local lookup, then an all-reduce; the
logits all-gathered before the cross-entropy). Attention runs on this
rank's heads where the model axis divides the query heads; a projection
whose column shard does not hold whole heads of them (a kv head split
inside, as GSPMD must handle too) is all-gathered and each rank takes the
heads it needs. Any other leaf the placements shard (the dense FFN's layer
axis, by the reference's rule) is all-gathered whole before use.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..tree import flatten_with_names, unflatten
from .sharding import spec_axes

# leaves the tensor-parallel forward uses in their sharded form, and the dim
_NATIVE = {"embed": 0, "lm_head": -1, "wq": -1, "wk": -1, "wv": -1, "wo": -2}
_LORA_BASE = {"q": "wq", "k": "wk", "v": "wv", "o": "wo"}


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


@dataclasses.dataclass
class TensorParallel:
    """The ``model`` axis as the model's forward sees it: its process
    group, its size and this rank's index on it, and the parameters'
    specs (``param_specs`` of the params tree)."""

    group: Any
    size: int
    index: int
    specs: dict  # {param path name: spec}

    # -------------------------------------------------------------- layout
    def _sharded_dims(self, name: str) -> list[int]:
        return [d for d, e in enumerate(self.specs.get(name, ())) if "model" in spec_axes(e)]

    def _is_native(self, name: str, ndim: int) -> bool:
        leaf = name.rsplit("/", 1)[-1]
        dims = self._sharded_dims(name)
        return leaf in _NATIVE and dims == [_NATIVE[leaf] % ndim] and (
            leaf in ("embed", "lm_head") or name.startswith("layers/mixer/"))

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

    # ---------------------------------------------------------------- prep
    def prepare(self, params, lora, cfg):
        """(params, lora) for a forward: every leaf sharded where the
        forward does not use the shard gathered whole; LoRA A/B of a
        sharded projection and q_norm/k_norm on split heads passed through
        :func:`copy_to` (their gradients summed over the axis), with B's
        columns (q/k/v) or A's rows (o) cut to this rank's shard."""
        split = self.heads(cfg) is not None
        out = []
        for name, t in flatten_with_names(params):
            dims = self._sharded_dims(name)
            if dims and not self._is_native(name, t.dim()):
                for d in dims:
                    t = gather_from(t, d, self.group)
            elif split and name in ("layers/mixer/q_norm", "layers/mixer/k_norm"):
                t = copy_to(t, self.group)
            out.append(t)
        params = unflatten(params, out)
        if not lora:
            return params, lora
        new = dict(lora)
        for target, base in _LORA_BASE.items():
            if target not in lora or not self._sharded_dims(f"layers/mixer/{base}"):
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
    def qkv(self, proj, p, x, cfg):
        """(q, k, v) of this rank's heads as (B, S, cols), and (query
        heads, kv heads). ``proj(x, w, name)`` is the layer's projection
        (base + LoRA)."""
        hd, H, Hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        heads = self.heads(cfg)
        q0, q1, k0, k1 = heads if heads is not None else (0, H, 0, Hkv)
        widths = {"q": H * hd, "k": Hkv * hd, "v": Hkv * hd}
        wanted = {"q": (q0 * hd, q1 * hd), "k": (k0 * hd, k1 * hd), "v": (k0 * hd, k1 * hd)}
        sharded = {t: p[f"w{t}"].shape[-1] != widths[t] for t in widths}
        xf = copy_to(x, self.group) if any(sharded.values()) else x
        out = []
        for t in ("q", "k", "v"):
            y = proj(xf if sharded[t] else x, p[f"w{t}"], t)
            lo, hi = wanted[t]
            if sharded[t]:
                n = y.shape[-1]
                if (lo, hi) == (self.index * n, (self.index + 1) * n):
                    out.append(y)  # the shard holds exactly this rank's heads
                    continue
                y = gather_from(y, -1, self.group)
            if heads is not None:  # this rank's heads of a replicated whole
                y = copy_to(y, self.group)[..., lo:hi]
            out.append(y)
        return out, (q1 - q0, k1 - k0)

    def out_proj(self, proj, out, wo, cfg):
        """The o projection of this rank's attention output (its heads, or
        every head), completed over the axis."""
        width = cfg.num_heads * cfg.resolved_head_dim
        split = self.heads(cfg) is not None
        if wo.shape[-2] != width:  # row-sharded: a partial sum a rank
            if not split:
                n = wo.shape[-2]
                out = copy_to(out, self.group)[..., self.index * n:(self.index + 1) * n]
            return reduce_from(proj(out, wo, "o"), self.group)
        if split:
            out = gather_from(out, -1, self.group)
        return proj(out, wo, "o")
