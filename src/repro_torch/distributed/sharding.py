"""Sharding rules (PyTorch counterpart of ``repro.distributed.sharding``):
map every parameter, optimizer moment, batch and cache leaf to a spec.

A spec has the form of JAX's ``PartitionSpec``: a tuple with, per leading
dimension, ``None``, a mesh axis name or a tuple of axis names (trailing
dimensions left out are unsharded). Mesh axes: ``model`` = tensor/expert
parallel; ``data`` (+ optional ``pod``) = batch parallel. The rules are the
reference's, leaf for leaf: name-based over the tree's path names
(:func:`repro_torch.tree.flatten_with_names`), on trailing dims, dropping
any sharding that does not divide its axis evenly; optimizer moments
additionally shard their largest free dim over ``data`` (ZeRO-1) once a
leaf holds 2^22 elements or more. One reference quirk is kept, for the
placements must be the reference's: a layer-stacked dense FFN weight
(``w_gate``/``w_up``/``w_down``, 3-D) meets the MoE rule, so its LAYER axis
is sharded over ``model`` where the layer count divides it.

The rules read only the mesh's axis sizes, as the reference reads only
``mesh.shape``: ``mesh`` is a ``{axis: size}`` dict (the dry run's meshes
have no processes) or a ``DeviceMesh`` with named dims. Each ``*_specs``
function returns a dict from a leaf's path name (relative to the tree it
was given) to its spec.

:func:`make_shardings` is the one place that turns specs into
``torch.distributed.tensor`` placements on a ``DeviceMesh``, into a rank's
local slice of a whole leaf, and back (the gather of a whole leaf).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..tree import flatten_with_names, unflatten

# param-name → trailing-dim pattern: "col" shards the last dim on model,
# "row" the second-to-last, "embed" the vocab (dim -2), "expert" a leading
# expert dim (ndim >= 3 stacks)
_COL = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_ck", "w_cr", "wg", "wr",
    "w_kv_b", "lm_head", "w_in", "w_gel", "w_a", "w_i",
}
_ROW = {"wo", "w_down", "w_cv", "w_out"}
_EMBED = {"embed"}
_REPL = {"router", "w_kv_a", "wa", "wb", "conv_w"}  # small / awkward dims
_ATTN_Q = {"wq"}
_ATTN_KV = {"wk", "wv"}
_ATTN_O = {"wo"}
_LORA_NAMES = ("lora", "q", "k", "v", "o", "r", "kv_a")
ZERO_MIN_ELEMENTS = 1 << 22  # moments of smaller leaves stay unsharded over data


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a dict or a ``DeviceMesh`` with named dims."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _divides(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def spec_for_param(path: str, shape: tuple[int, ...], mesh, cfg=None) -> tuple:
    """Spec of one parameter leaf, ``path`` its path name ("a/b/c").
    ``cfg`` enables the reference's head-aware attention sharding:
    q/k/v/o are sharded only where whole heads divide the model axis."""
    model = axis_sizes(mesh).get("model", 1)
    names = path.split("/")
    name = names[-1] if names else ""
    if name in ("0", "1") and len(names) >= 2:  # LoRA (A, B) tuples
        name = names[-2]
    if cfg is not None and cfg.rwkv is None and cfg.mla is None:
        heads_ok = cfg.num_heads % model == 0
        kv_ok = cfg.num_kv_heads % model == 0
        if (name in _ATTN_Q and not heads_ok) or (name in _ATTN_KV and not kv_ok) \
                or (name in _ATTN_O and not heads_ok):
            return ()
    if any(n in _LORA_NAMES for n in names) and len(shape) == 4:
        return ()  # (L, slots, d_in, r) / (L, slots, r, d_out): replicated (small)
    if name in _REPL or len(shape) <= 1:
        return ()
    spec: list = [None] * len(shape)
    if name in ("w_gate", "w_up", "w_down") and len(shape) >= 3:
        e_dim = len(shape) - 3  # (E, a, b) or (L, E, a, b); also (L, a, b)
        if not _divides(shape[e_dim], model):
            return ()
        spec[e_dim] = "model"
        return tuple(spec)
    if name in _EMBED or name in _ROW:
        if _divides(shape[-2], model):
            spec[-2] = "model"
        return tuple(spec)
    if name in _COL:
        if _divides(shape[-1], model):
            spec[-1] = "model"
        return tuple(spec)
    return ()


def param_specs(params, mesh, cfg=None) -> dict[str, tuple]:
    return {n: spec_for_param(n, tuple(t.shape), mesh, cfg)
            for n, t in flatten_with_names(params)}


def moment_spec(path: str, shape: tuple[int, ...], mesh, cfg=None) -> tuple:
    """The parameter's spec plus ZeRO-1: a leaf of 2^22 elements or more
    shards its largest still-unsharded dim that ``data`` divides."""
    base = spec_for_param(path, shape, mesh, cfg)
    if math.prod(shape) < ZERO_MIN_ELEMENTS:
        return base
    data = axis_sizes(mesh).get("data", 1)
    spec = list(base) + [None] * (len(shape) - len(base))
    best, best_dim = -1, None
    for i, (s, cur) in enumerate(zip(shape, spec)):
        if cur is None and _divides(s, data) and s > best and s >= data:
            best, best_dim = s, i
    if best_dim is not None:
        spec[best_dim] = "data"
    return tuple(spec)


def moment_specs(params, mesh, cfg=None) -> dict[str, tuple]:
    return {n: moment_spec(n, tuple(t.shape), mesh, cfg)
            for n, t in flatten_with_names(params)}


def batch_axes(mesh) -> tuple:
    """The composite batch axis: ("pod", "data") on multi-pod meshes."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _batch_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def spec_for_batch(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """Inputs: the leading batch dim over pod×data when divisible
    (``mrope_positions`` (3, B, S): dim 1)."""
    names = path.split("/")
    name = names[-1] if names else ""
    ba, nb = batch_axes(mesh), _batch_size(mesh)
    if name == "mrope_positions" and len(shape) == 3:
        return (None, ba, None) if _divides(shape[1], nb) else ()
    if len(shape) >= 1 and _divides(shape[0], nb):
        return (ba,) + (None,) * (len(shape) - 1)
    return ()


def batch_specs(batch, mesh) -> dict[str, tuple]:
    return {n: spec_for_batch(n, tuple(t.shape), mesh) for n, t in flatten_with_names(batch)}


def spec_for_cache(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """Decode caches: (L, B, T, H, D)-family arrays shard B over pod×data and
    the KV heads over model when divisible, else the time axis; MLA's
    latent caches shard time, RWKV's state its heads."""
    names = path.split("/")
    name = names[-1] if names else ""
    ba, nb = batch_axes(mesh), _batch_size(mesh)
    model = axis_sizes(mesh).get("model", 1)
    if name == "len":
        return (ba,) if _divides(shape[0], nb) else ()
    spec: list = [None] * len(shape)
    if len(shape) >= 2 and _divides(shape[1], nb):
        spec[1] = ba
    if (name in ("k", "v", "ck", "cv") and len(shape) == 5) or \
            (name in ("k_scale", "v_scale") and len(shape) == 4):
        if _divides(shape[3], model):
            spec[3] = "model"
        elif _divides(shape[2], model):
            spec[2] = "model"
    if name in ("latent", "krope") and len(shape) == 4 and _divides(shape[2], model):
        spec[2] = "model"
    if name == "wkv" and len(shape) == 5 and _divides(shape[2], model):
        spec[2] = "model"
    return tuple(spec)


def cache_specs(cache, mesh) -> dict[str, tuple]:
    return {n: spec_for_cache(n, tuple(t.shape), mesh) for n, t in flatten_with_names(cache)}


def spec_axes(entry) -> tuple[str, ...]:
    """The axis names of one dim's spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's spec on a mesh: its local shape, its DTensor placements,
    and (on a ``DeviceMesh`` this rank belongs to) its local slice of a
    whole leaf and the gather of a whole leaf from the local slices."""

    spec: tuple
    axes: dict  # {axis: size}, in the mesh's order
    mesh: Any = None  # DeviceMesh, or None for a mesh no process has

    def _dim_parts(self, ndim: int):
        """Per dim: (number of parts, index of this rank's part or None)."""
        coord = None
        if self.mesh is not None and self.mesh.get_coordinate() is not None:
            coord = dict(zip(self.axes, self.mesh.get_coordinate()))
        out = []
        for d in range(ndim):
            names = spec_axes(self.spec[d]) if d < len(self.spec) else ()
            n, idx = 1, 0
            for a in names:  # the first axis outermost, as JAX lays them out
                n *= self.axes[a]
                idx = idx * self.axes[a] + (coord[a] if coord else 0)
            out.append((n, idx if coord else None))
        return out

    def local_shape(self, shape) -> tuple[int, ...]:
        return tuple(s // n for s, (n, _) in zip(shape, self._dim_parts(len(shape))))

    def placements(self) -> tuple:
        """``Shard(d)`` / ``Replicate()`` per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for a in self.axes:
            dims = [d for d, e in enumerate(self.spec) if a in spec_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local(self, full) -> torch.Tensor:
        """This rank's slice of the whole leaf ``full`` (a tensor or a numpy
        array, such as a memory-mapped checkpoint leaf), as a new tensor."""
        index = tuple(slice(i * (s // n), (i + 1) * (s // n)) if n > 1 else slice(None)
                      for s, (n, i) in zip(full.shape, self._dim_parts(len(full.shape))))
        if isinstance(full, torch.Tensor):
            return full[index].clone()
        return torch.from_numpy(np.array(full[index]))

    def gather(self, local: torch.Tensor, shape: Optional[tuple] = None) -> torch.Tensor:
        """The whole leaf from every rank's ``local`` slice (a collective
        over the mesh; ``local`` itself where nothing is sharded)."""
        if not any(self.spec):
            return local
        from torch.distributed.tensor import DTensor

        full_shape = tuple(shape) if shape is not None else tuple(
            s * n for s, (n, _) in zip(local.shape, self._dim_parts(local.dim())))
        dt = DTensor.from_local(local.contiguous(), self.mesh, self.placements(),
                                run_check=False, shape=torch.Size(full_shape),
                                stride=torch.empty(full_shape, device="meta").stride())
        return dt.full_tensor()


def make_shardings(specs: dict[str, tuple], mesh) -> dict[str, Sharding]:
    """``{name: Sharding}`` of ``{name: spec}`` on ``mesh``."""
    dm = None if isinstance(mesh, dict) else mesh
    axes = axis_sizes(mesh)
    return {n: Sharding(spec, axes, dm) for n, spec in specs.items()}


def shard_tree(tree, shardings: dict[str, Sharding]):
    """Each leaf of a whole tree replaced by this rank's slice."""
    return unflatten(tree, [shardings[n].local(t) for n, t in flatten_with_names(tree)])


def gather_tree(tree, shardings: dict[str, Sharding]):
    """Each local leaf of ``tree`` replaced by the whole leaf (collective)."""
    return unflatten(tree, [shardings[n].gather(t) for n, t in flatten_with_names(tree)])
