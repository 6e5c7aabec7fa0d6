"""Weight bridge from the reference package's parameters to the port's.

The reference builds its weights with ``jax.random``, which PyTorch cannot
reproduce, so the tests hand the same numbers to both packages through
numpy: ``repro``'s ``LM.init_params`` pytree (nested dicts, layers stacked
on a leading axis) and its ``AdapterWeights.weights`` ({target: (A, B)},
already numpy) map leaf by leaf onto the port's identical layout, which
``ServingEngine(params=...)``, ``LM.extend`` and
``AdapterStore.register(weights=...)`` take. Anything ``numpy.asarray``
accepts is a leaf, and so is a ``torch.Tensor`` (weights drawn on the card
move to the device and dtype asked for, with no copy through numpy); this
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def tensor_tree(tree, device=None, dtype=torch.float32):
    """Map every array leaf of a dict/tuple/list tree to a torch tensor on
    ``device`` (default: the card, raising without one), of ``dtype``, or
    of the leaf's own dtype with ``dtype=None`` (int leaves and an int8
    cache stay as they are). A bfloat16 leaf (``ml_dtypes.bfloat16``, what
    ``numpy.asarray`` makes of a JAX bf16 array, which ``torch.from_numpy``
    refuses) crosses bit for bit: viewed as uint16, then as bfloat16."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tensor_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensor_tree(v, device, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):  # as it is: no copy where it already fits
        return tree.to(device=device, dtype=dtype or tree.dtype)
    arr = np.ascontiguousarray(np.asarray(tree))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype or t.dtype)
