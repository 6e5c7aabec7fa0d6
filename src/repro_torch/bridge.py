"""Weight bridge from the reference package's parameters to the port's.

The reference builds its weights with ``jax.random``, which PyTorch cannot
reproduce, so the tests hand the same numbers to both packages through
numpy: ``repro``'s ``LM.init_params`` pytree (nested dicts, layers stacked
on a leading axis) and its ``AdapterWeights.weights`` ({target: (A, B)},
already numpy) map leaf by leaf onto the port's identical layout, which
``ServingEngine(params=...)``, ``LM.extend`` and
``AdapterStore.register(weights=...)`` take. Anything ``numpy.asarray``
accepts is a leaf; this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def tensor_tree(tree, device=None, dtype=torch.float32):
    """Map every array leaf of a dict/tuple/list tree to a torch tensor on
    ``device`` (default: the card, raising without one)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tensor_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tensor_tree(v, device, dtype) for v in tree)
    arr = np.ascontiguousarray(np.asarray(tree))
    return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)

