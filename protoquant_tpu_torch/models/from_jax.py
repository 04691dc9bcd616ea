"""Carry weights of the JAX package's Llama model across to the port (its
Gemma-2 sandwich norms and BLOOM's LayerNorms, embedding LayerNorm and
linear biases too, by name; zero-centred norm weights as stored).

``params_from_numpy`` takes the flax params tree as nested dicts of numpy
arrays (a ``QTensor`` or a packed ``QTensor4`` given as ``{"data",
"scale"}``) and returns a ``state_dict`` for ``LlamaModel``. JAX stores a
linear weight [K, N]; the port stores it [N, K] (the ``nn.Linear`` layout,
K contiguous, which the kernels read), so every kernel is transposed here.
A ``QTensor4`` (scale [K/g, N]) has data [K/2, N] packed along K within
each group; its transpose [N, K/2] is the port's packing of the same codes,
byte for byte, and its scale becomes [N, K/g].
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.device import resolve_device


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C", copy=True))


def params_from_numpy(tree: Mapping) -> dict:
    """flax params tree (numpy leaves) -> ``LlamaModel`` state_dict."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        *mod, name = path
        if name == "embedding":
            out[".".join(mod + ["weight"])] = _tensor(leaf).float()
        elif name == "kernel":
            out[".".join(mod + ["weight"])] = _tensor(np.asarray(leaf).T).float()
        elif mod and mod[-1] == "qkernel" and name == "data":
            out[".".join(mod[:-1] + ["qweight"])] = _tensor(np.asarray(leaf).T)
        elif mod and mod[-1] == "qkernel" and name == "scale":
            # a QTensor's scale is [N]; a QTensor4's is [K/g, N], as its
            # packed data [K/2, N]: both become [N, ...]
            leaf = np.asarray(leaf)
            out[".".join(mod[:-1] + ["qscale"])] = _tensor(leaf.T if leaf.ndim == 2 else leaf).float()
        elif name in ("weight", "bias"):
            out[".".join(mod + [name])] = _tensor(leaf).float()
        else:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
    return out


def cache_from_numpy(cls, arrays: Mapping, group: int | None = None, device=None, **meta):
    """A port cache of class ``cls`` from a JAX cache's arrays (field name
    -> numpy array, the same layouts), on ``device`` (default cuda, as every
    entry point); ``group`` for the KIVI caches, ``meta`` for the other
    meta fields (``window``, ``sinks`` of a ring). Starts both packages from
    one state."""
    device = resolve_device(device)
    fields = {name: _tensor(a).to(device) for name, a in arrays.items()}
    if group is not None:
        meta["group"] = group
    return cls(**fields, **meta)
