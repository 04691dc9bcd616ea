"""Carry weights of the JAX package's Llama model across to the port (its
Gemma-2 sandwich norms, BLOOM's LayerNorms, embedding LayerNorm and linear
biases, GPT-OSS's learned sinks and the MoE blocks too, by name;
zero-centred norm weights as stored).

``params_from_numpy`` takes the flax params tree as nested dicts of numpy
arrays (a ``QTensor`` or a packed ``QTensor4`` given as ``{"data",
"scale"}``) and returns a ``state_dict`` for ``LlamaModel``. JAX stores a
linear weight [K, N]; the port stores it [N, K] (the ``nn.Linear`` layout,
K contiguous, which the kernels read), so every kernel is transposed here.
A ``QTensor4`` (scale [K/g, N]) has data [K/2, N] packed along K within
each group; its transpose [N, K/2] is the port's packing of the same codes,
byte for byte, and its scale becomes [N, K/g]. A MoE block's stacked expert
weights ([E, K, N], a 3-D ``QTensor`` with scales [E, N] or ``QTensor4``
with [E, K/2, N] and [E, K/g, N]) transpose per expert, to [E, N, K]; its
router ``gate`` is a plain f32 linear, and ``gate_up_proj_bias``,
``down_proj_bias`` and the attention's ``sinks`` are copied as they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.device import resolve_device


# leaves copied under their own name
_PLAIN = ("weight", "bias", "sinks", "gate_up_proj_bias", "down_proj_bias")


def _flatten(tree: Mapping, prefix: tuple = ()):
    """(path, leaf) pairs; a quantized kernel ({data, scale}) is one leaf."""
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping) and key != "qkernel":
            yield from _flatten(value, path)
        else:
            yield path, value


def _nk(a) -> np.ndarray:
    """A JAX [.., K, N] array in the port's [.., N, K] layout."""
    return np.swapaxes(np.asarray(a), -1, -2)


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
            out[".".join(mod + ["weight"])] = _tensor(_nk(leaf)).float()
        elif name == "qkernel":
            data, scale = np.asarray(leaf["data"]), np.asarray(leaf["scale"])
            out[".".join(mod + ["qweight"])] = _tensor(_nk(data))
            # a QTensor's scale is [.., N]; a QTensor4's is [.., K/g, N], as
            # its packed data [.., K/2, N]: both become [.., N, ...]
            out[".".join(mod + ["qscale"])] = _tensor(
                _nk(scale) if scale.ndim == data.ndim else scale).float()
        elif name in _PLAIN:
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
