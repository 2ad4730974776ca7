"""Loads a flax LAUD-ViT parameter tree into the port's `LAUDViT`.

Takes the JAX ``variables["params"]`` tree with numpy leaves and fills the
port model strictly: every flax leaf is consumed and every port parameter
is set, or it raises. Conversions:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
* LayerNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``cls_token``, ``pos_embed`` and biases as they are;
* the ``t2t_stem`` subtree (``attn1``/``attn2``: ``norm1``, ``kqv``,
  ``proj``, ``norm2``, ``fc1``, ``fc2``, and ``project``) by the same
  rules. A performer's fixed feature matrix ``w`` (m, d) is copied as it
  is into a ``requires_grad=False`` parameter, never re-drawn. ``project``
  stays a Linear over (ki, kj, c)-ordered patch rows;
  `models/t2t.py::t2t_stem_conv_apply` reshapes it to a convolution.

``linear_impl='int8'`` models load the same float tree: `QuantDense` keeps
``nn.Linear``'s parameter names, and int8 weights are derived from the
loaded floats, never carried across.

Flax names the blocks ``block_{i}``; the port holds them in
``blocks.{i}``.

`to_flax_tree` is the inverse: the port's parameters (or their gradients)
back in the flax tree's layout as numpy, so a test can hold a train step's
updated parameters and gradients against JAX's leaf by leaf.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if hasattr(value, "items"):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def _port_name(flax_path: str) -> tuple[str, str]:
    """Maps a flax leaf path to (port parameter name, leaf kind)."""
    path = re.sub(r"^block_(\d+)\.", r"blocks.\1.", flax_path)
    module, _, leaf = path.rpartition(".")
    if leaf in ("kernel", "scale"):
        return f"{module}.weight", leaf
    return path, leaf


def _convert(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "kernel" and arr.ndim == 2:
        return arr.T
    if kind == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return arr


@torch.no_grad()
def load_flax_variables(model: nn.Module,
                        variables_np: Mapping[str, Any]) -> nn.Module:
    """Copies the flax ``params`` tree ``variables_np`` into ``model`` (in
    the model's dtype and device) and returns the model."""
    params = dict(model.named_parameters())
    unset = set(params)
    for path, arr in _flatten(variables_np):
        name, kind = _port_name(path)
        if name not in params:
            raise KeyError(f"flax leaf {path!r} has no port parameter "
                           f"{name!r}")
        if name not in unset:
            raise KeyError(f"port parameter {name!r} set twice")
        target = params[name]
        if arr.dtype.name == "bfloat16":  # ml_dtypes: torch cannot wrap it
            arr = arr.astype(np.float32)
        value = np.ascontiguousarray(_convert(arr, kind))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{path}: flax shape {arr.shape} -> "
                             f"{value.shape}, port {name} has "
                             f"{tuple(target.shape)}")
        target.copy_(torch.from_numpy(value).to(target.dtype))
        unset.discard(name)
    if unset:
        raise KeyError(f"port parameters not in the flax tree: "
                       f"{sorted(unset)}")
    return model


def to_flax_tree(model: nn.Module, grads: bool = False) -> dict:
    """The model's parameters (``grads``: their ``.grad``; a parameter
    without one gives zeros) as a nested dict in the flax ``params`` layout
    with f32 numpy leaves: Linear ``weight`` (out, in) -> ``kernel``
    (in, out), Conv2d OIHW -> HWIO, LayerNorm ``weight`` -> ``scale``,
    ``blocks.{i}`` -> ``block_{i}``; the rest as it is."""
    kinds = {name: type(m) for name, m in model.named_modules()}
    tree: dict = {}
    for name, param in model.named_parameters():
        value = param.grad if grads else param
        if value is None:
            value = torch.zeros_like(param)
        arr = value.detach().float().cpu().numpy()
        module, _, leaf = name.rpartition(".")
        kind = kinds.get(module)
        if leaf == "weight" and kind is not None:
            if issubclass(kind, nn.LayerNorm):
                leaf = "scale"
            elif issubclass(kind, nn.Conv2d):
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif issubclass(kind, nn.Linear):
                leaf, arr = "kernel", arr.T
        path = re.sub(r"^blocks\.(\d+)(\.|$)", r"block_\1\2", module)
        node = tree
        for key in [k for k in path.split(".") if k]:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
