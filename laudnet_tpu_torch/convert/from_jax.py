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
