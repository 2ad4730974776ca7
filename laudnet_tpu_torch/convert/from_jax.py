"""Loads flax variables into the port's models (`LAUDViT`, `LAUDResNet`,
`ResNet`, `LAUDRegNet`).

Takes the JAX ``variables`` dict (``params`` and, for the CNNs,
``batch_stats``) with numpy leaves, or a bare ``params`` tree, and fills
the port model strictly: every flax leaf is consumed and every port
parameter and BatchNorm statistic is set, or it raises. Conversions:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW (a grouped kernel
  (kh, kw, in/g, out) -> (out, in/g, kh, kw), the same transpose);
* LayerNorm and BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``batch_stats`` ``mean``/``var`` -> the buffers ``running_mean``/
  ``running_var`` (flax keeps the biased variance, and so does the port's
  `ops/norm.py::BatchNorm`, so the numbers carry over as they are);
* the CNN blocks keep their flax names (``layer{s}_{b}``,
  ``downsample_conv``, ``downsample_bn``, ``masker_spatial``,
  ``masker_channel``; the RegNet's ``stem_conv``, ``stem_bn``,
  ``stage{s}_{b}`` with ``{a,b,c,proj}_conv``, ``{a,b,c,proj}_bn``,
  ``se/fc1`` and ``se/fc2`` (1x1 convolutions with biases), and ``fc``);
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
updated parameters and gradients against JAX's leaf by leaf;
`to_flax_batch_stats` does the same for the BatchNorm statistics.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from laudnet_tpu_torch.ops.norm import BatchNorm

_STATS = {"mean": "running_mean", "var": "running_var"}


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


def _split_variables(variables_np):
    """``(params, batch_stats)`` of a variables dict or a bare params
    tree."""
    if "params" in variables_np and set(variables_np) <= {"params",
                                                          "batch_stats"}:
        return variables_np["params"], variables_np.get("batch_stats", {})
    return variables_np, {}


@torch.no_grad()
def load_flax_variables(model: nn.Module,
                        variables_np: Mapping[str, Any]) -> nn.Module:
    """Copies the flax ``variables_np`` (``{"params": ..., "batch_stats":
    ...}``, or a bare ``params`` tree for a model without BatchNorm) into
    ``model`` (in the model's dtype and device) and returns the model."""
    params_tree, stats_tree = _split_variables(variables_np)
    targets = dict(model.named_parameters())
    targets.update((name, buf) for name, buf in model.named_buffers()
                   if name.rpartition(".")[2] in _STATS.values())
    leaves = [(path, arr, *_port_name(path))
              for path, arr in _flatten(params_tree)]
    for path, arr in _flatten(stats_tree):
        module, _, leaf = path.rpartition(".")
        if leaf not in _STATS:
            raise KeyError(f"batch_stats leaf {path!r} is neither mean nor "
                           f"var")
        leaves.append((f"batch_stats.{path}", arr,
                       f"{module}.{_STATS[leaf]}", leaf))
    unset = set(targets)
    for path, arr, name, kind in leaves:
        if name not in targets:
            raise KeyError(f"flax leaf {path!r} has no port parameter "
                           f"{name!r}")
        if name not in unset:
            raise KeyError(f"port parameter {name!r} set twice")
        target = targets[name]
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


def _set_leaf(tree: dict, module_path: str, leaf: str, arr) -> None:
    node = tree
    for key in [k for k in module_path.split(".") if k]:
        node = node.setdefault(key, {})
    node[leaf] = np.ascontiguousarray(arr)


def to_flax_tree(model: nn.Module, grads: bool = False) -> dict:
    """The model's parameters (``grads``: their ``.grad``; a parameter
    without one gives zeros) as a nested dict in the flax ``params`` layout
    with f32 numpy leaves: Linear ``weight`` (out, in) -> ``kernel``
    (in, out), Conv2d OIHW -> HWIO, LayerNorm and BatchNorm ``weight`` -> ``scale``,
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
            if issubclass(kind, (nn.LayerNorm, BatchNorm)):
                leaf = "scale"
            elif issubclass(kind, nn.Conv2d):
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif issubclass(kind, nn.Linear):
                leaf, arr = "kernel", arr.T
        path = re.sub(r"^blocks\.(\d+)(\.|$)", r"block_\1\2", module)
        _set_leaf(tree, path, leaf, arr)
    return tree


def to_flax_batch_stats(model: nn.Module) -> dict:
    """The model's BatchNorm statistics as a nested dict in the flax
    ``batch_stats`` layout (``mean``/``var``, f32 numpy)."""
    back = {v: k for k, v in _STATS.items()}
    tree: dict = {}
    for name, buf in model.named_buffers():
        module, _, leaf = name.rpartition(".")
        if leaf in back:
            _set_leaf(tree, module, back[leaf],
                      buf.detach().float().cpu().numpy())
    return tree
