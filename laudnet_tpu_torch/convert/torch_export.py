"""flax-named variables -> PyTorch checkpoint (the reverse converter;
counterpart of `laudnet_tpu/convert/torch_export.py`).

Writes the reference trainer's ``.pth.tar`` from a ``{"params",
"batch_stats"}`` tree: the exact inverse of `convert/torch_loader.py`'s
name map (NHWC->NCHW kernel transposes, BN running stats back into
buffers, masker Sequential indices restored). A port model gives that tree
through `convert/from_jax.py::to_flax_tree` and `to_flax_batch_stats`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _to_torch_weight(value: np.ndarray) -> np.ndarray:
    v = np.asarray(value)
    if v.ndim == 4:  # HWIO -> OIHW
        return np.transpose(v, (3, 2, 0, 1))
    if v.ndim == 2:  # (in, out) -> (out, in)
        return np.transpose(v, (1, 0))
    return v


def _walk(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def export_resnet_state_dict(variables: Mapping[str, Any],
                             ) -> Dict[str, np.ndarray]:
    """Convert ``{"params", "batch_stats"}`` flax variables of a
    (LAUD-)ResNet back to the reference torch state-dict naming.

    MLP masker depth is detected from the tree (``fc1``/``fc2`` -> 2-layer
    ``conv.0``/``conv.2`` Sequential; ``fc`` -> single Linear ``conv``).
    BN ``num_batches_tracked`` buffers are emitted as 0 (the reference
    never reads them at eval).
    """
    out: Dict[str, np.ndarray] = {}
    bn_names = set()

    def scope_prefix(path):
        import re

        head = path[0]
        m = re.fullmatch(r"(layer\d+)_(\d+)", head)
        if m:
            return f"{m.group(1)}.{m.group(2)}.", path[1:]
        return "", path

    def masker_channel_key(rest):
        # rest like ('fc1', 'kernel') / ('fc', 'bias') / ('conv', 'kernel')
        # / ('bn', 'scale') / ('linear', 'kernel')
        mod, leaf = rest[0], rest[-1]
        suffix = "weight" if leaf in ("kernel", "scale") else leaf
        if mod == "fc1":
            return f"masker_channel.conv.0.{suffix}"
        if mod == "fc2":
            return f"masker_channel.conv.2.{suffix}"
        if mod == "fc":
            return f"masker_channel.conv.{suffix}"
        if mod == "conv":
            return f"masker_channel.conv.0.{suffix}"
        if mod == "bn":
            return f"masker_channel.conv.1.{suffix}"
        if mod == "linear":
            return f"masker_channel.linear.{suffix}"
        raise KeyError(f"unknown masker_channel submodule {mod!r}")

    def param_key(path):
        pre, rest = scope_prefix(path)
        mod, leaf = rest[0], rest[-1]
        suffix = "weight" if leaf in ("kernel", "scale") else leaf
        if mod == "downsample_conv":
            return pre + "downsample.0.weight"
        if mod == "downsample_bn":
            bn_names.add(pre + "downsample.1")
            return pre + f"downsample.1.{suffix}"
        if mod == "masker_spatial":
            return pre + f"masker_spatial.conv.{suffix}"
        if mod == "masker_channel":
            key = pre + masker_channel_key(rest[1:])
            if ".conv.1." in key:  # conv_linear's BN
                bn_names.add(key.rsplit(".", 1)[0])
            return key
        if mod.startswith("bn"):
            bn_names.add(pre + mod)
            return pre + f"{mod}.{suffix}"
        return pre + f"{mod}.{suffix}"  # convN/fc

    for path, value in _walk(variables.get("params", {})):
        out[param_key(path)] = _to_torch_weight(value)

    def stat_key(path):
        pre, rest = scope_prefix(path)
        leaf = {"mean": "running_mean", "var": "running_var"}[rest[-1]]
        mod = rest[0]
        if mod == "downsample_bn":
            return pre + f"downsample.1.{leaf}"
        if mod == "masker_channel":  # conv_linear BN stats
            return pre + f"masker_channel.conv.1.{leaf}"
        return pre + f"{mod}.{leaf}"

    for path, value in _walk(variables.get("batch_stats", {})):
        out[stat_key(path)] = np.asarray(value)

    for bn in sorted(bn_names):
        out[f"{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def save_pth_tar(variables: Mapping[str, Any], path: str, **meta) -> None:
    """Write the reference trainer checkpoint format: a dict with
    ``state_dict`` (+ optional meta like epoch/best_prec1,
    `train/main.py:487-494`). Loadable by both the reference and the port's
    ``load_pth_tar``."""
    import torch

    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_resnet_state_dict(variables).items()}
    torch.save(dict(meta, state_dict=sd), path)
