"""PyTorch checkpoint -> flax-named variables (counterpart of
`laudnet_tpu/convert/torch_loader.py`, formula for formula).

Loads reference LAUD/torchvision ResNet and LAUD-RegNet state dicts
(``.pth``/``.pth.tar``, reference `train/main.py:281,304-307`) into the
flax-named ``{"params", "batch_stats"}`` tree of numpy arrays that
`convert/from_jax.py::load_flax_variables` puts into the port's models. A
reference name (``layerL.i.*``, ``downsample.0/1``) never loads into a port
model directly: that tree is the bridge. Every conversion is a layout
transpose, so f32 values carry over bit for bit.

Name mapping (torch -> flax):

======================================  =====================================
``conv1.weight`` (OIHW)                 ``conv1/kernel`` (HWIO)
``bn1.weight/bias``                     ``bn1/scale``, ``bn1/bias``
``bn1.running_mean/var``                batch_stats ``bn1/mean``, ``bn1/var``
``layerL.i.*``                          ``layerL_{i}/*``
``layerL.i.downsample.0/1``             ``downsample_conv`` / ``downsample_bn``
``fc.weight`` (out,in)                  ``fc/kernel`` (in,out)
``masker_spatial.conv.*``               ``masker_spatial/conv/*``
``masker_channel.conv.0/2`` (MLP-2)     ``masker_channel/fc1`` / ``fc2``
``masker_channel.conv`` (MLP-1)         ``masker_channel/fc``
``masker_channel.conv.0/1`` (convlin)   ``masker_channel/conv`` / ``bn``
``masker_channel.linear``               ``masker_channel/linear``
======================================  =====================================
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np


def load_pth_tar(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint file to a flat numpy state dict.

    Accepts raw state dicts and trainer checkpoints with a ``state_dict``
    or ``model`` entry; strips DDP ``module.`` prefixes (reference resume
    format, `train/main.py:330-399`). The file is unpickled in full, as
    the reference trainer's and timm's carry more than tensors: load only
    checkpoints from a trusted source."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "items"):
        obj = obj["model"]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_CONV_W = ("kernel", lambda v: np.transpose(v, (2, 3, 1, 0)))  # OIHW -> HWIO
_LINEAR_W = ("kernel", lambda v: np.transpose(v, (1, 0)))
_IDENT = lambda v: v


def _bn_entries(flax_name: str, suffix: str, value):
    """Map a torch BN param/buffer to (collection, path, value)."""
    if suffix == "weight":
        return ("params", (flax_name, "scale"), value)
    if suffix == "bias":
        return ("params", (flax_name, "bias"), value)
    if suffix == "running_mean":
        return ("batch_stats", (flax_name, "mean"), value)
    if suffix == "running_var":
        return ("batch_stats", (flax_name, "var"), value)
    if suffix == "num_batches_tracked":
        return None
    raise KeyError(suffix)


def convert_resnet_state_dict(
    state: Mapping[str, np.ndarray],
    *,
    channel_masker_layers: int = 2,
) -> Dict[str, Any]:
    """Convert a (LAUD-)ResNet torch state dict to flax variables.

    Returns ``{"params": ..., "batch_stats": ...}`` ready for
    ``model.apply``. Handles both static torchvision ResNets and LAUD
    variants (maskers present or not). ``channel_masker_layers`` selects the
    MLP naming (conv.0/conv.2 vs single conv Linear) when MLP channel maskers
    are present.
    """
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    skipped = []

    def emit(collection, path, value):
        if collection == "params":
            _set(params, path, value)
        else:
            _set(batch_stats, path, value)

    for key, value in state.items():
        parts = key.split(".")
        # Normalize block prefix: layerL.i.rest -> scope "layerL_i"
        scope: Tuple[str, ...] = ()
        if re.match(r"layer\d+", parts[0]) and len(parts) > 2:
            scope = (f"{parts[0]}_{parts[1]}",)
            parts = parts[2:]
        name = ".".join(parts)

        handled = _convert_leaf(name, value, scope, emit, channel_masker_layers)
        if not handled:
            skipped.append(key)

    if skipped:
        # num_batches_tracked and friends are expected; anything else is a bug.
        unexpected = [k for k in skipped if "num_batches_tracked" not in k]
        if unexpected:
            raise KeyError(f"unmapped checkpoint keys: {unexpected[:10]}")
    return {"params": params, "batch_stats": batch_stats}


def convert_detection_backbone_state_dict(
    state: Mapping[str, np.ndarray],
    *,
    channel_masker_layers: int = 2,
) -> Dict[str, Any]:
    """Load an ImageNet-LAUD checkpoint into a detector's backbone scope.

    The reference patches mmcv's checkpoint loader to strip ``backbone.``
    prefixes so ImageNet ``.pth.tar`` state dicts initialize detection
    backbones (`mmcv_replace_file/checkpoint.py:149-162`; configs point at
    them via ``init_cfg=dict(type='Pretrained', ...)``). This is the
    analog: accepts either a raw ImageNet LAUD state dict or one already
    prefixed with ``backbone.``, drops the classifier head (detectors have
    none), and nests the converted variables under the ``backbone`` scope
    of the detectors (the JAX package's ``detection.LAUDDetBackbone``; the
    port's detection slice reads the same tree).
    """
    cleaned = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("backbone."):
            k = k[len("backbone."):]
        # keep only backbone keys (a full detector checkpoint also carries
        # neck/head weights; an ImageNet one carries the fc classifier)
        first = k.split(".")[0]
        if first not in ("conv1", "bn1") and not re.match(r"layer\d+$", first):
            continue
        cleaned[k] = v
    converted = convert_resnet_state_dict(
        cleaned, channel_masker_layers=channel_masker_layers
    )
    return {
        "params": {"backbone": converted["params"]},
        "batch_stats": {"backbone": converted["batch_stats"]},
    }


def merge_variables(base: Dict[str, Any], loaded: Dict[str, Any]):
    """strict=False merge: copy loaded leaves over matching paths in a
    freshly-initialized variables dict (reference loads finetune weights
    with ``strict=False`` so maskers/heads stay fresh, `main.py:281`).
    Leaves come back as numpy arrays of the base leaf's shape and dtype."""

    def merge(dst, src):
        out = dict(dst)
        for k, v in src.items():
            if k not in dst:
                continue
            if isinstance(v, dict) and isinstance(dst[k], dict):
                out[k] = merge(dst[k], v)
            else:
                ref = np.asarray(dst[k])
                out[k] = np.asarray(v).reshape(ref.shape).astype(ref.dtype)
        return out

    return merge(base, loaded)


def convert_regnet_state_dict(
    state: Mapping[str, np.ndarray],
    *,
    channel_masker_layers: int = 2,
) -> Dict[str, Any]:
    """Convert a (LAUD-)RegNet torch state dict to flax variables.

    Reference layout (`laud_regnet.py`): ``stem.0/1``,
    ``trunk_output.blockS.blockS-B.{proj.0/1, f.{a,b,c}.{0,1}, f.se.fc1/fc2,
    f.masker_*}``, ``fc``. Ours: ``stem_conv/stem_bn``,
    ``stage{S}_{B}/{proj_conv, proj_bn, a_conv, a_bn, ..., se/fc1, ...}``.
    """
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    def emit(collection, path, value):
        (_set(params, path, value) if collection == "params"
         else _set(batch_stats, path, value))

    unmapped = []
    for key, value in state.items():
        if "num_batches_tracked" in key:
            continue
        parts = key.split(".")
        scope: Tuple[str, ...] = ()
        if parts[0] == "stem":
            name = {"0": "stem_conv", "1": "stem_bn"}[parts[1]]
            if name == "stem_conv":
                emit("params", ("stem_conv", "kernel"), _CONV_W[1](value))
            else:
                e = _bn_entries("stem_bn", parts[2], value)
                if e:
                    emit(e[0], e[1], e[2])
            continue
        if parts[0] == "trunk_output":
            stage = parts[1].replace("block", "")  # 'blockS' -> S
            blk = parts[2].split("-")[1]
            scope = (f"stage{stage}_{blk}",)
            rest = parts[3:]
            if rest[0] == "proj":
                if rest[1] == "0":
                    emit("params", scope + ("proj_conv", "kernel"),
                         _CONV_W[1](value))
                else:
                    e = _bn_entries("proj_bn", rest[2], value)
                    if e:
                        emit(e[0], scope + e[1], e[2])
                continue
            assert rest[0] == "f", key
            rest = rest[1:]
            if rest[0] in ("a", "b", "c"):
                sub = rest[0]
                if rest[1] == "0":
                    emit("params", scope + (f"{sub}_conv", "kernel"),
                         _CONV_W[1](value))
                else:
                    e = _bn_entries(f"{sub}_bn", rest[2], value)
                    if e:
                        emit(e[0], scope + e[1], e[2])
                continue
            if rest[0] == "se":
                emit("params", scope + ("se", rest[1],
                                        "kernel" if rest[2] == "weight" else "bias"),
                     _CONV_W[1](value) if rest[2] == "weight" else value)
                continue
            name = ".".join(rest)
            if _convert_leaf(name, value, scope, emit, channel_masker_layers):
                continue
            unmapped.append(key)
            continue
        name = ".".join(parts)
        if _convert_leaf(name, value, scope, emit, channel_masker_layers):
            continue
        unmapped.append(key)

    if unmapped:
        raise KeyError(f"unmapped regnet keys: {unmapped[:10]}")
    return {"params": params, "batch_stats": batch_stats}


def _convert_leaf(name, value, scope, emit, mlp_layers) -> bool:
    # --- backbone convs / bns / fc -------------------------------------
    m = re.fullmatch(r"(conv\d)\.weight", name)
    if m:
        emit("params", scope + (m.group(1), "kernel"), _CONV_W[1](value))
        return True
    m = re.fullmatch(r"(bn\d)\.(\w+)", name)
    if m:
        e = _bn_entries(m.group(1), m.group(2), value)
        if e is None:
            return True
        emit(e[0], scope + e[1], e[2])
        return True
    m = re.fullmatch(r"downsample\.0\.weight", name)
    if m:
        emit("params", scope + ("downsample_conv", "kernel"), _CONV_W[1](value))
        return True
    m = re.fullmatch(r"downsample\.1\.(\w+)", name)
    if m:
        e = _bn_entries("downsample_bn", m.group(1), value)
        if e is None:
            return True
        emit(e[0], scope + e[1], e[2])
        return True
    if name == "fc.weight":
        emit("params", scope + ("fc", "kernel"), _LINEAR_W[1](value))
        return True
    if name == "fc.bias":
        emit("params", scope + ("fc", "bias"), value)
        return True

    # --- spatial masker -------------------------------------------------
    m = re.fullmatch(r"masker_spatial\.conv\.(weight|bias)", name)
    if m:
        if m.group(1) == "weight":
            emit("params", scope + ("masker_spatial", "conv", "kernel"),
                 _CONV_W[1](value))
        else:
            emit("params", scope + ("masker_spatial", "conv", "bias"), value)
        return True

    # --- channel masker: MLP (Sequential Linear/ReLU/Linear or Linear) --
    m = re.fullmatch(r"masker_channel\.conv\.0\.(weight|bias)", name)
    if m and value.ndim <= 2:
        emit("params", scope + ("masker_channel", "fc1" if mlp_layers == 2 else "fc",
                                "kernel" if m.group(1) == "weight" else "bias"),
             _LINEAR_W[1](value) if m.group(1) == "weight" else value)
        return True
    m = re.fullmatch(r"masker_channel\.conv\.2\.(weight|bias)", name)
    if m:
        emit("params", scope + ("masker_channel", "fc2",
                                "kernel" if m.group(1) == "weight" else "bias"),
             _LINEAR_W[1](value) if m.group(1) == "weight" else value)
        return True
    m = re.fullmatch(r"masker_channel\.conv\.(weight|bias)", name)
    if m and value.ndim <= 2:  # single-Linear MLP head
        emit("params", scope + ("masker_channel", "fc",
                                "kernel" if m.group(1) == "weight" else "bias"),
             _LINEAR_W[1](value) if m.group(1) == "weight" else value)
        return True

    # --- channel masker: conv_linear (Conv/BN/ReLU + Linear) ------------
    m = re.fullmatch(r"masker_channel\.conv\.0\.weight", name)
    if m and value.ndim == 4:
        emit("params", scope + ("masker_channel", "conv", "kernel"),
             _CONV_W[1](value))
        return True
    m = re.fullmatch(r"masker_channel\.conv\.1\.(\w+)", name)
    if m:
        e = _bn_entries("bn", m.group(1), value)
        if e is None:
            return True
        emit(e[0], scope + ("masker_channel",) + e[1], e[2])
        return True
    m = re.fullmatch(r"masker_channel\.linear\.(weight|bias)", name)
    if m:
        emit("params", scope + ("masker_channel", "linear",
                                "kernel" if m.group(1) == "weight" else "bias"),
             _LINEAR_W[1](value) if m.group(1) == "weight" else value)
        return True

    return False
