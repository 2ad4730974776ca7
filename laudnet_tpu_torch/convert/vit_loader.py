"""DeiT/ViT PyTorch state dict -> LAUDViT flax-named params (counterpart
of `laudnet_tpu/convert/vit_loader.py`).

The reference defers ViT training to the external AdaViT repo, which
finetunes from timm DeiT checkpoints; this converter brings those (or any
timm-convention ViT state dict) into the flax-named tree that
`convert/from_jax.py::load_flax_variables` puts into the port's `LAUDViT`.
Policy heads are left at init (`merge_variables`, the strict=False
analog).

Name mapping (timm -> flax):

==================================  ======================================
``patch_embed.proj.weight`` (OIHW)  ``patch_embed/kernel`` (HWIO)
``cls_token`` / ``pos_embed``       same names (identical layouts)
``blocks.i.norm1.weight/bias``      ``block_{i}/norm1/scale,bias``
``blocks.i.attn.qkv.weight``        ``block_{i}/qkv/kernel`` (in,out):
                                    the (3, heads, dh) output layout is
                                    identical, so a plain transpose works
``blocks.i.attn.proj.*``            ``block_{i}/proj/*``
``blocks.i.mlp.fc1/fc2.*``          ``block_{i}/fc1,fc2/*``
``norm.*`` / ``head.*``             ``norm/*`` / ``head/*``
==================================  ======================================
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np


def convert_vit_state_dict(state: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Returns ``{"params": tree}`` (LayerNorm-only model: no batch_stats).

    Ignores keys with no LAUDViT analog (``dist_token``, distilled heads);
    raises on shape-incompatible layouts so silent misloads can't happen.
    """
    params: Dict[str, Any] = {}

    def put(path, value):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value)

    for name, value in state.items():
        v = np.asarray(value)
        if name == "patch_embed.proj.weight":
            put(("patch_embed", "kernel"), v.transpose(2, 3, 1, 0))  # OIHW->HWIO
        elif name == "patch_embed.proj.bias":
            put(("patch_embed", "bias"), v)
        elif name in ("cls_token", "pos_embed"):
            put((name,), v)
        elif name in ("norm.weight", "norm.bias"):
            put(("norm", "scale" if name.endswith("weight") else "bias"), v)
        elif name in ("head.weight", "head.bias"):
            if name.endswith("weight"):
                put(("head", "kernel"), v.T)  # (out,in)->(in,out)
            else:
                put(("head", "bias"), v)
        else:
            m = re.match(r"blocks\.(\d+)\.(.+)", name)
            if not m:
                continue  # dist_token, pre_logits, ... no analog
            i, rest = int(m.group(1)), m.group(2)
            scope = f"block_{i}"
            ln = re.match(r"(norm[12])\.(weight|bias)", rest)
            if ln:
                put((scope, ln.group(1),
                     "scale" if ln.group(2) == "weight" else "bias"), v)
                continue
            lin = re.match(r"(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)"
                           r"\.(weight|bias)", rest)
            if lin:
                flax_name = lin.group(1).split(".")[-1]
                if lin.group(2) == "weight":
                    put((scope, flax_name, "kernel"), v.T)
                else:
                    put((scope, flax_name, "bias"), v)
            else:
                # an unmapped BLOCK weight (layer-scale gamma, qk-norm, ...)
                # would silently change the function — refuse, don't misload
                raise ValueError(
                    f"unsupported ViT block parameter {name!r}: this "
                    "checkpoint is not plain-DeiT-shaped (layer scale / "
                    "qk-norm have no LAUDViT analog)"
                )
    return {"params": params}
