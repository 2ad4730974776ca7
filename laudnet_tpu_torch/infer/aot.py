"""Ahead-of-time serving artifacts through `torch.export` (counterpart of
`laudnet_tpu/infer/aot.py`).

A serving forward (model and trained weights, fixed batch geometry) is
exported to one program with its weights inside and saved with
`torch.export.save`. A serving process loads it with
`load_serving_artifact` and needs no model code: only ``import
laudnet_tpu_torch.ops``, which registers the kernels' ``laudnet::*`` ops
that the program calls (B1, B2, B6, B4; `ops/vit_block.py`,
`ops/vit_attention.py`, `ops/masked_block.py`). On a card those ops launch
the kernels, as the live model does.

The JAX function's ``platforms`` has no counterpart: an exported program
runs on the device it was exported on. A program keeps no backend flag
either: an f32 CNN, whose live forward switches cuDNN's TF32 off
(`device.full_f32_convolutions`), serves the same numbers from its program
inside that context.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from laudnet_tpu_torch.device import resolve_device


class _Serve(nn.Module):
    """``fn(images) -> logits`` as the module `torch.export` takes; a model
    passed along is a submodule, so its weights are the program's
    parameters."""

    def __init__(self, fn: Callable, model: Optional[nn.Module] = None):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, x):
        return self.fn(x)


def export_serving_fn(apply_fn: Callable, batch_shape: Sequence[int],
                      dtype: torch.dtype = torch.float32,
                      device=None) -> bytes:
    """Serialises ``apply_fn(images) -> logits`` (an ``nn.Module`` or any
    callable; tensors it closes over become constants of the program) for
    one input geometry: ``batch_shape`` of ``dtype`` on ``device`` (the
    card unless ``"cpu"`` is asked for). Returns the bytes of
    `torch.export.save`. The forward is traced without autograd."""
    module = apply_fn if isinstance(apply_fn, nn.Module) else _Serve(apply_fn)
    example = torch.zeros(tuple(batch_shape), dtype=dtype,
                          device=resolve_device(device))
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_serving_artifact(path: str, model: nn.Module,
                          batch_shape: Sequence[int], *,
                          temperature: float = 0.1,
                          dtype: torch.dtype = torch.float32,
                          metadata: Optional[dict] = None) -> str:
    """Exports ``model(x, temperature, training=False).logits`` on the
    model's device and writes ``<path>.pt2`` and ``<path>.json`` (the
    geometry, the temperature, the model's class and the user's
    ``metadata``, which overrides the built-in keys). Returns the program's
    path."""

    def serve(x):
        return model(x, temperature, training=False).logits

    device = next(model.parameters()).device
    blob = export_serving_fn(_Serve(serve, model), batch_shape, dtype, device)
    meta = {
        "batch_shape": list(batch_shape),
        "dtype": str(dtype).removeprefix("torch."),
        "temperature": temperature,
        "model": type(model).__name__,
        **(metadata or {}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path + ".pt2", "wb") as f:
        f.write(blob)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return path + ".pt2"


def load_serving_artifact(path: str) -> Callable:
    """Loads a ``.pt2`` artifact (the path with or without its suffix) into
    ``serve(images) -> logits``, run without autograd; the loaded module is
    ``serve.module``. Another input geometry than the exported one
    raises."""
    import laudnet_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)

    if not path.endswith(".pt2"):
        path = path + ".pt2"
    with open(path, "rb") as f:
        module = torch.export.load(f).module()

    @torch.no_grad()
    def serve(x):
        return module(x)

    serve.module = module
    return serve
