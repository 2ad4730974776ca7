"""The ``laudnet`` namespace of `torch.library`: the kernels' registered
ops.

A kernel's wrapper calls its op, so that `torch.export` records the call as
one node (a ctypes launch cannot run on export's fake tensors) and a
loaded program launches the same kernels (`infer/aot.py`). Each op has a
CPU implementation (the plain PyTorch version), a CUDA one (the kernels,
or a raise) and a fake one (the outputs' shapes and types). They are
registered through `torch.library.Library` directly, not through
`torch.library.custom_op`, whose Python wrapper around every call added
several times the host time a call (`PERF.md` §6): the block engine
calls its op once a layer.
"""

from __future__ import annotations

import torch

LIB = torch.library.Library("laudnet", "FRAGMENT")


def register(schema: str, cpu, cuda, fake):
    """Defines ``laudnet::<schema>`` with its three implementations and
    returns the op's overload, which is what the wrappers call."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"laudnet::{name}", fake, lib=LIB)
    return getattr(torch.ops.laudnet, name).default
