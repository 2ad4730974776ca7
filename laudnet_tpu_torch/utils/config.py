"""Python-file experiment configs (counterpart of
`laudnet_tpu/utils/config.py`).

``Config.fromfile("cfg.py")`` executes the file and exposes its top-level
names as attributes, with optional single-level ``_base_`` inheritance
(`configs/finetune_100eps_1024bs_lr0x08.py` just sets
``train_cfg = dict(hyperparams_set_index=3)``).
"""

from __future__ import annotations

import os
import types
from typing import Any, Dict


class Config(dict):
    """dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            v = Config(v)
            self[name] = v
        return v

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    @staticmethod
    def fromfile(path: str) -> "Config":
        return Config(_exec_py(path))


def _exec_py(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    ns: Dict[str, Any] = {"__file__": path}
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, ns)
    out: Dict[str, Any] = {}
    base = ns.pop("_base_", None)
    if base:
        bases = base if isinstance(base, (list, tuple)) else [base]
        for b in bases:
            out.update(_exec_py(os.path.join(os.path.dirname(path), b)))
    for k, v in ns.items():
        if k.startswith("_") or isinstance(v, types.ModuleType) or callable(v):
            continue
        out[k] = v
    return out
