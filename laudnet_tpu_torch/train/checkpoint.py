"""Checkpoint save and resume over ``torch.save`` (counterpart of
`laudnet_tpu/train/checkpoint.py`).

Stores the model's parameters, the optimizer's state and the step count as
``step_<n>.pt``, plus host metadata (epoch, metrics) as ``meta_<n>.json``.
The newest ``max_to_keep`` steps are kept; ``best/`` holds the one
checkpoint last saved with ``is_best`` and ``best.json`` its metadata, so
the best weights survive the rolling deletion. Files are written to a
temporary name and renamed, so a reader never sees half a file.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch


def _atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _json_writer(obj):
    def write(path):
        with open(path, "w") as f:
            json.dump(obj, f)
    return write


class CheckpointManager:
    """Rolling checkpoint manager over ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.best_directory = os.path.join(self.directory, "best")
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    @staticmethod
    def _steps(directory: str) -> List[int]:
        if not os.path.isdir(directory):
            return []
        found = (re.fullmatch(r"step_(\d+)\.pt", n)
                 for n in os.listdir(directory))
        return sorted(int(m.group(1)) for m in found if m)

    def all_steps(self) -> List[int]:
        return self._steps(self.directory)

    def save(self, step: int, state, metadata: Optional[Dict[str, Any]] = None,
             is_best: bool = False) -> None:
        """``state``: anything with ``model``, ``optimizer`` and ``step``
        (`train.trainer.TrainState`)."""
        payload = {"step": int(step), "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        _atomic(os.path.join(self.directory, f"step_{step}.pt"),
                lambda p: torch.save(payload, p))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(os.path.join(self.directory, f"step_{old}.pt"))
        if metadata is not None:
            _atomic(os.path.join(self.directory, f"meta_{step}.json"),
                    _json_writer(metadata))
        live = set(self.all_steps())
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"meta_(\d+)\.json", name)
            if m and int(m.group(1)) not in live:
                os.unlink(os.path.join(self.directory, name))
        if is_best:
            os.makedirs(self.best_directory, exist_ok=True)
            _atomic(os.path.join(self.best_directory, f"step_{step}.pt"),
                    lambda p: torch.save(payload, p))
            for old in self._steps(self.best_directory):
                if old != step:
                    os.unlink(os.path.join(self.best_directory,
                                           f"step_{old}.pt"))
            _atomic(os.path.join(self.directory, "best.json"),
                    _json_writer({"step": step, **(metadata or {})}))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load(self, path: str, state, meta_path: str
              ) -> Tuple[Any, Dict[str, Any]]:
        device = next(state.model.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        metadata = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        return state, metadata

    def restore(self, state) -> Tuple[Any, Dict[str, Any]]:
        """Loads the latest checkpoint into ``state`` (its model and
        optimizer in place, and its step). Returns ``(state, metadata)``."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return self._load(os.path.join(self.directory, f"step_{step}.pt"),
                          state,
                          os.path.join(self.directory, f"meta_{step}.json"))

    def restore_best(self, state) -> Tuple[Any, Dict[str, Any]]:
        """Loads the checkpoint last saved with ``is_best=True``."""
        steps = self._steps(self.best_directory)
        if not steps:
            raise FileNotFoundError(
                f"no best checkpoint in {self.directory}")
        return self._load(
            os.path.join(self.best_directory, f"step_{steps[-1]}.pt"), state,
            os.path.join(self.directory, "best.json"))

    def close(self) -> None:
        """Nothing is left open; kept for the JAX manager's interface."""
