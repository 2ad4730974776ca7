"""Logging helper (counterpart of `laudnet_tpu/utils/logging_utils.py`)."""

from __future__ import annotations

import os


class Logger:
    """Tee: prints and appends to a log file."""

    def __init__(self, filename: str):
        self.filename = filename
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        with open(self.filename, "w") as f:
            f.write("==================== start running ====================\n")

    def log(self, msg, isprint: bool = True):
        if isprint:
            print(msg, flush=True)
        with open(self.filename, "a") as f:
            f.write(str(msg) + "\n")

    __call__ = log
