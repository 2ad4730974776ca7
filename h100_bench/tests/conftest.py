"""The benchmark's tests (see ``bench_tiny.py`` for their sizes).

    python -m pytest h100_bench/tests -q            # CPU; card tests skip
    python -m pytest h100_bench/tests -q -m cuda    # on a machine with a card
"""

from __future__ import annotations

import pytest


@pytest.fixture
def card():
    """Skips a test where there is no CUDA card (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
