"""Faults planted in the program where its outputs are produced: the
check has to read each as not correct. The tests drive whole runs with the
entry wrapped by each (`broken_serve`, `broken_step`); `control.py` reads
their numbers on the card.

Serving: ``answer_altered``, one image's logits replaced by its
neighbour's; ``half_batch``, half of the batch left out, its rows
answered with the other half's. Training: ``state_unchanged``, a step
that returns the parameters as it found them; ``half_batch``, a step on
half of the batch, the mean taken over the rest.
"""

from __future__ import annotations

import torch


def answer_altered(logits):
    logits[0] = logits[1]
    return logits


def half_batch(logits):
    half = logits.shape[0] // 2
    logits[half:2 * half] = logits[:half]
    return logits


SERVED = {"answer_altered": answer_altered, "half_batch": half_batch}


class broken_serve:
    """The serving entry ``serve`` with ``fault`` applied to each batch's
    logits as they come out (the entry's attributes read through)."""

    def __init__(self, serve, fault):
        self.serve, self.fault = serve, fault

    def __call__(self, x):
        return self.fault(self.serve(x))

    def __getattr__(self, name):
        return getattr(self.serve, name)


def state_unchanged(step):
    """A training step that leaves the model's parameters as it found
    them."""
    def broken(state, x, y):
        saved = [p.detach().clone() for p in state.model.parameters()]
        metrics = step(state, x, y)
        with torch.no_grad():
            for p, v in zip(state.model.parameters(), saved):
                p.copy_(v)
        return metrics
    return broken


def half_step(step):
    """A training step on the first half of the batch only."""
    def broken(state, x, y):
        half = x.shape[0] // 2
        return step(state, x[:half], y[:half])
    return broken


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_step}
