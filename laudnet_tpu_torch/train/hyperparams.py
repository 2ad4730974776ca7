"""Training recipe presets (counterpart of
`laudnet_tpu/train/hyperparams.py`).

Numbered recipes selected by ``hyperparams_set_index`` in the experiment
config. The published runs use set 2 (bs 512, lr 0.04) and set 3 (bs 1024,
lr 0.08), both 100 epochs cosine, wd 5e-5, nesterov.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Recipe:
    epochs: int = 100
    start_eval_epoch: int = 90
    batch_size: int = 256
    optimizer: str = "SGD"
    lr: float = 0.02
    momentum: float = 0.9
    weight_decay: float = 5e-5
    weight_decay_on_all: bool = True
    nesterov: bool = True
    scheduler: str = "cosine"
    warmup_epochs: int = 0
    warmup_lr_frac: float = 0.1
    lr_min: float = 0.0
    label_smooth: float = 0.0

    @property
    def warmup_lr(self) -> float:
        return self.lr * self.warmup_lr_frac


def _sgd(batch_size: int, lr_per_256: float = 0.02, **kw) -> Recipe:
    return Recipe(batch_size=batch_size, lr=lr_per_256 * batch_size / 256, **kw)


RECIPES = {
    0: _sgd(128),
    1: _sgd(256),
    2: _sgd(512),  # published: bs 512, lr 0.04
    21: _sgd(512, 0.01),
    22: _sgd(512, 0.04),
    23: _sgd(512, 0.005),
    3: _sgd(1024),  # published: bs 1024, lr 0.08
    30: replace(_sgd(1024), epochs=10, start_eval_epoch=0),
    4: _sgd(2048),
    5: _sgd(1024, 0.1, epochs=300, start_eval_epoch=290),
    6: _sgd(1024, epochs=200, start_eval_epoch=190),
}


def get_hyperparams(set_index: int) -> Recipe:
    if set_index not in RECIPES:
        raise KeyError(
            f"unknown hyperparams_set_index {set_index}; "
            f"known: {sorted(RECIPES)}")
    return RECIPES[set_index]
