"""Eval-with-info: per-image FLOPs and sparsity accounting over a dataset
(counterpart of `laudnet_tpu/detection/eval_info.py`, the reference's
``single_gpu_test_get_info``): run the detector over images and average
the realised FLOPs, dense FLOPs, FLOPs rate and per-block sparsities."""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np


def evaluate_get_info(apply_fn: Callable, images: Iterable) -> dict:
    """``apply_fn(image_batch) -> outputs`` with an ``additional`` entry of
    tensors. Returns the statistics aggregated over the iterable."""
    n = 0
    flops = dense = rate = 0.0
    ch = ly = fp = None
    for batch in images:
        out = apply_fn(batch)
        add = {k: v.detach().cpu().numpy()
               for k, v in out["additional"].items()}
        bsz = batch.shape[0]
        n += bsz
        flops += float(add["flops"]) * bsz
        dense += float(add["dense_flops"]) * bsz
        rate += float(add["flops"] / max(float(add["dense_flops"]), 1e-9)) \
            * bsz
        ch = (np.asarray(add["channel_sparsity"]) * bsz if ch is None
              else ch + np.asarray(add["channel_sparsity"]) * bsz)
        ly = (np.asarray(add["layer_sparsity"]) * bsz if ly is None
              else ly + np.asarray(add["layer_sparsity"]) * bsz)
        fp = (np.asarray(add["flops_perc"]) * bsz if fp is None
              else fp + np.asarray(add["flops_perc"]) * bsz)
    if n == 0:
        raise ValueError("evaluate_get_info: empty image iterable")
    return {
        "n_images": n,
        "mean_flops": flops / n,
        "mean_dense_flops": dense / n,
        "mean_flops_rate": rate / n,
        "mean_channel_sparsity": ch / n,
        "mean_layer_sparsity": ly / n,
        "mean_flops_perc": fp / n,
    }
