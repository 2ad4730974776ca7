"""Capacity calibration for the static-shape serving paths (counterpart of
`laudnet_tpu/infer/calibrate.py`).

The serving paths (ViT token selection, CNN patch capacity) need fixed
budgets; this module measures the realized densities of a trained model
over calibration data and converts a quantile (+ safety margin) into
per-block capacities — the step that makes capacity-based execution
*exact* in practice (budget >= realized keep-count => bit-equivalence with
the masked graph; see `models/laud_vit.py` token_capacity docs).

Calibration quantiles run over PER-IMAGE keep fractions
(``LAUDViTOutput.token_keep`` / ``LAUDOutput.spatial_s3_img``), never over
batch means — a batch mean hides the tail image whose realized keep count
exceeds it, which would silently drop active tokens/patches at serving and
break the bit-equivalence guarantee. Run the calibration forward passes
WITHOUT ``token_capacity`` / sparse execution so the densities reflect the
unconstrained policy.

Densities and masks are read to the host as numpy arrays
(``.cpu().numpy()``) and every quantile is numpy's, so the budgets are
the JAX package's on the same densities.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch


def _np(t) -> np.ndarray:
    """A tensor (or array) on the host as numpy, in its own dtype."""
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def calibrate_token_capacity(apply_fn: Callable, batches: Iterable,
                             quantile: float = 0.99,
                             margin: float = 0.05) -> Sequence[float]:
    """``apply_fn(images) -> LAUDViTOutput`` (no token_capacity set).

    Returns per-block keep fractions covering the ``quantile`` of per-image
    realized keep fractions across all calibration images, plus ``margin``.
    With ``quantile=1.0`` and any positive margin, every calibration image's
    keep count is covered exactly (bit-equivalence on the calibration set).
    """
    per_image = []  # each (depth, B)
    for images in batches:
        out = apply_fn(images)
        keep = _np(out.token_keep)
        if keep.ndim != 2:
            raise ValueError(
                "calibrate_token_capacity needs per-image keep fractions "
                "(LAUDViTOutput.token_keep of shape (depth, B)); got shape "
                f"{keep.shape}"
            )
        per_image.append(keep)
    if not per_image:
        raise ValueError("no calibration batches — the iterable was empty "
                         "(an already-consumed generator?)")
    dens = np.concatenate(per_image, axis=1)  # (depth, n_images)
    caps = np.quantile(dens, quantile, axis=1) + margin
    return tuple(float(min(c, 1.0)) for c in caps)


def calibrate_channel_masks(mask_fn: Callable, batches: Iterable,
                            keep_threshold: float = 0.5):
    """Majority-vote channel-group masks for the static exporter.

    ``mask_fn(images) -> list of (B, G_b) per-block 0/1 masks`` (e.g. a
    model.apply wrapper capturing each block's channel mask). Returns one
    binary mask per block: groups kept on at least ``keep_threshold`` of
    calibration samples (always >= 1 group). Feed the result to
    :func:`laudnet_tpu_torch.infer.export_pruned.export_pruned_resnet`;
    re-validate accuracy —
    this converts the dynamic policy into a static one.
    """
    sums, counts = None, 0
    for images in batches:
        masks = [_np(m) for m in mask_fn(images)]
        if sums is None:
            sums = [m.sum(axis=0) for m in masks]
        else:
            sums = [s + m.sum(axis=0) for s, m in zip(sums, masks)]
        counts += masks[0].shape[0]
    if sums is None:
        raise ValueError("no calibration batches — the iterable was empty "
                         "(an already-consumed generator?)")
    out = []
    for s in sums:
        keep = (s / counts >= keep_threshold).astype(np.float32)
        if keep.sum() == 0:
            keep[int(np.argmax(s))] = 1.0
        out.append(keep)
    return out


def calibration_fidelity(mask_fn: Callable, static_masks, batches: Iterable):
    """Measure how faithful a static channel mask is to the dynamic policy.

    For each block, returns the mean per-image agreement between the
    dynamic per-image masks (``mask_fn(images) -> list of (B, G_b)``) and
    the calibrated ``static_masks`` (from :func:`calibrate_channel_masks`),
    plus the fraction of dynamic-ON groups the static mask covers (recall).
    This is the honest metric to report next to any statically-exported
    benchmark number: it quantifies how much of the input-dependence the
    export throws away.
    """
    agree_sum = None
    cover_sum = None
    n = 0
    for images in batches:
        masks = [_np(m) for m in mask_fn(images)]
        if agree_sum is None:
            agree_sum = np.zeros(len(masks))
            cover_sum = np.zeros(len(masks))
        for i, (m, s) in enumerate(zip(masks, static_masks)):
            s = np.asarray(s)[None, :]
            agree_sum[i] += float((m == s).mean(axis=1).sum())
            on = m.sum(axis=1)
            covered = (m * s).sum(axis=1)
            cover_sum[i] += float(
                np.where(on > 0, covered / np.maximum(on, 1), 1.0).sum()
            )
        n += masks[0].shape[0]
    if n == 0:
        raise ValueError("no calibration batches — the iterable was empty "
                         "(an already-consumed generator?)")
    return {
        "agreement": tuple(float(a / n) for a in agree_sum),
        "coverage": tuple(float(c / n) for c in cover_sum),
        "mean_agreement": float(np.mean(agree_sum) / n),
        "mean_coverage": float(np.mean(cover_sum) / n),
    }


def make_channel_mask_fn(model, temperature: float = 0.1):
    """Build a ``mask_fn(images) -> [per-block (B, G_b) masks]`` for the
    calibrators by capturing every block's ``masker_channel`` output in an
    eval forward of a LAUD CNN (forward hooks; the JAX package captures
    flax intermediates). Blocks are ordered naturally (layer1_0, layer1_1,
    ..., layer3_10, ...)."""
    maskers = [getattr(model, n).masker_channel
               for names in model.block_names for n in names]
    maskers = [m for m in maskers if m is not None]

    @torch.no_grad()
    def mask_fn(images):
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: seen.append(out[0])) for m in maskers]
        try:
            model(images, temperature)
        finally:
            for h in hooks:
                h.remove()
        # masker output is the tuple (mask, density, flops)
        return [_np(m) for m in seen]

    return mask_fn


def calibrate_patch_capacity(apply_fn: Callable, batches: Iterable,
                             quantile: float = 0.99,
                             margin: float = 0.05) -> Sequence[float]:
    """Same for CNN spatial blocks: ``apply_fn(images) -> LAUDOutput``.

    Uses the per-image conv3-mask densities (``LAUDOutput.spatial_s3_img``,
    per stage ``(blocks, B)``); the per-stage capacity covers the quantile
    of per-image densities of the stage's *worst* block, plus ``margin``.
    """
    per_stage = None  # list over stages of list of (blocks, B)
    for images in batches:
        out = apply_fn(images)
        if out.spatial_s3_img is None:
            raise ValueError(
                "calibrate_patch_capacity needs LAUDOutput.spatial_s3_img "
                "(per-image densities); re-run with a model that returns it"
            )
        if per_stage is None:
            per_stage = [[] for _ in out.spatial_s3_img]
        for i, s in enumerate(out.spatial_s3_img):
            per_stage[i].append(_np(s))
    if per_stage is None:
        raise ValueError("no calibration batches — the iterable was empty "
                         "(an already-consumed generator?)")
    caps = []
    for chunks in per_stage:
        dens = np.concatenate(chunks, axis=1)  # (blocks, n_images)
        q = np.quantile(dens, quantile, axis=1)  # per-block image quantile
        caps.append(float(min(q.max() + margin, 1.0)))
    return tuple(caps)
