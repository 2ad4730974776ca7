"""COCO-style detection training and evaluation runner (counterpart of
`laudnet_tpu/detection/runner.py`).

One train step drives RetinaNet, Faster/Mask R-CNN or the DETR family
(DDQ-DETR, Mask2Former) on a LAUD backbone with the reference's knobs:
the backbone's ``lr_mult`` (the scale_backbone_lr configs use 0.2-0.5), a
fixed Gumbel temperature, and the ``loss_sparse`` injection. Evaluation is mAP plus the per-image FLOPs
accounting of `detection/eval_info.py`.

The optimizer is the JAX package's detection SGD, not the classification
one (`train/optim.py::make_sgd`): weight decay on every parameter (biases
and BatchNorm scales included), plain momentum, and three groups:
``backbone`` at ``lr_mult``, ``masker`` (every path holding ``masker`` or
``_policy``) and ``head`` at 1. A parameter the loss does not reach still
decays, as an optax update over the whole tree does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from laudnet_tpu_torch.detection.detr import UniformDraws, detr_loss
from laudnet_tpu_torch.detection.train import retinanet_loss
from laudnet_tpu_torch.detection.two_stage_train import faster_rcnn_loss
from laudnet_tpu_torch.device import full_f32_convolutions
from laudnet_tpu_torch.ops.gating import GumbelNoise
from laudnet_tpu_torch.train.optim import set_learning_rate
from laudnet_tpu_torch.train.trainer import TrainState, step_seed

DETR_TYPES = ("DETRDetector", "Mask2Former")


def build_detector(model_cfg: dict, *, device=None,
                   generator: Optional[torch.Generator] = None,
                   image_size=None):
    """Instantiates a detector from a ``configs/detection/*.py`` model dict
    (``type`` selects the class, the rest are constructor arguments; a
    truthy ``amp`` gives ``compute_dtype=torch.bfloat16``). Returns
    ``(model, kind)``, ``kind`` the runner's loss and decode key. The DETR
    family takes ``image_size`` (its position embeddings are sized from
    the input) and refuses ``amp``, as the JAX package does: it stays f32
    (its Hungarian costs are tie-sensitive)."""
    from laudnet_tpu_torch.detection.detr import DETRDetector
    from laudnet_tpu_torch.detection.retinanet import RetinaNet
    from laudnet_tpu_torch.detection.two_stage import FasterRCNN

    cfg = dict(model_cfg)
    name = cfg.pop("type")
    classes = {"RetinaNet": (RetinaNet, "retinanet"),
               "FasterRCNN": (FasterRCNN, "faster_rcnn"),
               "MaskRCNN": (FasterRCNN, "faster_rcnn"),
               "DETRDetector": (DETRDetector, "detr"),
               "Mask2Former": (DETRDetector, "detr")}
    if name not in classes:
        raise ValueError(f"unknown detector type {name!r}")
    klass, kind = classes[name]
    if name in ("MaskRCNN", "Mask2Former"):
        cfg.setdefault("with_masks", True)
    for k in ("dyn_mode", "backbone_layers", "out_indices"):
        if k in cfg:
            cfg[k] = tuple(cfg[k])
    if cfg.pop("amp", False):
        if kind == "detr":
            raise ValueError("amp=True is not supported for the DETR "
                             "family (f32 Hungarian matching); remove it "
                             "from the config")
        # bf16 towers over f32 masters; gating heads and final predictors
        # exit f32, so decode, matching and losses are unchanged
        cfg["compute_dtype"] = torch.bfloat16
    if kind == "detr":
        cfg["image_size"] = image_size
    return klass(device=device, generator=generator, **cfg), kind


# --- optimizer: backbone / masker / head LR groups -------------------------

def detection_param_label(name: str) -> str:
    """'masker' for gating heads, 'backbone' for the rest of the backbone
    scope, 'head' for the necks and heads."""
    parts = name.split(".")
    if any("masker" in k or "_policy" in k for k in parts):
        return "masker"
    if any("backbone" in k for k in parts):
        return "backbone"
    return "head"


def detection_param_labels(model: nn.Module) -> dict:
    """The label of every parameter, by its name."""
    return {name: detection_param_label(name)
            for name, _ in model.named_parameters()}


def make_detection_sgd(model: nn.Module, *, lr_mult: float = 0.2,
                       momentum: float = 0.9, weight_decay: float = 1e-4,
                       nesterov: bool = False) -> torch.optim.SGD:
    """SGD over the three groups, weight decay on every parameter. The
    learning rate starts at 0: set it each step with
    `train.optim.set_learning_rate`."""
    mults = {"backbone": lr_mult, "masker": 1.0, "head": 1.0}
    groups = {label: [] for label in mults}
    for name, param in model.named_parameters():
        groups[detection_param_label(name)].append(param)
    return torch.optim.SGD(
        [dict(params=params, name=label, lr_mult=mults[label])
         for label, params in groups.items() if params],
        lr=0.0, momentum=momentum, nesterov=nesterov,
        weight_decay=weight_decay)


# --- train step ---------------------------------------------------------------

@dataclass
class DetTrainConfig:
    num_classes: int = 80
    base_lr: float = 0.01
    lr_mult: float = 0.2
    epochs: int = 12
    steps_per_epoch: int = 100
    warmup_steps: int = 50
    sparsity_target: float = 0.5
    lambda_sparse: float = 1.0
    with_masks: bool = False
    # Mask2Former's point-sampled mask loss (12544 points, oversample 3.0,
    # importance 0.75 in the reference); None: the dense full-grid loss of
    # the final layer
    mask_points: Optional[int] = None
    oversample_ratio: float = 3.0
    importance_ratio: float = 0.75


def lr_at(step: int, cfg: DetTrainConfig) -> float:
    """mmdet's 1x schedule: linear warmup, then step decay at epochs 8 and
    11 (of 12). A decay epoch that truncates to 0 (a one-epoch smoke run)
    is disabled rather than decaying from step 0. Computed in f32, as the
    JAX schedule is."""
    f32 = np.float32
    warm = min((f32(step) + f32(1.0)) / f32(max(cfg.warmup_steps, 1)),
               f32(1.0))
    epoch = step // cfg.steps_per_epoch
    e8 = int(cfg.epochs * 8 / 12) or cfg.epochs + 1
    e11 = int(cfg.epochs * 11 / 12) or cfg.epochs + 1
    decay = f32(0.01 if epoch >= e11 else 0.1 if epoch >= e8 else 1.0)
    return float(f32(cfg.base_lr) * warm * decay)


def make_detector_train_step(model: nn.Module, optimizer, cfg: DetTrainConfig,
                             kind: str = "faster_rcnn", seed: int = 0,
                             noise=None, dn_draws=None,
                             mask_draws=None) -> Callable:
    """Builds ``train_step(state, images, gt_boxes, gt_labels, gt_valid,
    gt_masks=None) -> metrics`` for ``kind`` in {'retinanet',
    'faster_rcnn', 'detr'} (the mask loss joins when the model emits mask
    logits and the batch carries masks). ``state`` is a
    `train.trainer.TrainState`; the model and optimizer update in place.
    The Gumbel noise is a `GumbelNoise` on the model's device re-seeded
    each step from (seed, step), or the given ``noise`` source. DETR's
    denoising draws and mask-loss points are `UniformDraws` re-seeded each
    step from (seed + 1, step) and (seed + 2, step), as JAX keys its ``dn``
    and mask streams, or the given ``dn_draws`` and ``mask_draws``. An f32
    model takes the whole step with cuDNN's TF32 off. The metrics stay on
    the device."""
    if kind not in ("retinanet", "faster_rcnn", "detr"):
        raise ValueError(f"unknown detector kind {kind!r}")
    device = next(model.parameters()).device
    own_noise = own_dn = own_mask = None
    if noise is None:
        own_noise = noise = GumbelNoise.seeded(seed, device)
    if kind == "detr":
        if dn_draws is None:
            own_dn = dn_draws = UniformDraws.seeded(seed + 1, device)
        if mask_draws is None:
            own_mask = mask_draws = UniformDraws.seeded(seed + 2, device)
    f32_model = getattr(model, "compute_dtype", None) is None
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, images, gt_boxes, gt_labels, gt_valid,
                   gt_masks=None):
        if f32_model:
            with full_f32_convolutions():
                return _train_step(state, images, gt_boxes, gt_labels,
                                   gt_valid, gt_masks)
        return _train_step(state, images, gt_boxes, gt_labels, gt_valid,
                           gt_masks)

    def _train_step(state, images, gt_boxes, gt_labels, gt_valid, gt_masks):
        step = state.step
        for source, base in ((own_noise, seed), (own_dn, seed + 1),
                             (own_mask, seed + 2)):
            if source is not None:
                source.reseed(step_seed(base, step))
        common = dict(num_classes=cfg.num_classes,
                      sparsity_target=cfg.sparsity_target,
                      lambda_sparse=cfg.lambda_sparse)
        if kind == "detr":
            kw = {}
            if getattr(model, "dn_groups", 0) > 0:
                kw = dict(dn_gt={"boxes_xyxy": gt_boxes, "labels": gt_labels,
                                 "valid": gt_valid}, dn_draws=dn_draws)
            out = model(images, training=True, noise=noise, **kw)
            total, metrics = detr_loss(
                out, gt_boxes, gt_labels, gt_valid,
                image_size=(float(images.shape[1]), float(images.shape[2])),
                gt_masks=gt_masks, mask_points=cfg.mask_points,
                oversample_ratio=cfg.oversample_ratio,
                importance_ratio=cfg.importance_ratio,
                mask_draws=mask_draws, **common)
        elif kind == "retinanet":
            out = model(images, training=True, noise=noise)
            total, metrics = retinanet_loss(out, gt_boxes, gt_labels,
                                            gt_valid, **common)
        else:
            out = model(images, training=True, gt_boxes=gt_boxes,
                        gt_valid=gt_valid, noise=noise)
            total, metrics = faster_rcnn_loss(out, gt_boxes, gt_labels,
                                              gt_valid, gt_masks=gt_masks,
                                              **common)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in params:  # the JAX update decays every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = lr_at(step, cfg)
        set_learning_rate(optimizer, lr)
        optimizer.step()
        state.step = step + 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return dict(metrics, loss=total.detach(), lr=lr)

    return train_step


# --- synthetic COCO (trainability smoke data) --------------------------------

def synthetic_coco_batches(batch_size: int, image_size, num_classes: int,
                           steps: int, max_gt: int = 4, seed: int = 0,
                           with_masks: bool = False):
    """Learnable synthetic detection data, draw for draw the JAX
    package's: each image holds 1..max_gt bright rectangles on noise, the
    rectangle's dominant colour channel its class (``num_classes <= 3``
    suits smoke tests). ``image_size``: a square side or ``(ih, iw)``."""
    rng = np.random.default_rng(seed)
    ih, iw = ((image_size, image_size) if isinstance(image_size, int)
              else image_size)
    for _ in range(steps):
        imgs = rng.normal(0, 0.1, (batch_size, ih, iw, 3))
        boxes = np.zeros((batch_size, max_gt, 4), np.float32)
        labels = np.zeros((batch_size, max_gt), np.int32)
        valid = np.zeros((batch_size, max_gt), np.float32)
        masks = np.zeros((batch_size, max_gt, ih, iw), np.float32)
        for b in range(batch_size):
            n = rng.integers(1, max_gt + 1)
            for m in range(n):
                w = rng.integers(iw // 4, iw // 2)
                h = rng.integers(ih // 4, ih // 2)
                x0 = rng.integers(0, iw - w)
                y0 = rng.integers(0, ih - h)
                c = int(rng.integers(0, min(num_classes, 3)))
                imgs[b, y0:y0 + h, x0:x0 + w, c] += 2.0
                boxes[b, m] = (x0, y0, x0 + w, y0 + h)
                labels[b, m] = c
                valid[b, m] = 1.0
                masks[b, m, y0:y0 + h, x0:x0 + w] = 1.0
        out = (imgs.astype(np.float32), boxes, labels, valid)
        yield out + ((masks,) if with_masks else ())


def batch_to_device(batch, device):
    """A numpy batch ``(images, boxes, labels, valid[, masks])`` as
    tensors on ``device``, the labels as int64."""
    out = [torch.as_tensor(np.asarray(a)).to(device) for a in batch]
    out[2] = out[2].long()
    return tuple(out)


# --- masks -------------------------------------------------------------------

def paste_mask(prob: np.ndarray, box: np.ndarray, img_h: int,
               img_w: int, threshold: float = 0.5) -> np.ndarray:
    """Paste a (m, m) mask probability map into its box on an (img_h,
    img_w) canvas: Mask R-CNN's paste step (bilinear resize to the box,
    threshold). Returns a bool mask."""
    out = np.zeros((img_h, img_w), bool)
    x0, y0, x1, y1 = [float(v) for v in box]
    x0i, y0i = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
    x1i, y1i = min(int(np.ceil(x1)), img_w), min(int(np.ceil(y1)), img_h)
    w, h = x1i - x0i, y1i - y0i
    if w <= 0 or h <= 0:
        return out
    m = prob.shape[0]
    ys = (np.arange(h) + 0.5) * (m / h) - 0.5
    xs = (np.arange(w) + 0.5) * (m / w) - 0.5
    y_idx = np.clip(ys, 0, m - 1)
    x_idx = np.clip(xs, 0, m - 1)
    y0f = np.clip(np.floor(y_idx).astype(int), 0, m - 1)
    x0f = np.clip(np.floor(x_idx).astype(int), 0, m - 1)
    y1f = np.minimum(y0f + 1, m - 1)
    x1f = np.minimum(x0f + 1, m - 1)
    wy = (y_idx - y0f)[:, None]
    wx = (x_idx - x0f)[None, :]
    interp = (prob[np.ix_(y0f, x0f)] * (1 - wy) * (1 - wx)
              + prob[np.ix_(y1f, x0f)] * wy * (1 - wx)
              + prob[np.ix_(y0f, x1f)] * (1 - wy) * wx
              + prob[np.ix_(y1f, x1f)] * wy * wx)
    out[y0i:y1i, x0i:x1i] = interp >= threshold
    return out


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


# --- mAP ---------------------------------------------------------------------

def average_precision(recalls, precisions):
    """All-point interpolated AP (COCO-style area under the PR curve)."""
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(((r[idx + 1] - r[idx]) * p[idx + 1]).sum())


COCO_IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def _np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy IoU matrix in numpy (the host-side eval)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


def mean_average_precision(detections, ground_truths, num_classes: int,
                           iou_threshold: float = 0.5,
                           use_masks: bool = False,
                           iou_thresholds=None) -> dict:
    """mAP over per-image detections and ground truths.

    ``detections``: dicts with 'boxes' (N, 4), 'scores' (N,), 'classes'
    (N,) and, for ``use_masks`` (segm mAP), 'masks' (N, H, W) bool;
    ``ground_truths``: dicts with 'boxes' (M, 4), 'labels' (M,) [and
    'masks' (M, H, W)]. Zero-score detections (the static-shape pads) are
    ignored. ``iou_thresholds``: None -> AP at ``iou_threshold``; 'coco'
    or a list -> the average over IoU 0.50:0.05:0.95 (COCOeval's
    headline) as 'mAP', with 'mAP50' beside it. Returns {'mAP',
    'ap_per_class'[, 'mAP50']}."""
    if iou_thresholds == "coco":
        thresholds = list(COCO_IOU_THRESHOLDS)
    elif iou_thresholds is not None:
        thresholds = [float(t) for t in iou_thresholds]
    else:
        thresholds = [iou_threshold]

    ap_per_class = {t: [] for t in thresholds}
    any_class = False
    for c in range(num_classes):
        scored = []  # (score, image_idx, det_idx)
        n_gt = 0
        # per-image IoU matrix (class-c dets x class-c gts), computed once
        ious_by_img = {}
        gt_idx_by_img = {}
        for i, (det, gt) in enumerate(zip(detections, ground_truths)):
            keep = (np.asarray(det["classes"]) == c) & (
                np.asarray(det["scores"]) > 0)
            det_idx = np.where(keep)[0]
            gt_idx = np.where(np.asarray(gt["labels"]) == c)[0]
            n_gt += len(gt_idx)
            if len(det_idx) == 0:
                continue
            for d_idx in det_idx:
                scored.append((float(np.asarray(det["scores"])[d_idx]),
                               i, int(d_idx)))
            gt_idx_by_img[i] = gt_idx
            if len(gt_idx) == 0:
                ious_by_img[i] = {}
                continue
            if use_masks:
                ious_by_img[i] = {
                    int(d): np.asarray([
                        mask_iou(np.asarray(det["masks"][d]),
                                 np.asarray(gt["masks"][g]) > 0.5)
                        for g in gt_idx])
                    for d in det_idx}
            else:
                mat = _np_box_iou(
                    np.asarray(det["boxes"], np.float32)[det_idx],
                    np.asarray(gt["boxes"], np.float32)[gt_idx])
                ious_by_img[i] = {int(d): mat[k]
                                  for k, d in enumerate(det_idx)}
        if n_gt == 0:
            continue
        any_class = True
        scored.sort(key=lambda t: -t[0])
        for thr in thresholds:
            matched = [set() for _ in ground_truths]
            tp = np.zeros(len(scored))
            fp = np.zeros(len(scored))
            for k, (s, i, d_idx) in enumerate(scored):
                gt_idx = gt_idx_by_img.get(i, ())
                if len(gt_idx) == 0:
                    fp[k] = 1
                    continue
                ious = ious_by_img[i][d_idx]
                # COCO-style matching: GTs in IoU order, the best one
                # still unmatched above the threshold
                hit = False
                for j in np.argsort(-ious):
                    if ious[j] < thr:
                        break
                    if gt_idx[j] not in matched[i]:
                        tp[k] = 1
                        matched[i].add(gt_idx[j])
                        hit = True
                        break
                if not hit:
                    fp[k] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            recalls = ctp / n_gt
            precisions = ctp / np.maximum(ctp + cfp, 1e-9)
            ap_per_class[thr].append(average_precision(recalls, precisions))

    if not any_class:
        return {"mAP": 0.0, "ap_per_class": np.asarray([]), "mAP50": 0.0}
    per_class = np.mean([np.asarray(ap_per_class[t]) for t in thresholds],
                        axis=0)
    res = {"mAP": float(per_class.mean()), "ap_per_class": per_class}
    t50 = [t for t in thresholds if abs(t - 0.5) < 1e-6]
    if t50:  # label mAP50 only where 0.5 is evaluated
        res["mAP50"] = float(np.mean(ap_per_class[t50[0]]))
    return res


# --- runner ------------------------------------------------------------------

def load_backbone_checkpoint(model: nn.Module, path: str) -> None:
    """An ImageNet LAUD ``.pth[.tar]`` into ``model.backbone``, as the
    reference's ``init_cfg=Pretrained`` does: the reference checkpoint
    converted to flax names (`convert_detection_backbone_state_dict`),
    merged loosely over the backbone's own variables (`merge_variables`:
    the classifier is dropped, missing leaves stay) and loaded strictly
    (`load_flax_variables`)."""
    from laudnet_tpu_torch.convert import (
        convert_detection_backbone_state_dict, load_flax_variables,
        load_pth_tar, merge_variables, to_flax_variables)

    loaded = convert_detection_backbone_state_dict(load_pth_tar(path))
    base = to_flax_variables(model.backbone)
    load_flax_variables(model.backbone, {
        "params": merge_variables(base["params"],
                                  loaded["params"]["backbone"]),
        "batch_stats": merge_variables(base.get("batch_stats", {}),
                                       loaded["batch_stats"]["backbone"])})


def train_detector(model: nn.Module, cfg: DetTrainConfig, *,
                   kind: str = "faster_rcnn", image_size=128,
                   batch_size: int = 2, seed: int = 0,
                   data_fn: Optional[Callable] = None,
                   init_from: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   log: Callable = print, noise=None):
    """Detector fine-tuning on synthetic (or given) data, in place.

    ``data_fn(steps) -> iterator of (images, boxes, labels, valid[,
    masks])`` numpy batches; `synthetic_coco_batches` by default.
    ``init_from``: an ImageNet LAUD ``.pth[.tar]`` for the backbone
    (`load_backbone_checkpoint`). ``checkpoint_dir`` saves at each epoch's
    end and the last step and auto-resumes, replaying the data iterator to
    the saved step. Returns ``(model, history)``."""
    ih, iw = ((image_size, image_size) if isinstance(image_size, int)
              else image_size)
    device = next(model.parameters()).device
    if init_from:
        load_backbone_checkpoint(model, init_from)
        log(f"initialized backbone from {init_from}")
    optimizer = make_detection_sgd(model, lr_mult=cfg.lr_mult)
    state = TrainState(step=0, model=model, optimizer=optimizer)

    ckpt = None
    start_step = 0
    if checkpoint_dir:
        from laudnet_tpu_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(checkpoint_dir)
        if ckpt.latest_step() is not None:
            ckpt.restore(state)
            start_step = state.step
            log(f"auto-resumed detector from step {start_step}")

    step_fn = make_detector_train_step(model, optimizer, cfg, kind,
                                       seed=seed, noise=noise)
    if data_fn is None:
        def data_fn(steps):
            return synthetic_coco_batches(
                batch_size, (ih, iw), cfg.num_classes, steps, seed=seed,
                with_masks=cfg.with_masks)

    history = []
    t0 = time.time()
    total_steps = cfg.epochs * cfg.steps_per_epoch
    for i, batch in enumerate(data_fn(total_steps)):
        if i < start_step:
            continue  # resume: replay the data iterator to the right spot
        metrics = step_fn(state, *batch_to_device(batch, device))
        if i % 10 == 0 or i == total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            log(f"step {i}/{total_steps} loss {m['loss']:.4f} "
                f"flops_rate {m.get('flops_rate', 1.0):.3f} "
                f"lr {m['lr']:.5f} ({time.time() - t0:.1f}s)")
        if ckpt is not None and ((i + 1) % cfg.steps_per_epoch == 0
                                 or i == total_steps - 1):
            ckpt.save(state.step, state)
    if ckpt is not None:
        ckpt.close()
    return model, history


def _mask_probs(mask_logits, indices, classes):
    """The class slice of the mask logits behind each detection, as host
    probabilities ``1 / (1 + exp(-logit))``: (B, D, S, S)."""
    b, d = indices.shape
    picked = mask_logits[torch.arange(b, device=indices.device)[:, None],
                         indices]                       # (B, D, S, S, K)
    idx = classes[:, :, None, None, None].expand(picked.shape[:4] + (1,))
    ml = torch.gather(picked, 4, idx)[..., 0].cpu().numpy()
    return 1.0 / (1.0 + np.exp(-ml))


@torch.no_grad()
def evaluate_detector(model: nn.Module, batches, *, num_classes: int,
                      kind: str = "faster_rcnn",
                      score_threshold: float = 0.05,
                      iou_threshold: float = 0.5,
                      iou_thresholds="coco") -> dict:
    """mAP and per-image FLOPs accounting over an eval iterable of numpy
    ``(images, boxes, labels, valid[, masks])`` batches. With masks in the
    batches and mask logits from the model, segm mAP (mask IoU) joins box
    mAP. 'mAP' is COCO's (IoU 0.50:0.05:0.95); ``iou_thresholds=None``
    gives AP at ``iou_threshold``. The per-image FLOPs spread is included.
    Returns {'mAP', 'mAP50', 'ap_per_class', 'mean_flops',
    'mean_flops_rate', 'flops_img_*', ...[, 'segm_mAP']}. A DETR-family
    mask is the query's whole-image logit grid, pasted over the image."""
    from laudnet_tpu_torch.detection.detr import detr_detect
    from laudnet_tpu_torch.detection.retinanet import RetinaNet, gather_rows

    device = next(model.parameters()).device
    detections, gts = [], []
    n = 0
    flops = dense = 0.0
    flops_img_all = []
    for batch in batches:
        images, boxes, labels, valid = batch[:4]
        gt_masks = batch[4] if len(batch) > 4 else None
        x = torch.as_tensor(np.asarray(images)).to(device)
        out = model(x, training=False)
        img_h, img_w = images.shape[1], images.shape[2]
        if kind == "faster_rcnn":
            det_t = type(model).detect(out, score_threshold=score_threshold)
        elif kind == "detr":
            det_t = detr_detect(out, (float(img_h), float(img_w)),
                                score_threshold=score_threshold)
        else:
            det_t = RetinaNet.detect(out, (img_h, img_w),
                                     score_threshold=score_threshold)
        probs = whole_image = None
        if "mask_logits" in out and gt_masks is not None:
            if kind == "detr":  # (B, D, h, w) over the whole image
                ml = gather_rows(out["mask_logits"],
                                 det_t["indices"]).cpu().numpy()
                probs = 1.0 / (1.0 + np.exp(-ml))
                whole_image = np.array([0, 0, img_w, img_h])
            else:
                probs = _mask_probs(out["mask_logits"], det_t["indices"],
                                    det_t["classes"])
        det = {k: v.cpu().numpy() for k, v in det_t.items()}
        add = {k: v.cpu().numpy() for k, v in out["additional"].items()}
        bsz = images.shape[0]
        n += bsz
        flops += float(add["flops"]) * bsz
        dense += float(add["dense_flops"]) * bsz
        flops_img_all.append(np.asarray(add["flops_img"], np.float64))
        for i in range(bsz):
            d = {k: np.asarray(det[k][i])
                 for k in ("boxes", "scores", "classes")}
            if probs is not None:
                d["masks"] = [
                    paste_mask(probs[i, j], d["boxes"][j]
                               if whole_image is None else whole_image,
                               img_h, img_w)
                    if d["scores"][j] > 0 else np.zeros((img_h, img_w), bool)
                    for j in range(len(d["scores"]))]
            detections.append(d)
            keep = np.asarray(valid[i]) > 0
            g = dict(boxes=np.asarray(boxes[i])[keep],
                     labels=np.asarray(labels[i])[keep])
            if gt_masks is not None:
                g["masks"] = np.asarray(gt_masks[i])[keep]
            gts.append(g)
    res = mean_average_precision(detections, gts, num_classes, iou_threshold,
                                 iou_thresholds=iou_thresholds)
    if detections and "masks" in detections[0]:
        segm = mean_average_precision(detections, gts, num_classes,
                                      iou_threshold, use_masks=True,
                                      iou_thresholds=iou_thresholds)
        res = dict(res, segm_mAP=segm["mAP"],
                   segm_mAP50=segm.get("mAP50", segm["mAP"]),
                   segm_ap_per_class=segm["ap_per_class"])
    res.update(n_images=n, mean_flops=flops / max(n, 1),
               mean_dense_flops=dense / max(n, 1),
               mean_flops_rate=(flops / dense) if dense else 1.0)
    if flops_img_all:
        fi = np.concatenate(flops_img_all)
        res.update(flops_img_mean=float(fi.mean()),
                   flops_img_std=float(fi.std()),
                   flops_img_min=float(fi.min()),
                   flops_img_max=float(fi.max()))
    return res
