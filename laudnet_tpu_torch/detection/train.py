"""RetinaNet training: anchor matching, focal + box losses, loss_sparse
(counterpart of `laudnet_tpu/detection/train.py`).

The total loss is ``focal + box + loss_sparse``. Anchor assignment is the
max-IoU rule (positive >= 0.5, negative < 0.4, ignored in between) over
fixed-size padded ground truth, batched over the images.
"""

from __future__ import annotations

from typing import Dict

import torch

from laudnet_tpu_torch.detection.losses import (focal_loss, loss_sparse,
                                                smooth_l1)
from laudnet_tpu_torch.detection.retinanet import (RETINANET_STRIDES,
                                                   anchors_for, gather_rows)


def box_iou(a, b):
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU; leading dimensions
    broadcast."""
    area_a = (torch.clamp_min(a[..., 2] - a[..., 0], 0)
              * torch.clamp_min(a[..., 3] - a[..., 1], 0))
    area_b = (torch.clamp_min(b[..., 2] - b[..., 0], 0)
              * torch.clamp_min(b[..., 3] - b[..., 1], 0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp_min(area_a[..., :, None] + area_b[..., None, :]
                                   - inter, 1e-9)


def encode_boxes(anchors, boxes):
    """Inverse of `decode_boxes`: boxes -> (dx, dy, dw, dh) targets.
    Widths and heights are clamped away from zero: the "anchors" may be
    padded, zero-area proposals, whose inf/nan targets would poison the
    loss even where masked."""
    aw = torch.clamp_min(anchors[..., 2] - anchors[..., 0], 1e-6)
    ah = torch.clamp_min(anchors[..., 3] - anchors[..., 1], 1e-6)
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    gw = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 1e-6)
    gh = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 1e-6)
    gx = boxes[..., 0] + gw / 2
    gy = boxes[..., 1] + gh / 2
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                        torch.log(gh / ah)], dim=-1)


def force_best_anchors(iou, gt_valid):
    """mmdet MaxIoUAssigner's low-quality matches over a (B, A, M) IoU:
    ``forced`` (B, A) marks every valid GT's best anchor, and ``forced_gt``
    (B, A) names the GT that forced it (-1 where none did). Two GTs that
    force one anchor resolve to the later GT, as a sequential overwrite
    (XLA's scatter on the CPU) does; padded GT rows force nothing."""
    b, a, m = iou.shape
    best_anchor = iou.argmax(dim=1)  # (B, M)
    ok = gt_valid > 0
    forced = torch.zeros((b, a), dtype=torch.float32, device=iou.device)
    forced.scatter_reduce_(1, best_anchor, ok.float(), "amax")
    safe = torch.where(ok, best_anchor, torch.full_like(best_anchor, a))
    forced_gt = torch.full((b, a + 1), -1, dtype=torch.long,
                           device=iou.device)
    m_idx = torch.arange(m, device=iou.device).expand(b, m)
    forced_gt.scatter_reduce_(1, safe, m_idx, "amax")
    return forced > 0, forced_gt[:, :a]


def assign_targets(anchors, gt_boxes, gt_labels, gt_valid, num_classes,
                   pos_iou=0.5, neg_iou=0.4):
    """Max-IoU assignment of anchors (A, 4) to padded GT (B, M, ...).
    Returns ``(cls_onehot (B, A, K), box_targets (B, A, 4), pos (B, A),
    valid (B, A))``. Every valid GT's best anchor is a forced positive
    assigned to that GT, so small or extreme-aspect boxes below
    ``pos_iou`` still train."""
    iou = box_iou(anchors, gt_boxes)  # (B, A, M)
    iou = torch.where(gt_valid[:, None, :] > 0, iou,
                      torch.full_like(iou, -1.0))
    best_gt = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    forced, forced_gt = force_best_anchors(iou, gt_valid)
    pos = (best_iou >= pos_iou) | forced
    neg = (best_iou < neg_iou) & ~pos
    valid = pos | neg  # the ignore band contributes nothing
    best_gt = torch.where(forced_gt >= 0, forced_gt, best_gt)
    labels = torch.gather(gt_labels.long(), 1, best_gt)
    # a compare, not F.one_hot, whose range check syncs with the card
    classes = torch.arange(num_classes, device=labels.device)
    cls_onehot = ((labels[..., None] == classes).float()
                  * pos[..., None].float())
    box_targets = encode_boxes(anchors, gather_rows(gt_boxes, best_gt))
    return cls_onehot, box_targets, pos.float(), valid.float()


def retinanet_loss(outputs: Dict, gt_boxes, gt_labels, gt_valid, *,
                   num_classes: int, sparsity_target: float = 0.5,
                   lambda_sparse: float = 1.0, box_weight: float = 1.0):
    """The RetinaNet training loss over padded ground truth: ``gt_boxes``
    (B, M, 4), ``gt_labels`` (B, M), ``gt_valid`` (B, M) 0/1. Per image
    the focal and box sums are divided by the positive count, then
    averaged over the batch. Returns ``(total, metrics)``, the metrics
    with ``flops_rate`` as the reference logs it."""
    cls_logits = outputs["cls_logits"]
    anchors = anchors_for(outputs["level_shapes"], RETINANET_STRIDES,
                          cls_logits.device)
    cls_t, box_t, pos, ok = assign_targets(anchors, gt_boxes, gt_labels,
                                           gt_valid, num_classes)
    n_pos = torch.clamp_min(pos.sum(dim=1), 1.0)
    fl = focal_loss(cls_logits, cls_t) * ok[..., None]
    cls_loss = (fl.sum(dim=(1, 2)) / n_pos).mean()
    bl = smooth_l1(outputs["box_deltas"], box_t).sum(-1) * pos
    box_loss = (bl.sum(dim=1) / n_pos).mean()
    l_sparse, rate = loss_sparse(outputs["additional"], sparsity_target)
    total = cls_loss + box_weight * box_loss + lambda_sparse * l_sparse
    return total, {"loss_cls": cls_loss, "loss_box": box_loss,
                   "loss_sparse": l_sparse, "flops_rate": rate}
