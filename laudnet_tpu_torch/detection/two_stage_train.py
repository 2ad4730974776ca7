"""Two-stage (Faster/Mask R-CNN) training losses on the LAUD backbone
(counterpart of `laudnet_tpu/detection/two_stage_train.py`).

RPN objectness and box losses, RoI classification and box losses, the
optional mask loss, and the LAUD ``loss_sparse``, batched over the images.
As in the JAX package, every anchor and proposal contributes through 0/1
weights normalised by the positive count (mmdet samples 256 anchors and
512 proposals instead: the same expectation, without the sampling
variance), and the model writes the ground truth into the proposal set.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.detection.losses import loss_sparse, smooth_l1
from laudnet_tpu_torch.detection.retinanet import gather_rows
from laudnet_tpu_torch.detection.two_stage import div_exact
from laudnet_tpu_torch.detection.train import (box_iou, encode_boxes,
                                               force_best_anchors)


def rpn_assign(anchors, gt_boxes, gt_valid, pos_iou=0.7, neg_iou=0.3):
    """Class-agnostic RPN assignment of anchors (A, 4) to (B, M, 4): pos
    at IoU >= 0.7 or the best anchor of a valid GT, neg below 0.3, ignored
    in between. Returns ``(best_gt, pos, neg)``, each (B, A)."""
    iou = box_iou(anchors, gt_boxes)  # (B, A, M)
    iou = torch.where(gt_valid[:, None, :] > 0, iou,
                      torch.full_like(iou, -1.0))
    best_gt = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    forced, _ = force_best_anchors(iou, gt_valid)
    pos = (best_iou >= pos_iou) | forced
    neg = (best_iou < neg_iou) & ~pos
    return best_gt, pos, neg


def rpn_loss(obj_logits, box_deltas, anchors, gt_boxes, gt_valid):
    """BCE objectness over the positive and negative anchors, smooth-L1
    box regression over the positives; each per image, averaged over the
    batch. Returns ``(cls, box)``."""
    best_gt, pos, neg = rpn_assign(anchors, gt_boxes, gt_valid)
    posf = pos.float()
    ok = (pos | neg).float()
    n_pos = torch.clamp_min(posf.sum(dim=1), 1.0)
    n_ok = torch.clamp_min(ok.sum(dim=1), 1.0)
    bce = -(posf * F.logsigmoid(obj_logits)
            + (1.0 - posf) * F.logsigmoid(-obj_logits))
    cls_loss = (bce * ok).sum(dim=1) / n_ok
    targets = encode_boxes(anchors, gather_rows(gt_boxes, best_gt))
    box_loss = (smooth_l1(box_deltas, targets).sum(-1) * posf).sum(dim=1) \
        / n_pos
    return cls_loss.mean(), box_loss.mean()


def roi_assign(proposals, prop_valid, gt_boxes, gt_labels, gt_valid,
               num_classes, pos_iou=0.5):
    """Each proposal (B, P, 4) to a GT (pos at IoU >= 0.5) or background
    (label ``num_classes``). Returns ``(best_gt, labels, box_targets,
    pos, ok)``."""
    iou = box_iou(proposals, gt_boxes)
    iou = torch.where(gt_valid[:, None, :] > 0, iou,
                      torch.full_like(iou, -1.0))
    best_gt = iou.argmax(dim=2)
    best_iou = iou.amax(dim=2)
    pos = (best_iou >= pos_iou) & (prop_valid > 0)
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, best_gt),
                         torch.full_like(best_gt, num_classes))
    box_targets = encode_boxes(proposals, gather_rows(gt_boxes, best_gt))
    return best_gt, labels, box_targets, pos.float(), \
        (prop_valid > 0).float()


def crop_gt_mask(gt_masks, boxes, out_size: int, index=None):
    """Bilinear crops of full-image binary GT masks to boxes, at
    ``out_size`` x ``out_size`` (the mask head's targets). Without
    ``index``: ``gt_masks`` (..., H, W) and ``boxes`` (..., 4) with the same
    leading dimensions (one (H, W) mask and one box, as the JAX function
    takes them). With ``index`` (B, P): ``gt_masks`` (B, M, H, W), and box
    ``[b, p]`` crops mask ``[b, index[b, p]]``, which is not copied out
    whole."""
    h, w = gt_masks.shape[-2:]
    lead = boxes.shape[:-1]
    g = gt_masks.reshape(-1, h, w)
    boxes = boxes.reshape(-1, 4)
    if index is None:
        rows = torch.arange(g.shape[0], device=g.device)
    else:
        m = gt_masks.shape[1]
        rows = (torch.arange(index.shape[0], device=g.device)[:, None] * m
                + index).reshape(-1)
    bw = torch.clamp_min(boxes[:, 2] - boxes[:, 0], 1e-6)
    bh = torch.clamp_min(boxes[:, 3] - boxes[:, 1], 1e-6)
    grid = div_exact(torch.arange(out_size, dtype=torch.float32,
                                  device=boxes.device) + 0.5, out_size)
    ys = boxes[:, 1, None] + grid * bh[:, None]
    xs = boxes[:, 0, None] + grid * bw[:, None]
    y0 = (ys - 0.5).floor().clamp(0, h - 1)
    x0 = (xs - 0.5).floor().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - 0.5 - y0).clamp(0, 1)[:, :, None]
    wx = (xs - 0.5 - x0).clamp(0, 1)[:, None, :]
    n = rows[:, None, None]

    def at(yi, xi):
        return g[n, yi.long()[:, :, None], xi.long()[:, None, :]].float()

    out = ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x1)
           + wy * (1 - wx) * at(y1, x0) + wy * wx * at(y1, x1))
    return out.reshape(lead + (out_size, out_size))


def faster_rcnn_loss(outputs: Dict, gt_boxes, gt_labels, gt_valid, *,
                     num_classes: int, gt_masks=None,
                     sparsity_target: float = 0.5,
                     lambda_sparse: float = 1.0):
    """The Faster R-CNN (+ mask) training loss over padded ground truth.

    ``outputs``: `FasterRCNN.forward` in training mode with the ground
    truth written into the proposals. ``gt_masks`` (B, M, H, W) 0/1 adds
    the Mask R-CNN term. Returns ``(total, metrics)``, the metrics with
    ``flops_rate``."""
    rpn_cls, rpn_box = rpn_loss(outputs["rpn_obj"], outputs["rpn_reg"],
                                outputs["anchors"], gt_boxes, gt_valid)
    best_gt, lab, box_t, pos, ok = roi_assign(
        outputs["proposals"], outputs["proposal_valid"], gt_boxes, gt_labels,
        gt_valid, num_classes)
    n_pos = torch.clamp_min(pos.sum(dim=1), 1.0)
    n_ok = torch.clamp_min(ok.sum(dim=1), 1.0)
    logp = torch.log_softmax(outputs["cls_logits"], dim=-1)
    ce = -torch.gather(logp, 2, lab[..., None])[..., 0]
    roi_cls = ((ce * ok).sum(dim=1) / n_ok).mean()
    roi_box = ((smooth_l1(outputs["box_deltas"], box_t).sum(-1) * pos)
               .sum(dim=1) / n_pos).mean()
    metrics = {"loss_rpn_cls": rpn_cls, "loss_rpn_box": rpn_box,
               "loss_cls": roi_cls, "loss_box": roi_box}
    total = rpn_cls + rpn_box + roi_cls + roi_box

    if gt_masks is not None and "mask_logits" in outputs:
        mask_logits = outputs["mask_logits"]  # (B, P, S, S, K)
        out_size = mask_logits.shape[2]
        target = crop_gt_mask(gt_masks, outputs["proposals"], out_size,
                              index=best_gt)
        cls_i = torch.gather(gt_labels.long(), 1, best_gt)  # (B, P)
        idx = cls_i[:, :, None, None, None].expand(
            mask_logits.shape[:4] + (1,))
        lg = torch.gather(mask_logits, 4, idx)[..., 0]
        bce = -(target * F.logsigmoid(lg)
                + (1 - target) * F.logsigmoid(-lg))
        per = bce.mean(dim=(2, 3)) * pos
        mloss = (per.sum(dim=1) / torch.clamp_min(pos.sum(dim=1), 1.0)).mean()
        metrics["loss_mask"] = mloss
        total = total + mloss

    l_sparse, rate = loss_sparse(outputs["additional"], sparsity_target)
    metrics["loss_sparse"] = l_sparse
    metrics["flops_rate"] = rate
    return total + lambda_sparse * l_sparse, metrics
