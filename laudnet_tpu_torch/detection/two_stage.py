"""Two-stage detectors on a LAUD backbone: Faster R-CNN and Mask R-CNN
(counterpart of `laudnet_tpu/detection/two_stage.py`).

The RPN proposes a fixed number of boxes (top-k + NMS with padding),
RoIAlign samples fixed 7 x 7 (14 x 14 for masks) grids from the FPN level
each box is assigned to, and the box and mask heads run on the padded
proposal set. ``loss_sparse`` uses the backbone's ``additional`` stats as
the reference's patched detectors do.

`roi_align` computes what the JAX function computes (every level sampled,
the assigned one selected) by sampling each box on its own level only:
the pyramid is flattened into one (B, sum HW, C) table and each box's
stride, level size and offset are looked up, so the arithmetic per sample
is the JAX package's, at a quarter of the gathers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laudnet_tpu_torch.detection.backbone import LAUDDetBackbone
from laudnet_tpu_torch.detection.fpn import FPN, Conv, lecun_normal_
from laudnet_tpu_torch.detection.retinanet import (anchors_for,
                                                   clip_boxes_to_image,
                                                   decode_boxes, gather_rows,
                                                   nms, sigmoid_f32,
                                                   topk_stable)
from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device

TWO_STAGE_STRIDES = (4, 8, 16, 32, 64)


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device: PyTorch divides a CUDA
    tensor by a Python number as a product with its reciprocal (one more
    rounding); a tensor divisor takes the true division there as on the
    CPU."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _per_level(level: torch.Tensor, values) -> torch.Tensor:
    """``values[level]`` for a tensor of level indices, without copying
    the table to the device."""
    out = torch.full(level.shape, values[-1], dtype=torch.float32,
                     device=level.device)
    for k in range(len(values) - 1):
        out = torch.where(level == k, values[k], out)
    return out


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              strides: Sequence[int], out_size: int = 7) -> torch.Tensor:
    """RoIAlign over an FPN pyramid: one bilinear sample per bin centre.

    ``features``: per level (B, H_l, W_l, C); ``boxes``: (B, N, 4) xyxy in
    image coordinates (or, as the JAX function takes them, one image's
    (H_l, W_l, C) levels and (N, 4) boxes). A box samples the level
    ``floor(4 + log2(sqrt(wh) / 224 + 1e-9))`` clipped to the pyramid (P2
    is level 2). Returns (B, N, out_size, out_size, C) in f32 (the bf16
    features of a mixed-precision model are promoted, as JAX promotes
    them against the f32 weights)."""
    single = boxes.dim() == 2
    if single:
        features, boxes = [f[None] for f in features], boxes[None]
    b, n = boxes.shape[:2]
    dev = boxes.device
    w = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 1e-6)
    h = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 1e-6)
    scale = div_exact(torch.sqrt(w * h), 224.0) + 1e-9
    level = (4 + torch.log2(scale.double()).float()).floor().clamp(
        2, 2 + len(features) - 1).long() - 2  # (B, N), 0 = P2

    heights = [f.shape[1] for f in features]
    widths = [f.shape[2] for f in features]
    offsets = [0]
    for hh, ww in zip(heights, widths):
        offsets.append(offsets[-1] + hh * ww)
    table = torch.cat([f.reshape(b, -1, f.shape[-1]) for f in features], 1)
    stride = _per_level(level, [float(s) for s in strides])[..., None]
    fh1 = _per_level(level, [float(hh - 1) for hh in heights])[..., None]
    fw1 = _per_level(level, [float(ww - 1) for ww in widths])[..., None]
    row = _per_level(level, [float(ww) for ww in widths]).long()
    base = _per_level(level, [float(o) for o in offsets[:-1]]).long()

    # bin-centre sampling grid in image coordinates
    grid = div_exact(torch.arange(out_size, dtype=torch.float32, device=dev)
                     + 0.5, out_size)
    ys = boxes[..., 1, None] + grid * h[..., None]  # (B, N, S)
    xs = boxes[..., 0, None] + grid * w[..., None]
    y = ys / stride - 0.5
    x = xs / stride - 0.5
    y0 = torch.minimum(torch.clamp_min(torch.floor(y), 0), fh1)
    x0 = torch.minimum(torch.clamp_min(torch.floor(x), 0), fw1)
    y1 = torch.minimum(torch.clamp_min(y0 + 1, 0), fh1)
    x1 = torch.minimum(torch.clamp_min(x0 + 1, 0), fw1)
    wy = (y - y0).clamp(0, 1)[..., :, None, None]
    wx = (x - x0).clamp(0, 1)[..., None, :, None]
    rowv, basev = row[..., None, None], base[..., None, None]
    bidx = torch.arange(b, device=dev)[:, None, None, None]

    def gather(yi, xi):  # (B, N, S, S, C)
        idx = (basev + yi.long()[..., :, None] * rowv
               + xi.long()[..., None, :])
        return table[bidx, idx].float()

    out = ((1 - wy) * (1 - wx) * gather(y0, x0)
           + (1 - wy) * wx * gather(y0, x1)
           + wy * (1 - wx) * gather(y1, x0)
           + wy * wx * gather(y1, x1))
    return out[0] if single else out


class Dense(nn.Linear):
    """flax ``nn.Dense``: with ``compute_dtype`` the input, kernel and bias
    are cast to it and the bias added after the product is rounded;
    without it they are promoted to a common type."""

    def __init__(self, cin: int, cout: int, compute_dtype=None, device=None,
                 dtype=None):
        super().__init__(cin, cout, device=resolve_device(device),
                         dtype=dtype)
        self.compute_dtype = compute_dtype

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        cd = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.linear(x.to(cd), self.weight.to(cd)) + self.bias.to(cd)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` with a k x k kernel at stride k on NHWC
    tensors. flax does not flip its kernel: its output pixel ``k*i + a``
    takes kernel tap ``k - 1 - a``; the converter
    (`convert/from_jax.py`) flips the taps into PyTorch's layout, where
    it takes tap ``a``."""

    def __init__(self, cin: int, cout: int, kernel: int,
                 compute_dtype=None, device=None, dtype=None):
        super().__init__(cin, cout, kernel, kernel,
                         device=resolve_device(device), dtype=dtype)
        self.compute_dtype = compute_dtype

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.weight, self.weight[:, 0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        cd = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        y = F.conv_transpose2d(x.to(cd).permute(0, 3, 1, 2),
                               self.weight.to(cd), None, self.stride)
        return y.permute(0, 2, 3, 1) + self.bias.to(cd)


class RPNHead(nn.Module):
    """A shared 3x3 conv, then objectness and box regression per anchor;
    ``obj`` and ``reg`` take no compute dtype (f32 out)."""

    def __init__(self, num_anchors: int = 3, channels: int = 256,
                 device=None, dtype=None, compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_anchors = num_anchors
        self.conv = Conv(channels, channels, 3, padding=1,
                         compute_dtype=compute_dtype, **kw)
        self.obj = Conv(channels, num_anchors, 1, **kw)
        self.reg = Conv(channels, num_anchors * 4, 1, **kw)

    def forward(self, pyramid):
        objs, regs = [], []
        for f in pyramid:
            h = torch.relu(self.conv(f))
            n, hh, ww, _ = f.shape
            objs.append(self.obj(h).reshape(n, hh * ww * self.num_anchors))
            regs.append(self.reg(h).reshape(n, hh * ww * self.num_anchors,
                                            4))
        return torch.cat(objs, 1), torch.cat(regs, 1)


class BoxHead(nn.Module):
    """Two hidden Dense layers over flattened NHWC RoIs (flax's (H, W, C)
    order), then K + 1 class logits and 4 deltas in f32."""

    def __init__(self, in_features: int, num_classes: int = 80,
                 hidden: int = 1024, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = Dense(in_features, hidden, compute_dtype, **kw)
        self.fc2 = Dense(hidden, hidden, compute_dtype, **kw)
        self.cls = Dense(hidden, num_classes + 1, **kw)
        self.reg = Dense(hidden, 4, **kw)

    def forward(self, rois):  # (N, 7, 7, C)
        x = rois.reshape(rois.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.cls(x), self.reg(x)


class MaskHead(nn.Module):
    """Four 3x3 convs, a 2x transposed conv, and per-class mask logits in
    f32: (N, 14, 14, C) -> (N, 28, 28, K)."""

    def __init__(self, num_classes: int = 80, channels: int = 256,
                 device=None, dtype=None, compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        for i in range(4):
            self.add_module(f"conv_{i}", Conv(channels, channels, 3,
                                              padding=1,
                                              compute_dtype=compute_dtype,
                                              **kw))
        self.deconv = ConvTranspose(channels, channels, 2, compute_dtype,
                                    **kw)
        self.pred = Conv(channels, num_classes, 1, **kw)

    def forward(self, rois):
        x = rois
        for i in range(4):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        return self.pred(torch.relu(self.deconv(x)))


class FasterRCNN(nn.Module):
    """Faster R-CNN (``with_masks=True``: Mask R-CNN) on a LAUD backbone.
    ``compute_dtype`` (bf16) runs the backbone, FPN and head towers in it;
    the gating heads and every final predictor (objectness, regression,
    class and mask logits) exit in f32, so the proposal decode, matching
    and losses run in f32."""

    def __init__(self, num_classes: int = 80,
                 backbone_layers: Sequence[int] = (3, 4, 23, 3),
                 dyn_mode: Sequence[str] = ("channel",) * 4,
                 sparsity_target: float = 0.5, temperature: float = 0.1,
                 num_proposals: int = 256, with_masks: bool = False,
                 device=None, dtype=None, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  compute_dtype=compute_dtype)
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.with_masks, self.compute_dtype = with_masks, compute_dtype
        self.backbone = LAUDDetBackbone(
            layers=backbone_layers, out_indices=(0, 1, 2, 3),
            dyn_mode=dyn_mode, temperature=temperature,
            sparsity_target=sparsity_target, **kw)
        self.neck = FPN(self.backbone.out_channels, num_extra_levels=1,
                        **kw)  # P2..P6
        self.rpn_head = RPNHead(**kw)
        self.box_head = BoxHead(7 * 7 * 256, num_classes=num_classes, **kw)
        self.mask_head = (MaskHead(num_classes=num_classes, **kw)
                          if with_masks else None)
        if generator is not None:
            self.init_weights(generator)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """The backbone as `models/laud_resnet.py` initialises it; the
        rest with flax's defaults."""
        self.backbone.init_weights(generator)
        for m in self.modules():
            if isinstance(m, (Conv, Dense, ConvTranspose)):
                m.init_weights(generator)

    def forward(self, images, *, training: bool = False, gt_boxes=None,
                gt_valid=None, noise=None):
        """``gt_boxes``/``gt_valid`` (training only): padded ground truth
        written over the lowest-scored proposal slots, so the RoI head
        sees positives from the first step."""
        if self.compute_dtype is None:
            with full_f32_convolutions():
                return self._forward(images, training, gt_boxes, gt_valid,
                                     noise)
        return self._forward(images, training, gt_boxes, gt_valid, noise)

    def propose(self, obj, reg, anchors, img_h, img_w):
        """Top 1000 anchors by objectness, decoded, clipped, NMS at 0.7:
        ``(proposals (B, P, 4), valid (B, P))``, detached."""
        with torch.no_grad():
            scores = sigmoid_f32(obj)
            top_s, top_i = topk_stable(scores, min(1000, scores.shape[1]))
            boxes = clip_boxes_to_image(
                decode_boxes(anchors[top_i], gather_rows(reg, top_i)),
                img_h, img_w)
            keep, alive = nms(boxes, top_s, 0.7, self.num_proposals)
            return gather_rows(boxes, keep), alive

    def _forward(self, images, training, gt_boxes, gt_valid, noise):
        feats, additional, model_configs = self.backbone(
            images, training=training, noise=noise)
        pyramid = self.neck(feats)
        obj, reg = self.rpn_head(pyramid)
        level_shapes = [(p.shape[1], p.shape[2]) for p in pyramid]
        anchors = anchors_for(level_shapes, TWO_STAGE_STRIDES, obj.device,
                              scales=(8.0,), ratios=(0.5, 1.0, 2.0),
                              base_size_factor=1.0)
        img_h, img_w = images.shape[1], images.shape[2]
        proposals, valid = self.propose(obj, reg, anchors, img_h, img_w)
        if training and gt_boxes is not None and gt_boxes.shape[1] > 0:
            m = gt_boxes.shape[1]
            gv = (gt_valid if gt_valid is not None
                  else torch.ones(gt_boxes.shape[:2], device=gt_boxes.device))
            proposals = torch.cat(
                [proposals[:, :-m], gt_boxes.to(proposals.dtype)], dim=1)
            valid = torch.cat([valid[:, :-m], gv > 0], dim=1)
        cls, reg2, masks = self.roi_heads(pyramid, proposals, img_h, img_w,
                                          training)
        out = {
            "proposals": proposals,
            "proposal_valid": valid,
            "cls_logits": cls,
            "box_deltas": reg2,
            "additional": additional,
            "model_configs": model_configs,
            "image_hw": (img_h, img_w),
            # raw RPN outputs and anchors for the RPN loss
            "rpn_obj": obj,
            "rpn_reg": reg,
            "anchors": anchors,
        }
        if masks is not None:
            out["mask_logits"] = masks
        return out

    def roi_heads(self, pyramid, proposals, img_h, img_w,
                  training=False):
        """The second stage on given proposals (B, P, 4): ``(cls (B, P,
        K + 1), reg (B, P, 4), mask logits (B, P, 28, 28, K) or None)``."""
        b, p = proposals.shape[:2]
        rois = roi_align(pyramid[:4], proposals, TWO_STAGE_STRIDES[:4], 7)
        cls, reg = self.box_head(rois.reshape(b * p, 7, 7, rois.shape[-1]))
        cls, reg = cls.reshape(b, p, -1), reg.reshape(b, p, 4)
        masks = None
        if self.mask_head is not None:
            # training pools the (ground-truth-augmented) proposals the
            # mask loss is matched against; eval re-pools on the refined
            # boxes, so a pasted mask matches its reported box
            mask_boxes = proposals
            if not training:
                mask_boxes = clip_boxes_to_image(
                    decode_boxes(proposals, reg), img_h, img_w)
            mask_rois = roi_align(pyramid[:4], mask_boxes,
                                  TWO_STAGE_STRIDES[:4], 14)
            masks = self.mask_head(mask_rois.reshape(
                b * p, 14, 14, mask_rois.shape[-1]))
            masks = masks.reshape(b, p, masks.shape[1], masks.shape[2], -1)
        return cls, reg, masks

    @staticmethod
    def detect(outputs, score_threshold=0.05, max_detections=100):
        """Final per-image classification of the proposals (softmax over
        K + 1, background dropped), box refinement, NMS at 0.5 on the
        refined boxes, score threshold. Returns (B, max_detections)
        ``boxes``, ``scores``, ``classes`` and ``indices`` (the proposal
        behind each detection)."""
        probs = torch.softmax(outputs["cls_logits"].double(),
                              dim=-1).float()[..., :-1]
        best_c = probs.argmax(dim=-1)
        best_s = probs.amax(dim=-1) * outputs["proposal_valid"]
        img_h, img_w = outputs["image_hw"]
        max_detections = min(max_detections, outputs["proposals"].shape[1])
        refined = clip_boxes_to_image(
            decode_boxes(outputs["proposals"], outputs["box_deltas"]),
            img_h, img_w)
        keep, alive = nms(refined, best_s, 0.5, max_detections)
        kept_s = torch.gather(best_s, 1, keep) * alive
        return {
            "boxes": gather_rows(refined, keep),
            "scores": torch.where(kept_s > score_threshold, kept_s,
                                  torch.zeros_like(kept_s)),
            "classes": torch.gather(best_c, 1, keep),
            "indices": keep,
        }
