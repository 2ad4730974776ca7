"""RetinaNet on a LAUD backbone: head, anchors, decode, NMS (counterpart of
`laudnet_tpu/detection/retinanet.py`).

A shared 4-conv class and box tower over FPN P3-P7, A = 9 anchors per
location, focal-loss logits, and fixed-capacity top-k + NMS decoding with
static shapes. The detector returns the backbone's ``additional`` stats so
that ``loss_sparse`` joins the training loss as the reference injects it.

Decoding is the JAX package's formula for formula, with three choices
that make a card and the CPU decode alike to the bit:

* every ``lax.top_k`` and ``argsort`` is a stable descending sort (ties
  go to the lower index, as XLA's top-k and a stable argsort order them);
* the transcendental functions of the decode (``sigmoid``, ``softmax``,
  ``exp``) are computed in f64 and rounded to f32, so both devices get the
  correctly rounded f32 value; the f32 arithmetic around them is one IEEE
  operation per PyTorch call, which no device contracts;
* NMS precomputes the f32 IoU matrix once and runs the greedy loop over
  the boxes in order on the device, batched over the images, with no host
  synchronisation inside the loop.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from laudnet_tpu_torch.detection.backbone import LAUDDetBackbone
from laudnet_tpu_torch.detection.fpn import FPN, Conv
from laudnet_tpu_torch.device import full_f32_convolutions, resolve_device

RETINANET_STRIDES = (8, 16, 32, 64, 128)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """The sigmoid of ``x`` computed in f64 and rounded to f32."""
    return torch.sigmoid(x.double()).float()


def topk_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, ties by the lower index. Returns (values,
    indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[b, index[b]]`` for ``x`` (B, N, ...) and ``index`` (B, K)."""
    idx = index.reshape(index.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(index.shape + x.shape[2:]))


def make_anchors(level_shapes: Sequence[Tuple[int, int]],
                 strides: Sequence[int],
                 scales=(2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3)),
                 ratios=(0.5, 1.0, 2.0), base_size_factor: float = 4.0,
                 device=None) -> torch.Tensor:
    """Anchors of every FPN level -> (sum HW * A, 4) f32 ``[x1, y1, x2,
    y2]``, location-major, ratio then scale within a location."""
    device = resolve_device(device)
    all_anchors = []
    for (h, w), stride in zip(level_shapes, strides):
        base = stride * base_size_factor
        ws, hs = [], []
        for r in ratios:
            for s in scales:
                ws.append(base * s * (1.0 / r) ** 0.5)
                hs.append(base * s * r ** 0.5)
        ws = torch.tensor(ws, dtype=torch.float32).to(device)
        hs = torch.tensor(hs, dtype=torch.float32).to(device)
        cx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) \
            * stride
        cy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) \
            * stride
        cy, cx = torch.meshgrid(cy, cx, indexing="ij")
        cx = cx.reshape(-1, 1)
        cy = cy.reshape(-1, 1)
        boxes = torch.stack([cx - ws / 2, cy - hs / 2, cx + ws / 2,
                             cy + hs / 2], dim=-1)  # (HW, A, 4)
        all_anchors.append(boxes.reshape(-1, 4))
    return torch.cat(all_anchors, dim=0)


@functools.lru_cache(maxsize=32)
def _cached_anchors(level_shapes, strides, scales, ratios, base_size_factor,
                    device):
    return make_anchors(level_shapes, strides, scales, ratios,
                        base_size_factor, device=device)


def anchors_for(level_shapes, strides, device,
                scales=(2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3)),
                ratios=(0.5, 1.0, 2.0),
                base_size_factor: float = 4.0) -> torch.Tensor:
    """`make_anchors`, built once per geometry and device (the build copies
    the per-ratio sizes to the card; a forward that reuses them copies
    nothing). The tensor is shared: never modify it in place."""
    return _cached_anchors(tuple(tuple(s) for s in level_shapes),
                           tuple(strides), tuple(scales), tuple(ratios),
                           base_size_factor, torch.device(device))


def decode_boxes(anchors, deltas):
    """Standard (dx, dy, dw, dh) decoding; ``anchors`` (..., N, 4)
    broadcasts against ``deltas``."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw.clamp(-10, 4).double()).float()
    h = ah * torch.exp(dh.clamp(-10, 4).double()).float()
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def clip_boxes_to_image(boxes, img_h, img_w):
    """Clip xyxy boxes per axis: x coordinates to [0, W], y to [0, H]."""
    return torch.stack([boxes[..., 0].clamp(0, img_w),
                        boxes[..., 1].clamp(0, img_h),
                        boxes[..., 2].clamp(0, img_w),
                        boxes[..., 3].clamp(0, img_h)], dim=-1)


def nms(boxes, scores, iou_threshold: float = 0.5, max_out: int = 100):
    """Static-shape greedy NMS. ``boxes`` (N, 4) or (B, N, 4), ``scores``
    (N,) or (B, N). Returns ``(keep_idx, keep_valid)`` of ``min(max_out,
    N)`` entries per image: the boxes that survive first, by score, then
    the suppressed ones.

    The JAX loop's semantics: boxes in stable descending score order,
    ``alive`` starts at ``score > 0``, box i (if alive) kills every other
    box whose f32 IoU ``inter / max(area_i + area_j - inter, 1e-9)``
    exceeds the threshold. Two launches a box, no host sync."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    n = scores.shape[1]
    sorted_scores, order = torch.sort(scores, dim=1, descending=True,
                                      stable=True)
    boxes = gather_rows(boxes, order)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0))
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    iou = inter / torch.clamp_min(area[:, :, None] + area[:, None, :] - inter,
                                  1e-9)
    # spares[b, i, j]: box i, if alive, lets box j live (itself included)
    spares = ~(iou > iou_threshold)
    spares.diagonal(dim1=1, dim2=2).fill_(True)
    alive = sorted_scores > 0
    for i in range(n):
        alive = torch.where(alive[:, i:i + 1], alive & spares[:, i], alive)
    kept = torch.where(alive, sorted_scores,
                       torch.full_like(sorted_scores, -math.inf))
    top = torch.sort(kept, dim=1, descending=True,
                     stable=True).indices[:, :max_out]
    keep, valid = torch.gather(order, 1, top), torch.gather(alive, 1, top)
    return (keep[0], valid[0]) if single else (keep, valid)


class RetinaNetHead(nn.Module):
    """Shared class and box towers over the pyramid; the predictors take
    no compute dtype, so under mixed precision the logits and deltas leave
    the head in f32. Returns ``(cls (B, sum HWA, K), box (B, sum HWA,
    4))``."""

    def __init__(self, num_classes: int = 80, num_anchors: int = 9,
                 num_convs: int = 4, channels: int = 256, device=None,
                 dtype=None, compute_dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_classes, self.num_anchors = num_classes, num_anchors
        self.num_convs = num_convs
        for tower in ("cls", "box"):
            for i in range(num_convs):
                self.add_module(f"{tower}_conv_{i}",
                                Conv(channels, channels, 3, padding=1,
                                     compute_dtype=compute_dtype, **kw))
        self.cls_pred = Conv(channels, num_anchors * num_classes, 3,
                             padding=1, **kw)
        self.box_pred = Conv(channels, num_anchors * 4, 3, padding=1, **kw)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.init_weights(generator)
        # focal-loss prior: start at ~1 % positive probability
        nn.init.constant_(self.cls_pred.bias, -math.log((1 - 0.01) / 0.01))

    def forward(self, features):
        cls_outs, box_outs = [], []
        for f in features:
            c = b = f
            for i in range(self.num_convs):
                c = torch.relu(getattr(self, f"cls_conv_{i}")(c))
                b = torch.relu(getattr(self, f"box_conv_{i}")(b))
            n, h, w, _ = f.shape
            cls_outs.append(self.cls_pred(c).reshape(
                n, h * w * self.num_anchors, self.num_classes))
            box_outs.append(self.box_pred(b).reshape(
                n, h * w * self.num_anchors, 4))
        return torch.cat(cls_outs, dim=1), torch.cat(box_outs, dim=1)


class RetinaNet(nn.Module):
    """LAUD-backboned RetinaNet. ``forward`` returns the raw predictions
    with the backbone's sparsity stats; `detect` decodes them.
    ``compute_dtype`` (bf16) runs the backbone, FPN and towers in it over
    f32 parameters; the gating heads and the predictors stay f32."""

    def __init__(self, num_classes: int = 80,
                 backbone_layers: Sequence[int] = (3, 4, 23, 3),
                 dyn_mode: Sequence[str] = ("channel",) * 4,
                 sparsity_target: float = 0.5, temperature: float = 0.1,
                 device=None, dtype=None, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  compute_dtype=compute_dtype)
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.backbone = LAUDDetBackbone(
            layers=backbone_layers, out_indices=(1, 2, 3),  # C3-C5
            dyn_mode=dyn_mode, temperature=temperature,
            sparsity_target=sparsity_target, **kw)
        self.neck = FPN(self.backbone.out_channels, **kw)
        self.bbox_head = RetinaNetHead(num_classes=num_classes, **kw)
        if generator is not None:
            self.init_weights(generator)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """The backbone as `models/laud_resnet.py` initialises it; the
        neck and head with flax's defaults and the focal prior."""
        self.backbone.init_weights(generator)
        for m in self.neck.modules():
            if isinstance(m, Conv):
                m.init_weights(generator)
        self.bbox_head.init_weights(generator)

    def forward(self, images, *, training: bool = False, noise=None):
        """``images``: (B, H, W, 3) f32. Returns a dict: ``cls_logits``,
        ``box_deltas``, ``level_shapes``, ``additional``,
        ``model_configs``."""
        if self.compute_dtype is None:
            with full_f32_convolutions():
                return self._forward(images, training, noise)
        return self._forward(images, training, noise)

    def _forward(self, images, training, noise):
        feats, additional, model_configs = self.backbone(
            images, training=training, noise=noise)
        pyramid = self.neck(feats)
        cls_logits, box_deltas = self.bbox_head(pyramid)
        return {
            "cls_logits": cls_logits,
            "box_deltas": box_deltas,
            "level_shapes": [(p.shape[1], p.shape[2]) for p in pyramid],
            "additional": additional,
            "model_configs": model_configs,
        }

    @staticmethod
    def detect(outputs, image_size, score_threshold=0.05, iou_threshold=0.5,
               max_detections=100, pre_nms_topk=1000):
        """Decode + per-image NMS (class-agnostic, scored by each anchor's
        best class). Returns a dict of (B, max_detections) ``boxes``,
        ``scores``, ``classes`` and ``valid``."""
        logits = outputs["cls_logits"]
        anchors = anchors_for(outputs["level_shapes"], RETINANET_STRIDES,
                              logits.device)
        probs = sigmoid_f32(logits)  # (B, N, C)
        pre_nms_topk = min(pre_nms_topk, probs.shape[1])
        img_h, img_w = ((image_size, image_size)
                        if isinstance(image_size, (int, float))
                        else tuple(image_size))
        best_c = probs.argmax(dim=-1)
        best_s = probs.amax(dim=-1)
        top_s, top_i = topk_stable(best_s, pre_nms_topk)
        deltas = gather_rows(outputs["box_deltas"], top_i)
        boxes = clip_boxes_to_image(decode_boxes(anchors[top_i], deltas),
                                    img_h, img_w)
        valid_s = torch.where(top_s > score_threshold, top_s,
                              torch.zeros_like(top_s))
        keep, alive = nms(boxes, valid_s, iou_threshold, max_detections)
        return {
            "boxes": gather_rows(boxes, keep),
            "scores": torch.gather(valid_s, 1, keep) * alive,
            "classes": torch.gather(torch.gather(best_c, 1, top_i), 1, keep),
            "valid": alive,
        }
