"""COCO-format detection data ingestion (counterpart of
`laudnet_tpu/data/coco.py`, formula for formula).

The reference trains its detectors on COCO through mmdet's dataset stack
(`mmdetection-2.21.0/mmdet/datasets/coco.py:1` + the resize/normalize/pad
pipelines it drives). This module is a plain annotation-JSON parser plus a
batcher that emits static-shape padded batches ``(images, boxes, labels,
valid[, masks])`` as numpy arrays.

* **Static shapes.** Every batch is ``(B, H, W, 3)`` images with exactly
  ``max_gt`` box slots per image (``valid`` marks the real ones).
* **Resize-and-pad.** Images are scaled by ``min(H/h, W/w)`` (aspect
  preserved, the mmdet ``keep_ratio`` resize) and placed top-left on the
  padded canvas, matching mmdet's ``Pad(size_divisor)`` convention; boxes
  and masks are scaled with the same factor.
* **Masks.** Polygon segmentations are rasterized with an even-odd
  scanline fill at the *target* resolution (polygons are scaled first, no
  full-resolution detour); RLE segmentations (compressed or raw) are
  decoded and nearest-resized.

Normalization uses the same ImageNet mean/std as the classification
pipeline (mmdet's ``img_norm_cfg`` is the identical constants x255).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from laudnet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


# --- RLE / polygon -> binary mask -------------------------------------------

def decode_rle_counts(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    """COCO RLE: alternating run lengths (starting with zeros) in
    column-major (Fortran) order."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((w, h)).T


def decode_rle_string(s: str) -> List[int]:
    """Decode COCO's compressed RLE string (the pycocotools LEB128 variant:
    5 data bits per char offset by 48, bit 0x20 = continuation, runs after
    the second are deltas against counts[-2])."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rasterize_polygons(polys: Sequence[Sequence[float]], h: int,
                       w: int) -> np.ndarray:
    """Even-odd scanline fill of COCO polygon lists ([x0,y0,x1,y1,...])
    onto an (h, w) grid. Pixel centers (y + 0.5) are tested, which matches
    pycocotools' rasterization to within boundary-pixel differences.
    Polygon parts are UNIONed (pycocotools merges an annotation's parts);
    even-odd applies only within one polygon — XOR-ing parts into a shared
    buffer would punch false holes where parts overlap."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        pbuf = np.zeros((h, w), np.uint8)
        x0s, y0s = pts[:, 0], pts[:, 1]
        x1s, y1s = np.roll(x0s, -1), np.roll(y0s, -1)
        for row in range(max(0, int(np.floor(y0s.min()))),
                         min(h, int(np.ceil(y0s.max())) + 1)):
            yc = row + 0.5
            # edges crossing this scanline
            cross = ((y0s <= yc) & (y1s > yc)) | ((y1s <= yc) & (y0s > yc))
            if not cross.any():
                continue
            xs = x0s[cross] + (yc - y0s[cross]) / (y1s[cross] - y0s[cross]) \
                * (x1s[cross] - x0s[cross])
            xs.sort()
            for a, b in zip(xs[0::2], xs[1::2]):
                lo = max(0, int(np.ceil(a - 0.5)))
                hi = min(w, int(np.ceil(b - 0.5)))
                if hi > lo:
                    pbuf[row, lo:hi] ^= 1
        mask |= pbuf
    return mask


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO ``segmentation`` entry -> (h, w) uint8 mask."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        sh, sw = seg.get("size", (h, w))
        if isinstance(counts, str):
            counts = decode_rle_string(counts)
        m = decode_rle_counts(counts, sh, sw)
        if (sh, sw) != (h, w):
            yi = np.minimum((np.arange(h) * sh // h), sh - 1)
            xi = np.minimum((np.arange(w) * sw // w), sw - 1)
            m = m[yi][:, xi]
        return m
    return rasterize_polygons(seg, h, w)


# --- dataset ----------------------------------------------------------------

class CocoDataset:
    """COCO-format annotation parser (`mmdet/datasets/coco.py:1` analog).

    ``ann_file``: instances-style JSON; ``img_dir``: directory with the
    image files named by ``file_name``. Category ids are remapped to
    contiguous labels in sorted-id order (mmdet's ``cat2label``).
    """

    def __init__(self, ann_file: str, img_dir: str,
                 filter_empty: bool = True):
        with open(ann_file) as f:
            data = json.load(f)
        self.img_dir = img_dir
        cats = sorted(c["id"] for c in data.get("categories", []))
        self.cat_ids = cats
        self.cat2label = {cid: i for i, cid in enumerate(cats)}
        self.class_names = [
            c["name"] for c in sorted(data.get("categories", []),
                                      key=lambda c: c["id"])
        ]
        anns_by_img: Dict[int, list] = {}
        for a in data.get("annotations", []):
            if a.get("iscrowd", 0):
                continue  # crowd regions are ignore-regions, not GTs
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.images = []
        for im in data.get("images", []):
            anns = anns_by_img.get(im["id"], [])
            if filter_empty and not anns:
                continue
            self.images.append(dict(
                id=im["id"], file_name=im["file_name"],
                height=im["height"], width=im["width"], anns=anns,
            ))

    def __len__(self) -> int:
        return len(self.images)

    @property
    def num_classes(self) -> int:
        return len(self.cat_ids)

    def load_image(self, rec: dict) -> np.ndarray:
        """Decode to float32 RGB in [0, 1]."""
        from PIL import Image

        path = os.path.join(self.img_dir, rec["file_name"])
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0

    def example(self, index: int, target_hw: Tuple[int, int],
                max_gt: int, with_masks: bool = False) -> dict:
        """One resize-padded example with static-shape GT arrays."""
        rec = self.images[index]
        th, tw = target_hw
        img = self.load_image(rec)
        h, w = img.shape[:2]
        scale = min(th / h, tw / w)
        nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
        if (nh, nw) != (h, w):
            from PIL import Image

            pil = Image.fromarray((img * 255).astype(np.uint8))
            img = np.asarray(pil.resize((nw, nh), Image.BILINEAR),
                             np.float32) / 255.0
        canvas = np.zeros((th, tw, 3), np.float32)
        canvas[:nh, :nw] = img
        canvas = (canvas - IMAGENET_MEAN) / IMAGENET_STD

        boxes = np.zeros((max_gt, 4), np.float32)
        labels = np.zeros((max_gt,), np.int32)
        valid = np.zeros((max_gt,), np.float32)
        masks = (np.zeros((max_gt, th, tw), np.float32)
                 if with_masks else None)
        # keep the largest boxes when the image has more GTs than slots
        anns = sorted(rec["anns"], key=lambda a: -a["bbox"][2] * a["bbox"][3])
        sx = nw / w
        sy = nh / h
        for m, a in enumerate(anns[:max_gt]):
            x, y, bw, bh = a["bbox"]
            boxes[m] = (x * sx, y * sy, (x + bw) * sx, (y + bh) * sy)
            labels[m] = self.cat2label[a["category_id"]]
            valid[m] = 1.0
            if with_masks and a.get("segmentation"):
                seg = a["segmentation"]
                if isinstance(seg, dict):
                    full = segmentation_to_mask(seg, h, w)
                    yi = np.minimum((np.arange(nh) * h) // nh, h - 1)
                    xi = np.minimum((np.arange(nw) * w) // nw, w - 1)
                    masks[m, :nh, :nw] = full[yi][:, xi]
                else:
                    scaled = [
                        (np.asarray(p, np.float64)
                         * np.tile([sx, sy], len(p) // 2)).tolist()
                        for p in seg
                    ]
                    masks[m] = rasterize_polygons(scaled, th, tw)
        out = dict(image=canvas, boxes=boxes, labels=labels, valid=valid,
                   image_id=rec["id"], orig_hw=(h, w), scale=(sx, sy))
        if with_masks:
            out["masks"] = masks
        return out


def coco_detection_batches(
    dataset: CocoDataset, *, batch_size: int,
    image_size, max_gt: int = 32, with_masks: bool = False,
    shuffle: bool = False, seed: int = 0, epochs: int = 1,
    shard_index: int = 0, shard_count: int = 1,
) -> Iterator[tuple]:
    """Yield the runner's ``(images, boxes, labels, valid[, masks])``
    static-shape batches from a COCO-format dataset.

    ``image_size``: int (square) or ``(h, w)``. The final partial batch is
    wrapped around (repeating leading examples) so every batch has the same
    shape — a drop-nothing alternative to a ragged tail.
    Sharding pads the order to a shard_count multiple then slices
    ``order[shard_index::shard_count]`` (`DistributedSampler` analog) —
    every shard MUST see the same batch count, or the process with the
    extra batch enters a collective the others never join (see
    `data/loader.py::_pad_order_for_shards`).
    """
    from laudnet_tpu_torch.data.loader import _pad_order_for_shards

    target = ((image_size, image_size) if isinstance(image_size, int)
              else tuple(image_size))
    n = len(dataset)
    if n == 0:
        return
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        order = _pad_order_for_shards(order, shard_count)[
            shard_index::shard_count]
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size:  # wrap the tail (tile tiny epochs)
                reps = -(-(batch_size - len(idx)) // len(order))
                idx = np.concatenate(
                    [idx, np.tile(order, reps)[:batch_size - len(idx)]])
            ex = [dataset.example(int(i), target, max_gt, with_masks)
                  for i in idx]
            batch = (
                np.stack([e["image"] for e in ex]),
                np.stack([e["boxes"] for e in ex]),
                np.stack([e["labels"] for e in ex]),
                np.stack([e["valid"] for e in ex]),
            )
            if with_masks:
                batch = batch + (np.stack([e["masks"] for e in ex]),)
            yield batch


def open_coco(data_dir: str, split: str = "train"):
    """Resolve the standard COCO directory layout
    (``annotations/instances_{split}*.json`` + ``{split}*/`` images) or a
    flat mini-layout (``{split}.json`` + ``images/``)."""
    ann_dir = os.path.join(data_dir, "annotations")
    candidates = []
    if os.path.isdir(ann_dir):
        for f in sorted(os.listdir(ann_dir)):
            if f.startswith(f"instances_{split}") and f.endswith(".json"):
                candidates.append(os.path.join(ann_dir, f))
    flat = os.path.join(data_dir, f"{split}.json")
    if os.path.exists(flat):
        candidates.append(flat)
    if not candidates:
        raise FileNotFoundError(
            f"no COCO annotations for split {split!r} under {data_dir!r}"
        )
    ann_file = candidates[0]
    stem = os.path.splitext(os.path.basename(ann_file))[0]
    img_dir = None
    for cand in (stem.replace("instances_", ""), split, "images"):
        p = os.path.join(data_dir, cand)
        if os.path.isdir(p):
            img_dir = p
            break
    if img_dir is None:
        raise FileNotFoundError(f"no image directory for {ann_file!r}")
    # mmdet convention: filter_empty_gt applies to TRAIN only — dropping
    # empty-GT images from an eval split would hide false positives on
    # them and inflate mAP
    return CocoDataset(ann_file, img_dir,
                       filter_empty=split.startswith("train"))
