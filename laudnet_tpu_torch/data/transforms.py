"""ImageNet preprocessing (counterpart of `laudnet_tpu/data/transforms.py`,
which mirrors the reference `utils/transform.py`).

Train: RandomResizedCrop(size) + horizontal flip (+ optional ColorJitter,
AutoAugment, PCA lighting). Eval: Resize(int(size/0.875)) +
CenterCrop(size), the reference eval pipeline. PIL + numpy, formula for
formula the JAX package's, with each image's ``random.Random(seed)`` drawn
in the same order, so the same image and seed give the same pixels. PIL is
imported inside the functions that use it: the native pipeline
(`data/native_loader.py`) imports this module for its constants on a
machine without PIL.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_array(img, normalize: bool = True) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    if x.ndim == 2:
        x = np.stack([x] * 3, axis=-1)
    if normalize:
        x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return x  # HWC


def random_resized_crop(img, size: int, rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = (math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(rng.uniform(*log_r))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.randint(0, w - cw)
            y0 = rng.randint(0, h - ch)
            return img.resize(
                (size, size), Image.BILINEAR,
                box=(x0, y0, x0 + cw, y0 + ch),
            )
    # fallback: center crop
    return center_crop(resize_shorter(img, size), size)


def resize_shorter(img, size: int):
    from PIL import Image

    w, h = img.size
    if w <= h:
        return img.resize((size, int(size * h / w)), Image.BILINEAR)
    return img.resize((int(size * w / h), size), Image.BILINEAR)


def center_crop(img, size: int):
    w, h = img.size
    x0 = (w - size) // 2
    y0 = (h - size) // 2
    return img.crop((x0, y0, x0 + size, y0 + size))


# AlexNet-style PCA lighting noise (reference `utils/transform.py:13-17`,
# applied between ToTensor and Normalize when --change_light is set)
LIGHTING_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
LIGHTING_EIGVEC = np.array(
    [[-0.5675, 0.7192, 0.4009],
     [-0.5808, -0.0045, -0.8140],
     [-0.5836, -0.6948, 0.4203]], np.float32,
)


def lighting_noise(x: np.ndarray, rng: random.Random,
                   alphastd: float = 0.1) -> np.ndarray:
    """Add PCA color noise to a [0,1]-scaled HWC array: one RGB shift per
    image, ``eigvec @ (alpha * eigval)`` with alpha ~ N(0, alphastd)."""
    alpha = np.array([rng.gauss(0.0, alphastd) for _ in range(3)], np.float32)
    shift = LIGHTING_EIGVEC @ (alpha * LIGHTING_EIGVAL)
    return x + shift[None, None, :]


def train_transform(size: int = 224, color_jitter: float = 0.0,
                    auto_augment: Optional[str] = None, normalize=True,
                    change_light: bool = False):
    """Returns fn(PIL, seed) -> HWC float array."""
    aa = None
    if auto_augment:
        from laudnet_tpu_torch.data.auto_augment import auto_augment_transform

        aa = auto_augment_transform(auto_augment)

    def fn(img, seed: int) -> np.ndarray:
        from PIL import Image

        rng = random.Random(seed)
        img = img.convert("RGB")
        img = random_resized_crop(img, size, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if color_jitter:
            img = _color_jitter(img, color_jitter, rng)
        if aa is not None:
            img = aa(img, rng)
        x = _to_array(img, normalize=False)
        if change_light:
            x = lighting_noise(x, rng)
        if normalize:
            x = (x - IMAGENET_MEAN) / IMAGENET_STD
        return x

    return fn


def eval_transform(size: int = 224, crop_ratio: float = 0.875, normalize=True):
    """Resize(size/ratio) + CenterCrop(size) (reference `transform.py:42-47`)."""
    resize_size = int(size / crop_ratio)

    def fn(img, seed: int = 0) -> np.ndarray:
        img = img.convert("RGB")
        img = resize_shorter(img, resize_size)
        img = center_crop(img, size)
        return _to_array(img, normalize)

    return fn


def ecenter_crop_transform(size: int = 224, normalize=True):
    """ResNeSt-style ECenterCrop (reference `utils/transform.py:97-120`):
    resize so the *crop* maps to size/0.875 of the shorter side, then center
    crop: Resize(int(size/0.875)) + CenterCrop on the crop box directly
    (one resample instead of two)."""
    resize_size = int(size / 0.875)

    def fn(img, seed: int = 0) -> np.ndarray:
        from PIL import Image

        img = img.convert("RGB")
        w, h = img.size
        short = min(w, h)
        crop = int(size / resize_size * short)
        x0 = (w - crop) // 2
        y0 = (h - crop) // 2
        img = img.resize((size, size), Image.BICUBIC,
                         box=(x0, y0, x0 + crop, y0 + crop))
        return _to_array(img, normalize)

    return fn


def tencrop_transform(size: int = 224, normalize=True):
    """TenCrop eval (reference `transform.py:123-148`): 4 corners + center,
    plus mirrored; returns (10, H, W, 3)."""
    resize_size = int(size / 0.875)

    def fn(img, seed: int = 0) -> np.ndarray:
        from PIL import Image

        img = resize_shorter(img.convert("RGB"), resize_size)
        w, h = img.size
        s = size
        boxes = [(0, 0), (w - s, 0), (0, h - s), (w - s, h - s),
                 ((w - s) // 2, (h - s) // 2)]
        crops = []
        for flip in (False, True):
            im = img.transpose(Image.FLIP_LEFT_RIGHT) if flip else img
            for x0, y0 in boxes:
                crops.append(
                    _to_array(im.crop((x0, y0, x0 + s, y0 + s)), normalize)
                )
        return np.stack(crops)

    return fn


def _color_jitter(img, strength: float, rng: random.Random):
    from PIL import ImageEnhance

    for enhancer in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                     ImageEnhance.Color):
        factor = 1.0 + rng.uniform(-strength, strength)
        img = enhancer(img).enhance(factor)
    return img
