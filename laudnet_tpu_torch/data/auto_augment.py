"""AutoAugment (ImageNet policies), compact PIL implementation
(counterpart of `laudnet_tpu/data/auto_augment.py`, formula for formula).

The reference vendors timm's AutoAugment engine
(`imagenet_classification/utils/auto_augment.py`, 659 LoC) and its training
transform uses the **v0** policy with ImageNet-mean fill and random
bilinear/bicubic interpolation (`auto_augment.py:507-518`). This compact
implementation reproduces that engine's observable behavior: the magnitude
mappings (`auto_augment.py:180-258`), probability semantics
(`auto_augment.py:337-345`), fill color, and the ORDER of RNG consumption,
so that with the same seed it gives the JAX package's pixels.

``auto_augment_transform()`` mirrors the reference entry: v0 policy,
fill (124, 116, 104). The paper's 'original' policy is also provided.
"""

from __future__ import annotations

import random

from PIL import Image, ImageEnhance, ImageOps

# round(255 * imagenet_mean) — reference `auto_augment.py:509-517`
IMAGENET_FILL = (124, 116, 104)
_MAX_LEVEL = 10.0
_INTERPOLATIONS = (Image.BILINEAR, Image.BICUBIC)


# --- op primitives (geometric ops take an explicit resample) --------------

def _shear_x(img, v, fill, resample):
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                         fillcolor=fill, resample=resample)


def _shear_y(img, v, fill, resample):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                         fillcolor=fill, resample=resample)


def _translate_x_rel(img, v, fill, resample):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, v * img.size[0], 0, 1, 0),
                         fillcolor=fill, resample=resample)


def _translate_y_rel(img, v, fill, resample):
    return img.transform(img.size, Image.AFFINE,
                         (1, 0, 0, 0, 1, v * img.size[1]),
                         fillcolor=fill, resample=resample)


def _rotate(img, v, fill, resample):
    return img.rotate(v, fillcolor=fill, resample=resample)


def _posterize(img, bits, fill=None, resample=None):
    if bits >= 8:
        return img
    return ImageOps.posterize(img, bits)


def _solarize(img, thresh, fill=None, resample=None):
    return ImageOps.solarize(img, thresh)


def _solarize_add(img, add, fill=None, resample=None, thresh=128):
    """reference `auto_augment.py:139-151`."""
    lut = []
    for i in range(256):
        lut.append(min(255, i + add) if i < thresh else i)
    if img.mode in ("L", "RGB"):
        if img.mode == "RGB" and len(lut) == 256:
            lut = lut + lut + lut
        return img.point(lut)
    return img


def _enhance(enhancer):
    return lambda img, v, fill=None, resample=None: enhancer(img).enhance(v)


OPS = {
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateXRel": _translate_x_rel,
    "TranslateYRel": _translate_y_rel,
    "Rotate": _rotate,
    "Color": _enhance(ImageEnhance.Color),
    "Contrast": _enhance(ImageEnhance.Contrast),
    "Brightness": _enhance(ImageEnhance.Brightness),
    "Sharpness": _enhance(ImageEnhance.Sharpness),
    "Posterize": _posterize,
    "PosterizeOriginal": _posterize,
    "Solarize": _solarize,
    "SolarizeAdd": _solarize_add,
    "AutoContrast": lambda img, v=None, fill=None, resample=None:
        ImageOps.autocontrast(img),
    "Equalize": lambda img, v=None, fill=None, resample=None:
        ImageOps.equalize(img),
    "Invert": lambda img, v=None, fill=None, resample=None:
        ImageOps.invert(img),
}

_GEOMETRIC = {"ShearX", "ShearY", "TranslateXRel", "TranslateYRel", "Rotate"}
_NO_ARG = {"AutoContrast", "Equalize", "Invert"}
_NEGATED = {"ShearX", "ShearY", "TranslateXRel", "TranslateYRel", "Rotate"}


def magnitude_to_arg(op: str, level: float, rng=None):
    """timm level->arg mappings at magnitude_std=0 (reference
    `auto_augment.py:180-258`); ``rng`` consumes one call for the random
    negation of geometric magnitudes (`auto_augment.py:175-177`)."""
    if op in _NO_ARG:
        return None
    if op in ("ShearX", "ShearY"):
        v = (level / _MAX_LEVEL) * 0.3
    elif op in ("TranslateXRel", "TranslateYRel"):
        v = (level / _MAX_LEVEL) * 0.45
    elif op == "Rotate":
        v = (level / _MAX_LEVEL) * 30.0
    elif op in ("Color", "Contrast", "Brightness", "Sharpness"):
        return (level / _MAX_LEVEL) * 1.8 + 0.1
    elif op == "Posterize":
        return int((level / _MAX_LEVEL) * 4)
    elif op == "PosterizeOriginal":
        return int((level / _MAX_LEVEL) * 4) + 4
    elif op == "Solarize":
        return int((level / _MAX_LEVEL) * 256)
    elif op == "SolarizeAdd":
        return int((level / _MAX_LEVEL) * 110)
    else:
        raise KeyError(op)
    if op in _NEGATED and rng is not None:
        v = -v if rng.random() > 0.5 else v
    return v


# ImageNet v0 policy (TPU EfficientNet; the reference transform's default,
# `auto_augment.py:348-379`): (op, prob, magnitude-level) pairs.
IMAGENET_POLICY_V0 = [
    (("Equalize", 0.8, 1), ("ShearY", 0.8, 4)),
    (("Color", 0.4, 9), ("Equalize", 0.6, 3)),
    (("Color", 0.4, 1), ("Rotate", 0.6, 8)),
    (("Solarize", 0.8, 3), ("Equalize", 0.4, 7)),
    (("Solarize", 0.4, 2), ("Solarize", 0.6, 2)),
    (("Color", 0.2, 0), ("Equalize", 0.8, 8)),
    (("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)),
    (("ShearX", 0.2, 9), ("Rotate", 0.6, 8)),
    (("Color", 0.6, 1), ("Equalize", 1.0, 2)),
    (("Invert", 0.4, 9), ("Rotate", 0.6, 0)),
    (("Equalize", 1.0, 9), ("ShearY", 0.6, 3)),
    (("Color", 0.4, 7), ("Equalize", 0.6, 0)),
    (("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)),
    (("Solarize", 0.6, 8), ("Color", 0.6, 9)),
    (("Solarize", 0.2, 4), ("Rotate", 0.8, 9)),
    (("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)),
    (("ShearX", 0.0, 0), ("Solarize", 0.8, 4)),
    (("ShearY", 0.8, 0), ("Color", 0.6, 4)),
    (("Color", 1.0, 0), ("Rotate", 0.6, 2)),
    (("Equalize", 0.8, 4), ("Equalize", 0.0, 8)),
    (("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)),
    (("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)),
    (("Posterize", 0.8, 2), ("Solarize", 0.6, 10)),
    (("Solarize", 0.6, 8), ("Equalize", 0.6, 1)),
    (("Color", 0.8, 6), ("Rotate", 0.4, 5)),
]

# ImageNet 'original' policy (AutoAugment paper, arXiv:1805.09501;
# reference `auto_augment.py:415-444`).
IMAGENET_POLICY_ORIGINAL = [
    (("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
]

POLICIES = {
    "v0": IMAGENET_POLICY_V0,
    "original": IMAGENET_POLICY_ORIGINAL,
}


def apply_op(img, op: str, level: float, rng, fill=IMAGENET_FILL):
    """Apply one op at a magnitude level, consuming RNG in the reference's
    order: negate draw (geometric magnitudes) then interpolation choice."""
    arg = magnitude_to_arg(op, level, rng)
    if op in _GEOMETRIC:
        resample = rng.choice(_INTERPOLATIONS)
        return OPS[op](img, arg, fill, resample)
    return OPS[op](img, arg)


def auto_augment_transform(config: str = "v0", fill=IMAGENET_FILL):
    """Returns ``fn(PIL, rng) -> PIL`` applying one sampled sub-policy.
    ``rng`` may be the ``random`` module or a ``random.Random`` — with the
    same seed, output is pixel-identical to the reference engine."""
    policy = POLICIES[config]

    def fn(img: Image.Image, rng=random) -> Image.Image:
        sub_policy = rng.choice(policy)
        for op, prob, level in sub_policy:
            # reference AugmentOp.__call__ (`auto_augment.py:337-345`)
            if prob < 1.0 and rng.random() > prob:
                continue
            img = apply_op(img, op, level, rng, fill)
        return img

    return fn
