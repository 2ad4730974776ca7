"""Operations and bytes of LAUD-ResNet-50's work with spatial gating, at
the densities these inputs need.

The multiply-adds follow the model's own accounting (the LAUDNet
reference's, which ``models/laud_resnet.py`` of the port copies): per
bottleneck, the masker (the pooled input, and its 1x1 projection counted
as ``(2 G + 1) * C`` a cell), conv1 at the input resolution times ``s1``,
conv2 at the output resolution times ``s2``, conv3 times ``s3``, the
downsample dense; the stem and the classifier dense. The densities are the
reference's, per image. An operation is two FLOPs.

A convolution's bytes are its input read once and its output written once
(bf16) at the density its operations are counted at, and its weights read
once (bf16) a batch.
"""

from __future__ import annotations

BF16 = 2


def _blocks(cfg):
    out, inplanes = [], cfg["stem_width"]
    size = cfg["image_size"] // 4
    for s, (n, planes) in enumerate(zip(cfg["depths"], cfg["stage_planes"])):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            if stride == 2:
                size //= 2
            out.append((inplanes, planes, stride, b == 0, size,
                        cfg["mask_granularity"][s]))
            inplanes = planes * cfg["expansion"]
    return out


def convolutions(cfg, info) -> list:
    """(operations, bytes) of each convolution for one batch whose
    reference facts are ``info`` (``s1``, ``s2``, ``s3``: (B, blocks))."""
    exp, stem = cfg["expansion"], cfg["stem_width"]
    size = cfg["image_size"]
    b = info["s3"].shape[0]
    half = size // 2
    out = [(2.0 * b * 3 * stem * half * half * 49,
            b * (size * size * 3 + half * half * stem) * BF16
            + stem * 3 * 49 * BF16)]
    for i, (inp, planes, stride, ds, osz, _) in enumerate(_blocks(cfg)):
        s1, s2, s3 = (float(info[k][:, i].sum()) for k in ("s1", "s2", "s3"))
        in_hw, out_hw = (osz * stride) ** 2, osz * osz
        op = planes * exp
        out.append((2.0 * inp * planes * in_hw * s1,
                     (in_hw * (inp + planes)) * BF16 * s1
                     + inp * planes * BF16))
        out.append((2.0 * planes * planes * 9 * out_hw * s2,
                     (in_hw * planes + out_hw * planes) * BF16 * s2
                     + planes * planes * 9 * BF16))
        out.append((2.0 * planes * op * out_hw * s3,
                     (out_hw * (planes + op)) * BF16 * s3
                     + planes * op * BF16))
        if ds:
            out.append((2.0 * b * inp * op * out_hw,
                         b * (in_hw * inp + out_hw * op) * BF16
                         + inp * op * BF16))
    return out


def forward_flop(cfg, info) -> float:
    """FLOPs of one batch's forward by the model's accounting: the
    convolutions, the maskers and the classifier."""
    b = info["s3"].shape[0]
    flop = sum(ops for ops, _ in convolutions(cfg, info))
    for inp, _, _, _, osz, g in _blocks(cfg):
        cells = (osz // g) ** 2
        flop += 2.0 * b * (inp * cells + 3 * inp * cells)
    last = cfg["stage_planes"][-1] * cfg["expansion"]
    flop += 2.0 * b * last * cfg["num_labels"]
    return float(flop)
