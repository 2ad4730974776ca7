"""The frozen work arithmetic against hand counts at DeiT-S and ResNet-50
shapes."""

from __future__ import annotations

import torch

from h100_bench import run as R


def _config(name):
    return R.load_json(R.HERE / "configs" / f"{name}.json")


def test_deit_s_block_layer_by_hand():
    work = R.load_module("work", "laud_deit_s_token")
    cfg = _config("laud_deit_s_token")
    info = {"tokens": torch.full((1, 12), 197.0)}
    ops, moved = work.block_layers(cfg, info)[0]
    # qkv 3 d^2 + proj d^2 + fc1, fc2 2 d * 1536 multiply-adds a token,
    # attention 2 * 6 heads * 197^2 * 64 twice (QK^T and PV)
    assert ops == 2 * 197 * (3 * 384 ** 2 + 384 ** 2 + 2 * 384 * 1536) \
        + 2 * 2 * 6 * 197 ** 2 * 64 == 756_782_592
    weights = (4 * 384 ** 2 + 2 * 384 * 1536) * 2
    assert moved == 2 * 197 * 384 * 2 + 2 * 197 * 4 + weights + (
        9 * 384 + 1536) * 2


def test_deit_s_forward_by_hand():
    """Dense: the published 4.6 GMACs of DeiT-S; served at the snapped
    counts 197 x 3, 128 x 4, 96 x 5."""
    work = R.load_module("work", "laud_deit_s_token")
    cfg = _config("laud_deit_s_token")
    dense = work.forward_flop(cfg, {"tokens": torch.full((1, 12), 197.0)})
    patch = 2 * 196 * 768 * 384
    assert dense == patch + 12 * 756_782_592 + 2 * 2 * 384 * 197 * 12 \
        + 2 * 384 * 1000 == 9_201_395_712
    counts = torch.tensor([[197.0] * 3 + [128.0] * 4 + [96.0] * 5] * 2)
    served = work.forward_flop(cfg, {"tokens": counts})

    def layer(l):
        return 2 * l * (4 * 384 ** 2 + 2 * 384 * 1536) + 4 * 6 * l * l * 64

    per_image = (patch + 3 * layer(197) + 4 * layer(128) + 5 * layer(96)
                 + 4 * 384 * (3 * 197 + 4 * 128 + 5 * 96) + 2 * 384 * 1000)
    assert served == 2 * per_image
    assert 5.9e9 < per_image < 6.1e9


def _dense_info(cfg, b=1):
    n = sum(cfg["depths"])
    return {k: torch.ones(b, n) for k in ("s1", "s2", "s3")}


def test_resnet50_dense_convolutions_by_hand():
    """All cells kept: torchvision ResNet-50's 4,089,184,256 multiply-adds
    with the classifier, and the port's own dense bookkeeping."""
    from laudnet_tpu_torch.models.resnet import resnet_dense_flops

    work = R.load_module("work", "laud_resnet50_spatial_4421")
    cfg = _config("laud_resnet50_spatial_4421")
    convs = work.convolutions(cfg, _dense_info(cfg))
    assert len(convs) == 1 + 3 * 16 + 4
    macs = sum(ops for ops, _ in convs) / 2
    assert macs + 2048 * 1000 == 4_089_184_256
    assert macs + 2048 * 1000 + 64 * 56 * 56 * 9 + 2048 == resnet_dense_flops(
        (3, 4, 6, 3))
    # the stem by hand: 224^2 x 3 in, 112^2 x 64 out, bf16, 7x7 weights
    assert convs[0] == (2.0 * 3 * 64 * 112 * 112 * 49,
                        (224 * 224 * 3 + 112 * 112 * 64) * 2
                        + 64 * 3 * 49 * 2)


def test_resnet50_masked_work_scales_with_the_cells():
    """Half the cells of every block: conv1-conv3 count half, the stem and
    the downsamples stay dense; the maskers and the head are added."""
    work = R.load_module("work", "laud_resnet50_spatial_4421")
    cfg = _config("laud_resnet50_spatial_4421")
    dense = _dense_info(cfg)
    half = {k: v * 0.5 for k, v in dense.items()}
    full = work.convolutions(cfg, dense)
    masked = work.convolutions(cfg, half)
    fixed = full[0][0] + sum(
        2.0 * cin * cout * hw for cin, cout, hw in
        ((64, 256, 56 * 56), (256, 512, 28 * 28), (512, 1024, 14 * 14),
         (1024, 2048, 7 * 7)))
    total = sum(o for o, _ in full)
    assert sum(o for o, _ in masked) == fixed + (total - fixed) / 2
    maskers = sum(2 * 4 * cin * cells for cin, cells in
                  [(64, 196), (256, 196), (256, 196), (256, 49)]
                  + [(512, 49)] * 3 + [(512, 49)] + [(1024, 49)] * 5
                  + [(1024, 49)] + [(2048, 49)] * 2)
    assert work.forward_flop(cfg, dense) == total + maskers \
        + 2 * 2048 * 1000
