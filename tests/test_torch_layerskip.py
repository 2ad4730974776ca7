"""The port's batch-1 layer-skip engines (`laudnet_tpu_torch/infer/
layerskip.py`) against the JAX package's (`laudnet_tpu/infer/layerskip.py`,
jitted; its ViT attention in Pallas interpret mode) and against the port
model's own eval forward, on the same weights (drawn by the port's
initialiser, carried to flax). Gates are biased shut at random (ResNet) or
forced closed (ViT) so the engines really skip. f32 on both sides: logits
to rtol/atol 1e-4 (ResNet, as `tests/test_layerskip_engine.py`) and atol
2e-5 (ViT); the number of blocks or branches run is equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.infer import layerskip as jls
from laudnet_tpu_torch.convert.from_jax import (to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.infer import layerskip as tls
from laudnet_tpu_torch.models import laud_resnet as tlr
from laudnet_tpu_torch.models import laud_vit as tlv

torch.set_num_threads(1)
RESNET = dict(layers=(2, 2, 2, 2), num_classes=10, input_size=64,
              width_mult=0.25, dyn_mode=("layer",) * 4,
              channel_masker=("MLP",) * 4, channel_masker_layers=(1, 1, 1, 1))
VIT = dict(depth=2, dim=128, num_heads=2, mlp_ratio=2.0, patch_size=8,
           num_classes=11, token_skip=False, head_skip=False, layer_skip=True)


@pytest.fixture(scope="module")
def resnet():
    model = tlr.LAUDResNet(**RESNET, device="cpu",
                           generator=torch.Generator().manual_seed(1)).eval()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for names in model.block_names:
            for n in names:
                if rng.random() < 0.5:  # bias this block's gate shut
                    getattr(model, n).masker_spatial.conv.bias.copy_(
                        torch.tensor([-5.0, 5.0]))
    variables = {"params": to_flax_tree(model),
                 "batch_stats": to_flax_batch_stats(model)}
    return model, jax.jit(jls.build_layer_skip_resnet(variables,
                                                      RESNET["layers"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_resnet_layer_skip_matches_jax_and_the_model(resnet, seed):
    model, jfwd = resnet
    x = np.random.default_rng(seed).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    want, want_run = jfwd(jnp.asarray(x))
    got, n_run = tls.build_layer_skip_resnet(model)(torch.from_numpy(x))
    assert n_run == int(want_run)
    assert 0 < n_run < 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with torch.no_grad():
        ref = model(torch.from_numpy(x), 0.1)
    assert n_run == int(sum(s.sum() for s in ref.spatial_s3))
    np.testing.assert_allclose(got.numpy(), ref.logits.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_vit_layer_skip_matches_jax_and_the_model():
    model = tlv.LAUDViT(**VIT, img_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        # close block 0's attention and block 1's MLP (bias layout:
        # attn_on, mlp_on, attn_off, mlp_off)
        model.blocks[0].layer_policy.bias[0] = -5.0
        model.blocks[1].layer_policy.bias[1] = -5.0
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    fwd = jax.jit(jls.build_layer_skip_vit(
        {"params": to_flax_tree(model)}, depth=2, dim=128, num_heads=2,
        patch_size=8, interpret=True))
    want, want_run = fwd(jnp.asarray(x))
    got, n_run = tls.build_layer_skip_vit(model)(torch.from_numpy(x))
    assert n_run == int(want_run) == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    with torch.no_grad():
        ref = model(torch.from_numpy(x), 0.1).logits
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def test_layer_skip_rejects_multi_image_batches(resnet):
    model, _ = resnet
    with pytest.raises(ValueError, match="batch-1"):
        tls.build_layer_skip_resnet(model)(torch.zeros(2, 64, 64, 3))
    vit = tlv.LAUDViT(**VIT, img_size=32, device="cpu",
                      generator=torch.Generator().manual_seed(0)).eval()
    with pytest.raises(ValueError, match="batch-1"):
        tls.build_layer_skip_vit(vit)(torch.zeros(2, 32, 32, 3))
