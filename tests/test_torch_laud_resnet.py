"""Port parity for LAUD-ResNet (`laudnet_tpu_torch/models/laud_resnet.py`)
against flax ``LAUDResNet.apply``, variables (parameters and BatchNorm
statistics) through `load_flax_variables`. The gating heads' biases are
zeroed and the BatchNorms moved off identity, so the masks close about
half their decisions.

f32: logits atol 1e-4 (convolutions sum in another order than XLA's); the
masks decide on logits that differ by ~1e-6, and at these seeds no cell
sits that close to a tie, so the densities (means of 0/1 values, another
summation order: rtol 1e-6), ``flops_perc`` and ``flops`` (rtol 1e-6) agree.
bf16 rounds after every convolution and BatchNorm on both sides: the
densities still agree at this seed, the logits to a few bf16 ulps. The
W8A8 convolutions are exact in integers on both sides; a code that sits on
a rounding tie may flip between the frameworks (1e-3..3e-2 in a logit),
and the seed kept here has none: atol 1e-4 holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import laud_resnet as jlr
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.entry import entry, flagship
from laudnet_tpu_torch.models import laud_resnet as tlr

torch.set_num_threads(1)
BASE = dict(num_classes=10, input_size=64, width_mult=0.25)
SPATIAL = dict(dyn_mode=("spatial",) * 4,
               mask_spatial_granularity=(4, 4, 2, 1))
MIXED = dict(dyn_mode=("spatial", "channel", "both", "layer"),
             mask_spatial_granularity=(4, 4, 2, 1),
             channel_dyn_granularity=(1, 2, 2, 1),
             channel_masker=("MLP", "MLP", "conv_linear", "MLP"),
             channel_masker_layers=(1, 2, 2, 1),
             reduction_ratio=(16, 16, 8, 16))
# Every configuration costs one XLA compilation of the flax model (most of
# this file's time), so each carries as much as it can: `all_modes` has the
# four dyn_modes, both channel maskers, MLPs of one and two layers and a
# spatial mask of two channel groups.
MIXED["spatial_mask_channel_group"] = (2, 1, 1, 1)
CONFIGS = {
    "spatial": dict(layers=(1, 1, 1, 1), **SPATIAL),
    "all_modes": dict(layers=(1, 1, 1, 1), **MIXED),
    "sparse_full": dict(layers=(2, 2, 2, 1), execution="sparse", **SPATIAL),
    "sparse_half": dict(layers=(2, 2, 2, 1), execution="sparse",
                        patch_capacity=(0.5, 0.5, 0.5, 0.5), **SPATIAL),
    "int8": dict(layers=(1, 1, 1, 1), conv_impl="int8", **SPATIAL),
}
FIELDS = ("spatial_s3", "spatial_s2", "spatial_s1", "channel_s",
          "spatial_s3_img")


def variables_for(kw, seed):
    """Flax variables as numpy for the configuration ``kw``: drawn by the
    port's own initialiser (no XLA compilation of ``init``) and carried
    over by the inverse mapping, then the masker biases zeroed and the
    BatchNorm affines and statistics moved off identity."""
    donor = tlr.LAUDResNet(**kw, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    v = {"params": to_flax_tree(donor),
         "batch_stats": to_flax_batch_stats(donor)}
    rng = np.random.default_rng(seed)

    def shake(tree, masker):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                shake(leaf, masker or k.startswith("masker"))
            elif masker and k == "bias":
                tree[k] = np.zeros_like(leaf)
            elif k == "var":
                tree[k] = (rng.random(leaf.shape) + 0.5).astype(np.float32)
            elif k == "mean":
                tree[k] = (rng.standard_normal(leaf.shape) * 0.1).astype(
                    np.float32)
            elif k == "scale":
                tree[k] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)
                           ).astype(np.float32)
    shake(v["params"], False)
    shake(v["batch_stats"], False)
    return v


def _images(seed, b=2, size=64):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _compare(out, ref, logits_atol):
    np.testing.assert_allclose(out.logits.float().detach().numpy(),
                               np.asarray(ref.logits.astype(jnp.float32)),
                               atol=logits_atol)
    for field in FIELDS:
        for s, (got, want) in enumerate(zip(getattr(out, field),
                                            getattr(ref, field))):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       err_msg=f"{field}[{s}]")
    np.testing.assert_allclose(out.flops_perc.detach().numpy(),
                               np.asarray(ref.flops_perc), rtol=1e-6)
    np.testing.assert_allclose(float(out.flops), float(ref.flops), rtol=1e-6)


def _pair(config, seed, **extra):
    kw = dict(BASE, **CONFIGS[config])
    x = _images(seed)
    jkw = dict(kw, **{("dtype" if k == "compute_dtype" else k): v
                      for k, v in extra.get("jax", {}).items()})
    jmodel = jlr.LAUDResNet(**jkw)
    v = variables_for(kw, seed)
    model = tlr.LAUDResNet(**kw, device="cpu", **extra.get("torch", {}))
    load_flax_variables(model, v)
    return jmodel, v, model, x


# "spatial" is the sparse configurations' dense-masked twin: it runs in
# bf16 below, and in f32 through `test_sparse_at_full_capacity_...`
@pytest.mark.parametrize("config", sorted(set(CONFIGS) - {"spatial"}))
def test_eval_matches_flax(config):
    jmodel, v, model, x = _pair(config, seed=len(config))
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, 0.1, training=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 0.1)
    _compare(out, ref, logits_atol=1e-4)
    # the gates closed something, and not everything
    assert 0.05 < float(out.flops_perc.mean()) < 0.98
    if "sparse" in config:
        assert sum(b.sparse_eligible(False) for st in model.stages()
                   for b in st) == 4


def test_sparse_at_full_capacity_equals_dense_masked():
    """With room for every active cell the gather/scatter path computes the
    dense-masked graph: same masks, logits equal to f32 summation order."""
    _, v, sparse, x = _pair("sparse_full", seed=2)
    dense = tlr.LAUDResNet(**dict(BASE, **CONFIGS["sparse_full"],
                                  device="cpu") | {"execution": "dense"})
    load_flax_variables(dense, v)
    with torch.no_grad():
        a, b = sparse(torch.from_numpy(x)), dense(torch.from_numpy(x))
    np.testing.assert_allclose(a.logits.numpy(), b.logits.numpy(), atol=1e-5)
    assert torch.equal(a.flops_perc, b.flops_perc)


def test_bf16_compute_dtype_matches_flax():
    jmodel, v, model, x = _pair(
        "spatial", seed=1, jax=dict(compute_dtype=jnp.bfloat16),
        torch=dict(compute_dtype=torch.bfloat16))
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, 0.1, training=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 0.1)
    assert out.logits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    _compare(out, ref, logits_atol=3e-2)


def test_bn_eval_freezes_statistics_but_not_the_gates():
    block = tlr.LAUDBottleneck(16, 8, dyn_mode="both", output_size=8,
                               mask_spatial_granularity=2, bn_eval=True,
                               has_downsample=True,
                               channel_masker="conv_linear", reduction=4,
                               device="cpu")
    tlr.init_resnet_weights(block, torch.Generator().manual_seed(0))
    before = {k: b.clone() for k, b in block.named_buffers()}
    x = torch.randn(2, 8, 8, 16)
    from laudnet_tpu_torch.ops.gating import GumbelNoise
    noise = GumbelNoise.seeded(0)
    a, _ = block(x, 5.0, training=True, noise=noise)
    b, _ = block(x, 5.0, training=True, noise=noise)
    assert all(torch.equal(before[k], v) for k, v in block.named_buffers())
    assert not torch.equal(a, b)   # two Gumbel draws, two sets of gates


def test_constructors_and_flagship():
    for name, layers in (("uni_resnet50", (3, 4, 6, 3)),
                         ("uni_resnet101", (3, 4, 23, 3))):
        model = getattr(tlr, name)(device="meta")
        assert model.layers == layers == tuple(
            getattr(jlr, name)().layers)
    model = flagship("meta", seed=None, compute_dtype=torch.bfloat16)
    assert model.dyn_mode == ("spatial",) * 4
    assert [b.mask_size for st in model.stages() for b in st[:1]] == [
        (14, 14), (7, 7), (7, 7), (7, 7)]
    eligible = [b.sparse_eligible(False) for st in flagship(
        "meta", seed=None, execution="sparse").stages() for b in st]
    assert sum(eligible) == 13 and len(eligible) == 16
    with pytest.raises(ValueError, match="conv_impl"):
        tlr.uni_resnet50(device="meta", conv_impl="fp8")
    assert callable(entry)
