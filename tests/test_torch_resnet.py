"""Port parity for the dense ResNet teachers
(`laudnet_tpu_torch/models/resnet.py`) against `laudnet_tpu/models/
resnet.py`, variables (parameters and BatchNorm statistics) through
`load_flax_variables`. f32 on both sides; the convolutions sum in another
order than XLA's: logits atol 1e-4. A training forward must leave the same
running statistics (flax keeps the biased variance; rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import resnet as jr
from laudnet_tpu.utils.flops import resnet_full_flops as j_full_flops
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.models import resnet as tr
from laudnet_tpu_torch.utils.flops import resnet_full_flops

torch.set_num_threads(1)
KW = dict(num_classes=10, width_mult=0.25)


def shaken_variables(seed, **kw):
    """Flax variables as numpy for ``ResNet(**kw)``: drawn by the port's
    initialiser and carried over by the inverse mapping (no XLA compilation
    of ``init``), with the BatchNorm affines and statistics moved off their
    identity defaults."""
    donor = tr.ResNet(**kw, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    v = {"params": to_flax_tree(donor),
         "batch_stats": to_flax_batch_stats(donor)}
    rng = np.random.default_rng(seed)

    def shake(tree, stats):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                shake(leaf, stats)
            elif stats and k == "var":
                tree[k] = (rng.random(leaf.shape) + 0.5).astype(np.float32)
            elif stats and k == "mean":
                tree[k] = (rng.standard_normal(leaf.shape) * 0.1).astype(
                    np.float32)
            elif k == "scale":
                tree[k] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)
                           ).astype(np.float32)
    shake(v["params"], False)
    shake(v["batch_stats"], True)
    return v


def _x(seed=0, b=2, size=64):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("layers,block", [((2, 1, 1, 1), "bottleneck"),
                                          ((1, 1, 1, 1), "basic")])
def test_eval_and_training_forward_match_flax(layers, block):
    x = _x()
    jmodel = jr.ResNet(layers=layers, block=block, **KW)
    v = shaken_variables(len(block), layers=layers, block=block, **KW)
    model = tr.ResNet(layers=layers, block=block, device="cpu", **KW)
    load_flax_variables(model, v)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, training=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    ref, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, training=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    stats = dict(jax.tree_util.tree_leaves_with_path(
        to_flax_batch_stats(model)))
    leaves = jax.tree_util.tree_leaves_with_path(mutated["batch_stats"])
    assert len(leaves) == len(stats) > 0
    for path, leaf in leaves:
        np.testing.assert_allclose(stats[path], np.asarray(leaf), rtol=1e-5,
                                   atol=1e-6, err_msg=str(path))
    # and the inverse mapping gives the parameter tree back
    back = dict(jax.tree_util.tree_leaves_with_path(to_flax_tree(model)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_bf16_compute_dtype_keeps_f32_masters():
    x = _x(1)
    jmodel = jr.ResNet(layers=(1, 1, 1, 1), dtype=jnp.bfloat16, **KW)
    v = shaken_variables(1, layers=(1, 1, 1, 1), **KW)
    model = tr.ResNet(layers=(1, 1, 1, 1), device="cpu",
                      compute_dtype=torch.bfloat16, **KW)
    load_flax_variables(model, v)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, training=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    # bf16 rounds after every conv and BN on both sides, at sums taken in
    # another order: a few bf16 ulps of O(1) logits
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2)


@pytest.mark.parametrize("ctor", ["resnet18", "resnet34", "resnet50",
                                  "resnet101", "resnet152"])
def test_constructors_and_flops(ctor):
    model = getattr(tr, ctor)(device="meta")
    jmodel = getattr(jr, ctor)()
    assert model.layers == tuple(jmodel.layers)
    n_params = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3)), training=False))
    assert n_params == sum(int(np.prod(s.shape)) for s in
                           jax.tree_util.tree_leaves(shapes["params"]))
    if ctor in ("resnet50", "resnet101"):
        for size, mult in ((224, 1.0), (64, 0.25)):
            assert resnet_full_flops(model.layers, size, mult, 10) == \
                j_full_flops(model.layers, size, mult, 10) == \
                tr.resnet_dense_flops(model.layers, size, mult, 10)


def test_load_is_strict_about_batch_stats():
    model = tr.ResNet(layers=(1, 1, 1, 1), device="cpu", **KW)
    v = {"params": to_flax_tree(model),
         "batch_stats": to_flax_batch_stats(model)}
    load_flax_variables(model, v)              # the round trip is accepted
    with pytest.raises(KeyError, match="not in the flax tree"):
        load_flax_variables(model, {"params": v["params"]})
    extra = {"params": v["params"],
             "batch_stats": dict(v["batch_stats"], bn9={"mean": np.zeros(3)})}
    with pytest.raises(KeyError, match="no port parameter"):
        load_flax_variables(model, extra)
    bad = {"params": v["params"], "batch_stats": {"bn1": {"scale": 1}}}
    with pytest.raises(KeyError, match="neither mean nor var"):
        load_flax_variables(model, bad)
