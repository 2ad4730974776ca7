"""Port parity for the serving engine
(`laudnet_tpu_torch/infer/fused_vit.py::build_fused_vit`) against the JAX
engine in interpret mode and against flax ``LAUDViT.apply``.

A 3-layer token-gated model (D=256, 4 heads of 64, 64x64 images, L=17)
with its token policies randomised so that gates close. Caps (1.0, 0.7,
0.7) gather once at layer 1 and keep an interior policy layer inside the
segment [1, 2]. f32 cases: atol 1e-4 (summation order only). bf16 case:
atol 0.05 on logits below 4 in magnitude, i.e. three bf16 ulps there
(2^-6), for roundings flipped by differing f32 summation orders over
three layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.infer import fused_vit as jfv
from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu_torch.convert.from_jax import load_flax_variables
from laudnet_tpu_torch.infer import fused_vit as tfv
from laudnet_tpu_torch.models import laud_vit as tlv
from laudnet_tpu_torch.ops import vit_block

torch.set_num_threads(1)
GEOM = dict(depth=3, dim=256, num_heads=4, mlp_ratio=2.0, num_classes=11)
JGEOM = dict(depth=3, dim=256, num_heads=4)
NOMINAL = (1.0, 0.7, 0.7)
FLAT = (0.5, 0.5, 0.5)
CASES = {
    "dense": dict(token_capacity=None, fast_math=False),
    "nominal": dict(token_capacity=NOMINAL, fast_math=False),
    "snapped": dict(token_capacity=NOMINAL, snap_capacities=True,
                    fast_math=False),
    "flat_0.5": dict(token_capacity=FLAT, fast_math=False),
    "nominal_fast_math": dict(token_capacity=NOMINAL, fast_math=True),
}


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    jmodel = jlv.LAUDViT(head_skip=False, layer_skip=False, **GEOM)
    v = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                    jnp.asarray(x), 1.0, training=False))()
    params = jax.tree_util.tree_map(np.array, v["params"])
    params = {k: dict(v) if hasattr(v, "items") else v
              for k, v in params.items()}
    rng = np.random.default_rng(1)
    for i in range(GEOM["depth"]):
        tp = params[f"block_{i}"]["token_policy"]
        params[f"block_{i}"]["token_policy"] = {
            "kernel": (rng.standard_normal(tp["kernel"].shape) * 0.2
                       ).astype(np.float32),
            "bias": np.zeros_like(tp["bias"])}
    model = tlv.LAUDViT(head_skip=False, layer_skip=False, img_size=64,
                        **GEOM).eval()
    load_flax_variables(model, params)
    return x, params, model


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine(setup, case):
    x, params, model = setup
    kw = CASES[case]
    ref = jfv.build_fused_vit({"params": params}, **JGEOM, **kw,
                              interpret=True)(jnp.asarray(x))
    fwd = tfv.build_fused_vit(model, **kw)
    out = fwd(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    expect = {"dense": [17] * 3, "flat_0.5": [8] * 3,
              "snapped": [17, 8, 8]}.get(case, [17, 11, 11])
    assert fwd.token_counts == expect


def test_engine_matches_flax_model(setup):
    """Engine == LAUDViT eval for a token-gated model (no head or layer
    gates), with and without capacity."""
    x, params, _ = setup
    for caps in (None, NOMINAL):
        jmodel = jlv.LAUDViT(head_skip=False, layer_skip=False,
                             token_capacity=caps, **GEOM)
        ref = jax.jit(lambda p, x: jmodel.apply(
            {"params": p}, x, 0.1, training=False).logits)(
            params, jnp.asarray(x))
        model = tlv.LAUDViT(head_skip=False, layer_skip=False, img_size=64,
                            **GEOM).eval()
        load_flax_variables(model, params)
        out = tfv.build_fused_vit(model, token_capacity=caps,
                                  fast_math=False)(torch.from_numpy(x))
        if caps is None:
            # the dense engine ignores token policies; the model does not
            with torch.no_grad():
                model_out = model(torch.from_numpy(x)).logits
            assert not np.allclose(model_out.numpy(), out.numpy(), atol=1e-3)
            continue
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("fast_math", [False, True])
def test_segments_bit_equal_to_per_block(setup, fast_math):
    x, _, model = setup
    xt = torch.from_numpy(x)
    for caps, seg in ((NOMINAL, True), (FLAT, True), (None, 3)):
        a = tfv.build_fused_vit(model, token_capacity=caps, segments=seg,
                                fast_math=fast_math)(xt)
        b = tfv.build_fused_vit(model, token_capacity=caps, segments=False,
                                fast_math=fast_math)(xt)
        assert torch.equal(a, b), caps
    assert vit_block.fused_vit_block.launches == 0
    assert vit_block.fused_vit_segment.launches == 0


def test_engine_bf16_matches_jax_engine(setup):
    """bf16 weights and images, the serving default (fast_math). The first
    gather's token indices must be equal exactly."""
    x, params, model = setup
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jfv.build_fused_vit({"params": pb}, **JGEOM, token_capacity=FLAT,
                              interpret=True)(xb)
    mb = tlv.LAUDViT(head_skip=False, layer_skip=False, img_size=64,
                     **GEOM).eval()
    load_flax_variables(mb, params)
    mb = mb.to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = tfv.build_fused_vit(mb, token_capacity=FLAT)(xt)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=0.05)

    # first gather (layer 0, k=8): JAX engine lines fused_vit.py:224-239
    jx, n = jfv._patchify(pb, xb, 256, 16)
    tp = pb["block_0"]["token_policy"]
    tl = jx @ tp["kernel"] + tp["bias"]
    mask = (tl[..., 0] >= tl[..., 1]).astype(jnp.float32).at[:, 0].set(1.0)
    rank = mask * 2.0 + jax.nn.sigmoid(
        (tl[..., 0] - tl[..., 1]).astype(jnp.float32))
    _, jidx = jax.lax.top_k(rank.at[:, 0].add(4.0), 8)
    with torch.no_grad():
        tx, tn = tfv._patchify(mb, xt)
        _, _, tidx = tfv.gate_and_select(
            tx, torch.ones(2, tn + 1), mb.blocks[0].token_policy, 8)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_snap_capacity_to_tiles():
    for k, snapped in ((137, 128), (98, 96), (160, 160), (130, 128),
                       (203, 200), (5, 8)):
        assert tfv.snap_capacity_to_tiles(k) == snapped
        assert jfv.snap_capacity_to_tiles(k) == snapped


@pytest.mark.parametrize("kw", [dict(head_gating=True), dict(int8=True)])
def test_later_slices_raise(setup, kw):
    with pytest.raises(NotImplementedError):
        tfv.build_fused_vit(setup[2], **kw)
