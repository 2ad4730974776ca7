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
                        device="cpu", **GEOM).eval()
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
                            device="cpu", **GEOM).eval()
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
                     device="cpu", **GEOM).eval()
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


@pytest.mark.parametrize("kw", [dict(fn="fake_quant_per_image"),
                                dict(fn="QuantConv")])
def test_later_slices_raise(setup, kw):
    """What of `ops/quant.py` once belonged to a later slice and raised,
    the per-image fake-quant and `QuantConv`, now runs (held to JAX in
    `tests/test_torch_quant.py`): an int8-representable image comes back
    unchanged, and a 1x1 `QuantConv` with an identity kernel returns it.
    Nor do the row and weight fake-quant (QAT) raise, nor the engine for
    head_gating or int8."""
    from laudnet_tpu_torch.ops import quant

    x = torch.tensor([[127.0, -64.0], [3.0, 0.0]]).reshape(1, 2, 2, 1)
    if kw["fn"] == "fake_quant_per_image":
        assert torch.equal(quant.fake_quant_per_image(x), x)
    else:
        conv = quant.QuantConv(1, 1, 1, device="cpu")
        with torch.no_grad():
            conv.weight.fill_(1.0)
            assert torch.allclose(conv(x), x, rtol=1e-6)
    assert quant.fake_quant_rows(torch.ones(2, 4)).shape == (2, 4)
    tfv.build_fused_vit(setup[2], head_gating=True, int8=True)


# --- head gates, W8A8, odd head counts and the T2T stem ---------------------
#
# f32 against the JAX engine in interpret mode: atol 1e-4. The W8A8 cases
# agree to ~1e-6 as long as no activation sits within an f32 ulp of a
# rounding tie (see test_torch_laud_vit.py::test_int8_linear_eval_matches_flax
# for what a flipped code costs); the seeds here are free of such ties.

def _randomised_params(jmodel, x, seed, heads=("token_policy", "head_policy")):
    v = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(seed)},
                                    jnp.asarray(x), 1.0, training=False))()
    params = {k: dict(v) if hasattr(v, "items") else v for k, v in
              jax.tree_util.tree_map(np.array, v["params"]).items()}
    rng = np.random.default_rng(seed)
    for name, blk in params.items():
        for head in heads:
            if name.startswith("block_") and head in blk:
                blk[head] = {
                    "kernel": (rng.standard_normal(blk[head]["kernel"].shape)
                               * 0.2).astype(np.float32),
                    "bias": np.zeros_like(blk[head]["bias"])}
    return params


def _port_model(params, **kw):
    model = tlv.LAUDViT(device="cpu", **kw).eval()
    return load_flax_variables(model, params)


GATED = dict(depth=2, dim=256, num_heads=4, mlp_ratio=2.0, num_classes=11,
             layer_skip=False)


@pytest.fixture(scope="module")
def gated():
    """Token and head gates, both randomised so that some close."""
    x = np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    params = _randomised_params(jlv.LAUDViT(**GATED), x, seed=3)
    return x, params, _port_model(params, img_size=64, **GATED)


@pytest.mark.parametrize("caps", [None, (1.0, 0.5)], ids=["dense", "select"])
def test_head_gated_engine_matches_jax_engine_and_model(gated, caps):
    x, params, model = gated
    ref = jfv.build_fused_vit({"params": params}, depth=2, dim=256,
                              num_heads=4, token_capacity=caps,
                              head_gating=True, fast_math=False,
                              interpret=True)(jnp.asarray(x))
    out = tfv.build_fused_vit(model, token_capacity=caps, head_gating=True,
                              fast_math=False)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    ungated = tfv.build_fused_vit(model, token_capacity=caps,
                                  fast_math=False)(torch.from_numpy(x))
    assert not np.allclose(ungated.numpy(), out.numpy(), atol=1e-3)
    if caps is None:
        # the dense engine ignores token policies: compare with the model
        # without them, as tests/test_fused_vit_block.py does
        jmodel = jlv.LAUDViT(**dict(GATED, token_skip=False))
        jparams = {k: ({n: w for n, w in v.items() if n != "token_policy"}
                       if k.startswith("block_") else v)
                   for k, v in params.items()}
    else:
        jmodel, jparams = jlv.LAUDViT(**GATED, token_capacity=caps), params
    flax_out = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, 0.1, training=False))(jparams, jnp.asarray(x))
    assert float(np.asarray(flax_out.head_density).mean()) < 1.0
    np.testing.assert_allclose(out.numpy(), np.asarray(flax_out.logits),
                               atol=1e-4)


@pytest.mark.parametrize("caps", [None, NOMINAL], ids=["dense", "select"])
def test_int8_engine_matches_jax_engine(setup, caps):
    x, params, model = setup
    ref = jfv.build_fused_vit({"params": params}, **JGEOM, int8=True,
                              token_capacity=caps, interpret=True)(
        jnp.asarray(x))
    fwd = tfv.build_fused_vit(model, int8=True, token_capacity=caps)
    out = fwd(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    assert fwd.token_counts == ([17] * 3 if caps is None else [17, 11, 11])
    assert vit_block.fused_vit_block_int8.launches == 0


def test_int8_engine_is_close_to_the_float_engine(setup):
    """W8A8 is an inexact path: over three layers the logits move by a few
    hundredths of their norm, and not by nothing. The bound is the JAX
    package's for the same comparison (tests/test_fused_vit_block.py:
    0 < rel < 0.05, equal predictions)."""
    x, _, model = setup
    xt = torch.from_numpy(x)
    q = tfv.build_fused_vit(model, int8=True)(xt)
    f = tfv.build_fused_vit(model, fast_math=False)(xt)
    rel = ((q - f).norm() / f.norm()).item()
    assert 0 < rel < 5e-2, rel
    assert torch.equal(q.argmax(-1), f.argmax(-1))


ODD = dict(depth=2, dim=192, num_heads=3, mlp_ratio=2.0, num_classes=11,
           layer_skip=False)


@pytest.fixture(scope="module")
def odd():
    x = np.random.default_rng(4).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    params = _randomised_params(jlv.LAUDViT(**ODD), x, seed=4)
    return x, params, _port_model(params, img_size=64, **ODD)


@pytest.mark.parametrize("kw", [dict(int8=True),
                                dict(head_gating=True, fast_math=False),
                                dict(int8=True, head_gating=True,
                                     token_capacity=(1.0, 0.5))],
                         ids=["int8", "head_gated", "int8_gated_select"])
def test_three_heads_match_jax_with_its_fake_head(odd, kw):
    """The JAX engine pads a zero fake head into qkv and proj for 3 heads;
    the port runs 3 heads as they are. The fake head's weight columns
    quantise to 0 and its zero output does not move a row's abs-max, so
    the int8 codes, and the logits, are the same."""
    x, params, model = odd
    ref = jfv.build_fused_vit({"params": params}, depth=2, dim=192,
                              num_heads=3, interpret=True, **kw)(
        jnp.asarray(x))
    out = tfv.build_fused_vit(model, **kw)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


T2T = dict(depth=2, dim=192, num_heads=3, mlp_ratio=2.0, num_classes=11,
           stem="t2t", head_skip=False, layer_skip=False)


@pytest.fixture(scope="module")
def t2t():
    """The full T2T serving path at test width: performer stem (fixed at
    224x224), 3 heads, selection at layer 1."""
    x = np.random.default_rng(5).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    params = _randomised_params(jlv.LAUDViT(**T2T), x, seed=5)
    return x, params, _port_model(params, **T2T)


@pytest.mark.parametrize("kw", [dict(), dict(token_capacity=(1.0, 0.5)),
                                dict(token_capacity=(1.0, 0.5), int8=True)],
                         ids=["dense", "select", "select_int8"])
def test_t2t_engine_matches_jax_engine(t2t, kw):
    """The float cases hold atol 1e-4. The W8A8 case cannot: the two
    frameworks' stems differ by ~1e-5 (f32 convolutions), which over 197
    tokens puts hundreds of activations on the other side of a rounding
    tie, and the flipped codes move the logits as far as quantisation
    itself does. It is held to the inexact path's own bound: relative
    logit error under 5e-2 and equal predictions."""
    x, params, model = t2t
    ekw = dict(kw) if "int8" in kw else dict(kw, fast_math=False)
    ref = np.asarray(jfv.build_fused_vit(
        {"params": params}, depth=2, dim=192, num_heads=3, stem="t2t",
        interpret=True, **ekw)(jnp.asarray(x)))
    fwd = tfv.build_fused_vit(model, **ekw)
    out = fwd(torch.from_numpy(x)).numpy()
    if "int8" in kw:
        rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        assert rel < 5e-2, rel
        assert (out.argmax(-1) == ref.argmax(-1)).all()
    else:
        np.testing.assert_allclose(out, ref, atol=1e-4)
    assert fwd.token_counts == ([197, 98] if kw else [197, 197])


def test_t2t_engine_matches_flax_model(t2t):
    """Against ``LAUDViT.apply``: the engine's conv-folded stem
    reassociates the stem's LayerNorms, so the JAX package's own bound for
    this comparison applies (atol 5e-3, equal predictions)."""
    x, params, model = t2t
    caps = (1.0, 0.5)
    jmodel = jlv.LAUDViT(**T2T, token_capacity=caps)
    ref = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, 0.1, training=False).logits)(params,
                                                       jnp.asarray(x)))
    out = tfv.build_fused_vit(model, token_capacity=caps, fast_math=False)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-3)
    assert (out.argmax(-1) == ref.argmax(-1)).all()
