"""Port parity for the tokens-to-token stem
(`laudnet_tpu_torch/models/t2t.py`) against `laudnet_tpu/models/t2t.py`,
with the flax parameters carried across by `load_flax_variables`.

The stem's geometry is fixed at 224x224 (56, 28 and 14 token grids), so
these run at batch 1 and full image size with the stem's real widths
(token_dim 64) and a narrow embed_dim. Both sides f32. Module against
module: atol 1e-4 (summation order). The conv-folded form reassociates the
LayerNorm (E[u^2] - mu^2 over convolutions), so against the module it gets
the JAX package's own bound for that comparison, atol 5e-4 + rtol 1e-3;
conv-folded port against conv-folded JAX is atol 1e-4 again."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import t2t as jt
from laudnet_tpu_torch.convert.from_jax import load_flax_variables
from laudnet_tpu_torch.models import t2t as tt

torch.set_num_threads(1)
EMBED = 128


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def stem():
    x = np.random.default_rng(0).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    jstem = jt.T2TStem(embed_dim=EMBED)
    # lazy_init: the values of init, without compiling the forward
    v = jax.jit(lambda: jstem.lazy_init(
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, jnp.float32)))()
    params = _np_tree(v["params"])
    ref = np.asarray(jax.jit(jstem.apply)(v, jnp.asarray(x)))
    ref_conv = np.asarray(jax.jit(
        lambda p, x: jt.t2t_stem_conv_apply(p, x, embed_dim=EMBED))(
        v["params"], jnp.asarray(x)))
    model = tt.T2TStem(embed_dim=EMBED, device="cpu").eval()
    load_flax_variables(model, params)
    return x, params, model, ref, ref_conv


@pytest.mark.parametrize("k,s,p,hw,c", [(7, 4, 2, 20, 3), (3, 2, 1, 12, 5)])
def test_unfold_matches_jax(k, s, p, hw, c):
    x = np.random.default_rng(k).standard_normal(
        (2, hw, hw, c)).astype(np.float32)
    ref, ref_hw = jt.unfold(jnp.asarray(x), k, s, p)
    out, out_hw = tt.unfold(torch.from_numpy(x), k, s, p)
    assert out_hw == ref_hw
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # (ki, kj, c) row order, not torch.nn.Unfold's channel-major order
    unf = torch.nn.Unfold(k, stride=s, padding=p)(
        torch.from_numpy(x).permute(0, 3, 1, 2)).transpose(1, 2)
    assert not torch.equal(unf, out)
    assert torch.equal(unf.reshape(2, -1, c, k * k).transpose(2, 3).reshape(
        out.shape), out)


def test_token_performer_matches_flax():
    x = np.random.default_rng(1).standard_normal(
        (2, 50, 27)).astype(np.float32)
    jmod = jt.TokenPerformer(64)
    v = jax.jit(lambda: jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))()
    ref = np.asarray(jmod.apply(v, jnp.asarray(x)))
    mod = tt.TokenPerformer(27, 64, device="cpu").eval()
    load_flax_variables(mod, _np_tree(v["params"]))
    assert not mod.w.requires_grad          # fixed features, carried across
    np.testing.assert_array_equal(mod.w.numpy(),
                                  np.asarray(v["params"]["w"]))
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_stem_matches_flax(stem):
    x, _, model, ref, _ = stem
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.shape == (1, 196, EMBED)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_conv_folded_stem_matches_module_and_jax(stem):
    x, _, model, ref, ref_conv = stem
    with torch.no_grad():
        out = tt.t2t_stem_conv_apply(model, torch.from_numpy(x))
        mod = model(torch.from_numpy(x))
    assert out.shape == (1, 196, EMBED)
    np.testing.assert_allclose(out.numpy(), ref_conv, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), mod.numpy(), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4, rtol=1e-3)


def test_stem_loader_is_strict(stem):
    _, params, _, _, _ = stem
    model = tt.T2TStem(embed_dim=EMBED, device="cpu")
    attn1 = {k: v for k, v in params["attn1"].items() if k != "w"}
    with pytest.raises(KeyError, match="attn1.w"):
        load_flax_variables(model, dict(params, attn1=attn1))
    extra = dict(params, attn3=params["attn2"])
    with pytest.raises(KeyError, match="attn3"):
        load_flax_variables(model, extra)


@pytest.mark.parametrize("embed,token", [(448, 64), (192, 64), (384, 32)])
def test_t2t_stem_flops_equal(embed, token):
    assert tt.t2t_stem_flops(embed, token) == jt.t2t_stem_flops(embed, token)
