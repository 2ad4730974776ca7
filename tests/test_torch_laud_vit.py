"""Port parity for the LAUD-ViT eval forward
(`laudnet_tpu_torch/models/laud_vit.py`) against flax ``LAUDViT.apply``,
with the weights carried across by
`laudnet_tpu_torch/convert/from_jax.py::load_flax_variables`. Policy
biases are zeroed so that the token, head and layer gates actually close
some decisions. Both sides f32: logits to atol 1e-4, densities and FLOPs
to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu_torch.convert.from_jax import load_flax_variables
from laudnet_tpu_torch.models import laud_vit as tlv

torch.set_num_threads(1)
GEOM = dict(depth=2, dim=256, num_heads=4, mlp_ratio=2.0, num_classes=11)
CONFIGS = {
    "all_gates": dict(),
    "token_only": dict(head_skip=False, layer_skip=False),
    "head_only": dict(token_skip=False, layer_skip=False),
    "token_capacity": dict(head_skip=False, layer_skip=False,
                           token_capacity=(1.0, 0.5)),
}


def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 64, 64, 3)).astype(np.float32)


def _flax_params(model, x, seed):
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(seed)},
                                   jnp.asarray(x), 1.0, training=False))()
    params = dict(jax.tree_util.tree_map(np.array, v["params"]))
    rng = np.random.default_rng(seed)
    for name, blk in params.items():
        if not name.startswith("block_"):
            continue
        for head in ("token_policy", "head_policy", "layer_policy"):
            if head in blk:
                blk = dict(blk)
                blk[head] = dict(blk[head])
                blk[head]["bias"] = np.zeros_like(blk[head]["bias"])
                blk[head]["kernel"] = (
                    rng.standard_normal(blk[head]["kernel"].shape) * 0.2
                ).astype(np.float32)
                params[name] = blk
    return params


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_model_matches_flax(config):
    kw = CONFIGS[config]
    x = _images(seed=len(config))
    jmodel = jlv.LAUDViT(**GEOM, **kw)
    params = _flax_params(jmodel, x, seed=len(config))
    ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, 0.1,
                                            training=False))(params,
                                                             jnp.asarray(x))
    model = tlv.LAUDViT(**GEOM, **kw, img_size=64).eval()
    load_flax_variables(model, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=1e-4)
    for field in ("token_density", "head_density", "attn_density",
                  "mlp_density", "flops_perc", "flops", "token_keep"):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, err_msg=field)
    # every gate the configuration carries closes some decision
    model_kw = {"token_skip": True, "head_skip": True, "layer_skip": True,
                **kw}
    if model_kw["token_skip"]:
        assert float(out.token_density.min()) < 1.0
    if model_kw["head_skip"]:
        assert float(out.head_density.min()) < 1.0
    if model_kw["layer_skip"]:
        gates = torch.cat([out.attn_density, out.mlp_density])
        assert float(gates.min()) < 1.0


def test_dense_and_policy_flops_match_jax():
    for kw in ({}, dict(token_skip=False, head_skip=False,
                        layer_skip=False)):
        ref = jlv.vit_dense_flops(jlv.laud_deit_small(**kw))
        assert tlv.vit_dense_flops(tlv.laud_deit_small(**kw, device="meta")
                                   ) == ref
    for flags in ((True, False, True), (False, True, False)):
        kw = dict(token_skip=flags[0], head_skip=flags[1],
                  layer_skip=flags[2])
        assert (tlv.vit_policy_flops(197, 384, 6, **kw)
                == jlv.vit_policy_flops(197, 384, 6, **kw))


def test_load_flax_variables_is_strict():
    x = _images()
    jmodel = jlv.LAUDViT(**GEOM, **CONFIGS["token_only"])
    params = _flax_params(jmodel, x, seed=0)
    model = tlv.LAUDViT(**GEOM, **CONFIGS["token_only"], img_size=64)
    missing = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(KeyError, match="head"):
        load_flax_variables(model, missing)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(model, extra)
    bad = dict(params, head={"kernel": np.zeros((3, 11), np.float32),
                             "bias": params["head"]["bias"]})
    with pytest.raises(ValueError, match="head"):
        load_flax_variables(model, bad)


@pytest.mark.parametrize("kw", [dict(stem="t2t"), dict(attn_impl="fused"),
                                dict(linear_impl="int8")])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError):
        tlv.LAUDViT(**GEOM, img_size=64, **kw)


def test_training_raises_and_generator_init_is_seeded():
    a = tlv.LAUDViT(**GEOM, img_size=64,
                    generator=torch.Generator().manual_seed(0))
    b = tlv.LAUDViT(**GEOM, img_size=64,
                    generator=torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    # policy gates start open: keep-logit +2, skip-logit -2
    assert a.blocks[0].token_policy.bias.tolist() == [2.0, -2.0]
    with pytest.raises(NotImplementedError):
        a(torch.zeros(1, 64, 64, 3), training=True)
