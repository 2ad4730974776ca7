"""Port parity for the LAUD-ViT forward, eval and training
(`laudnet_tpu_torch/models/laud_vit.py`) against flax ``LAUDViT.apply``,
with the weights carried across by
`laudnet_tpu_torch/convert/from_jax.py::load_flax_variables`. Policy
biases are zeroed so that the token, head and layer gates actually close
some decisions. Both sides f32: logits to atol 1e-4, densities and FLOPs
to rtol 1e-5.

The training forward is held against flax in
`tests/test_torch_laud_vit_train.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu_torch.convert.from_jax import load_flax_variables
from laudnet_tpu_torch.models import laud_vit as tlv
from laudnet_tpu_torch.ops.gating import GumbelNoise

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
    model = tlv.LAUDViT(**GEOM, **kw, img_size=64, device="cpu").eval()
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
    model = tlv.LAUDViT(**GEOM, **CONFIGS["token_only"], img_size=64,
                        device="cpu")
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


TRAIN_GEOM = dict(depth=2, dim=128, num_heads=2, mlp_ratio=2.0,
                  num_classes=11)


def test_eval_paths_write_nothing_in_place():
    """The class-token pin and the capacity rank are out of place: an eval
    forward under grad mode (no ``no_grad``) with capacities backpropagates,
    which an in-place write into the gate's output would break."""
    x = _images(seed=27)[:, :32, :32]
    model = tlv.LAUDViT(**TRAIN_GEOM, img_size=32, device="cpu",
                        token_capacity=(1.0, 0.5),
                        generator=torch.Generator().manual_seed(0))
    out = model(torch.from_numpy(x))
    out.logits.sum().backward()
    assert model.blocks[0].fc1.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("kw", [dict(linear_impl="int8_qat"),
                                dict(attn_impl="fused"),
                                dict(linear_impl="int8")])
def test_later_slices_raise(kw):
    """Once the training slice's parts raised here; now each of them
    trains: the QAT linears, the fused attention under grad, and 'int8'
    (which trains dense and quantises at eval only). What still raises
    is a training forward without a noise source."""
    model = tlv.LAUDViT(**TRAIN_GEOM, img_size=32, device="cpu", **kw,
                        generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(_images(seed=29)[:, :32, :32])
    with pytest.raises(ValueError, match="noise source"):
        model(x, 1.0, training=True)
    out = model(x, 1.0, training=True, noise=GumbelNoise.seeded(3))
    out.logits.sum().backward()
    assert torch.isfinite(out.logits).all()
    assert model.blocks[1].proj.weight.grad.abs().sum() > 0
    if kw.get("linear_impl") == "int8":   # trains dense, serves W8A8
        dense = tlv.LAUDViT(**TRAIN_GEOM, img_size=32, device="cpu")
        dense.load_state_dict(model.state_dict())
        ref = dense(x, 1.0, training=True, noise=GumbelNoise.seeded(3))
        assert torch.equal(out.logits, ref.logits)
        with torch.no_grad():
            assert not torch.equal(model(x).logits, dense(x).logits)


def test_training_raises_and_generator_init_is_seeded():
    a = tlv.LAUDViT(**GEOM, img_size=64, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    b = tlv.LAUDViT(**GEOM, img_size=64, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    # policy gates start open: keep-logit +2, skip-logit -2
    assert a.blocks[0].token_policy.bias.tolist() == [2.0, -2.0]
    with pytest.raises(ValueError, match="noise source"):
        a(torch.zeros(1, 64, 64, 3), training=True)


# --- the T2T stem, the fused attention and the int8 linears at eval --------

T2T_GEOM = dict(depth=2, dim=192, num_heads=3, mlp_ratio=2.0, num_classes=11,
                stem="t2t")


@pytest.fixture(scope="module")
def t2t_case():
    """A 2-layer T2T model at 224x224 (the stem's fixed geometry), 3 heads
    (an odd count), batch 1, with every policy randomised."""
    x = _images(seed=5, b=1)[:, :1, :1, :].repeat(224, 1).repeat(224, 2)
    x = x + np.random.default_rng(6).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    jmodel = jlv.LAUDViT(**T2T_GEOM)
    params = _flax_params(jmodel, x, seed=5)
    ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, 0.1,
                                            training=False))(params,
                                                             jnp.asarray(x))
    return x, params, ref


def test_t2t_model_matches_flax(t2t_case):
    x, params, ref = t2t_case
    model = tlv.LAUDViT(**T2T_GEOM, device="cpu").eval()
    load_flax_variables(model, params)
    assert not hasattr(model, "patch_embed") and model.num_patches == 196
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits),
                               atol=1e-4)
    for field in ("token_density", "head_density", "attn_density",
                  "mlp_density", "flops_perc", "flops", "token_keep"):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-5, err_msg=field)
    assert float(out.token_density.min()) < 1.0


def test_t2t_dense_flops_and_constructors_match_jax():
    for name in ("laud_t2t_vit_19", "laud_t2t_vit_19_backbone"):
        jmodel = getattr(jlv, name)()
        model = getattr(tlv, name)(device="meta")
        assert (model.depth, model.dim, model.num_heads, model.mlp_ratio,
                model.stem) == (14, 448, 7, 3.0, jmodel.stem)
        assert tlv.vit_dense_flops(model) == jlv.vit_dense_flops(jmodel)
    assert model.blocks[0].hidden == 1344


@pytest.mark.parametrize("config", ["all_gates", "token_capacity"])
def test_fused_attention_eval_equals_reference_eval(config):
    """attn_impl='fused' at eval against flax attn_impl='fused' (its
    kernel in interpret mode) and against the port's attn_impl='reference'
    on the same weights."""
    kw = CONFIGS[config]
    x = _images(seed=11)
    jmodel = jlv.LAUDViT(**GEOM, **kw, attn_impl="fused")
    params = _flax_params(jmodel, x, seed=11)
    ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, 0.1,
                                            training=False).logits)(
        params, jnp.asarray(x))
    outs = {}
    for impl in ("fused", "reference"):
        model = tlv.LAUDViT(**GEOM, **kw, attn_impl=impl, img_size=64,
                            device="cpu").eval()
        load_flax_variables(model, params)
        with torch.no_grad():
            outs[impl] = model(torch.from_numpy(x)).logits
    np.testing.assert_allclose(outs["fused"].numpy(), np.asarray(ref),
                               atol=1e-4)
    np.testing.assert_allclose(outs["fused"].numpy(),
                               outs["reference"].numpy(), atol=1e-5)
    # outside no_grad the fused path gives the same values and a graph
    model_f = tlv.LAUDViT(**GEOM, **kw, attn_impl="fused", img_size=64,
                          device="cpu").eval()
    load_flax_variables(model_f, params)
    live = model_f(torch.from_numpy(x)).logits
    assert live.requires_grad and torch.equal(live.detach(), outs["fused"])


@pytest.mark.parametrize("config", ["token_only", "head_only"])
def test_int8_linear_eval_matches_flax(config):
    """linear_impl='int8' at eval: the same float checkpoint loads, and
    the W8A8 products agree with flax's QuantDense to atol 1e-4 (1e-6 in
    practice: f32 around exact integer sums). That holds as long as no
    activation sits within an f32 ulp of a rounding tie: the two
    frameworks' LayerNorms sum in different orders, and a value that they
    quantise to neighbouring codes moves that image's logits by 1e-3 to
    3e-2 (seen for about one image in four over seeded inputs). The seed
    here is one without such a tie."""
    kw = CONFIGS[config]
    x = _images(seed=13)
    jmodel = jlv.LAUDViT(**GEOM, **kw, linear_impl="int8")
    params = _flax_params(jlv.LAUDViT(**GEOM, **kw), x, seed=13)
    ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, 0.1,
                                            training=False).logits)(
        params, jnp.asarray(x))
    model = tlv.LAUDViT(**GEOM, **kw, linear_impl="int8", img_size=64,
                        device="cpu").eval()
    load_flax_variables(model, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).logits
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    dense = tlv.LAUDViT(**GEOM, **kw, img_size=64, device="cpu").eval()
    load_flax_variables(dense, params)
    with torch.no_grad():
        f = dense(torch.from_numpy(x)).logits
    rel = ((out - f).norm() / f.norm()).item()
    assert 0 < rel < 0.05, rel


def test_unknown_implementations_are_refused():
    for kw in (dict(stem="conv"), dict(attn_impl="flash"),
               dict(linear_impl="fp8")):
        with pytest.raises(ValueError, match="must be"):
            tlv.LAUDViT(**GEOM, img_size=64, device="cpu", **kw)
