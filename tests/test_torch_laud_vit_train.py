"""Port parity for the LAUD-ViT TRAINING forward
(`laudnet_tpu_torch/models/laud_vit.py`, ``training=True``) against flax
``LAUDViT.apply(..., training=True)``, with the weights carried across by
`convert/from_jax.py::load_flax_variables` and policy heads randomised so
that the gates close some decisions.

Both sides run on the same Gumbel noise: the flax model is applied jitted
with ``rngs={'gumbel': key}`` while ``jax.random.gumbel`` is wrapped (in
this process only) so that an ordered ``jax.debug.callback`` records each
draw the compiled function makes, in call order, and the port replays the
record (`ops/gating.py::ReplayNoise`). Nothing in the JAX package changes
for that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu_torch.convert.from_jax import load_flax_variables
from laudnet_tpu_torch.models import laud_vit as tlv
from laudnet_tpu_torch.ops.gating import GumbelNoise, ReplayNoise, binary_gate

torch.set_num_threads(1)
T2T_GEOM = dict(depth=2, dim=192, num_heads=3, mlp_ratio=2.0, num_classes=11,
                stem="t2t")



def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 64, 64, 3)).astype(np.float32)


def _flax_params(model, x, seed):
    # lazy_init: the values of init, without compiling the forward
    v = jax.jit(lambda: model.lazy_init(
        {"params": jax.random.PRNGKey(seed)},
        jax.ShapeDtypeStruct(np.shape(x), jnp.float32), 1.0,
        training=False))()
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


def _record_gumbel(monkeypatch):
    """Wraps ``jax.random.gumbel`` for this test: every array it returns
    is appended, as numpy, to the list this returns, when the (jitted)
    computation draws it; read the list after ``jax.effects_barrier()``."""
    recorded = []
    original = jax.random.gumbel

    def recording(key, shape=(), dtype=float, **kw):
        out = original(key, shape, dtype, **kw)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), out,
                           ordered=True)
        return out

    monkeypatch.setattr(jax.random, "gumbel", recording)
    return recorded


TRAIN_GEOM = dict(depth=2, dim=128, num_heads=2, mlp_ratio=2.0,
                  num_classes=11)
STAT_FIELDS = ("token_density", "head_density", "attn_density",
               "mlp_density", "flops_perc", "flops", "token_keep")


def _train_pair(monkeypatch, kw, x, seed, temperature, jdtype=None,
                geom=TRAIN_GEOM, img_size=32):
    """The flax training forward (jitted, noise recorded) and the port's
    on the recorded noise; returns (flax output, port output, port
    model)."""
    jmodel = jlv.LAUDViT(**geom, **kw, dtype=jdtype)
    params = _flax_params(jlv.LAUDViT(**geom, **kw), x, seed=seed)
    recorded = _record_gumbel(monkeypatch)
    ref = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, temperature, training=True,
        rngs={"gumbel": jax.random.PRNGKey(seed)}))(params, jnp.asarray(x))
    jax.effects_barrier()
    cd = None if jdtype is None else torch.bfloat16
    size = {} if kw.get("stem") == "t2t" else {"img_size": img_size}
    model = tlv.LAUDViT(**geom, **kw, **size, device="cpu", compute_dtype=cd)
    load_flax_variables(model, params)
    noise = ReplayNoise(recorded)
    out = model(torch.from_numpy(x), temperature, training=True, noise=noise)
    gates = 3 - sum(kw.get(k) is False for k in ("token_skip", "head_skip",
                                                 "layer_skip"))
    assert noise.used == len(recorded) == gates * geom["depth"]
    return ref, out, model


@pytest.mark.parametrize("linear_impl", ["dense", "int8_qat"])
@pytest.mark.parametrize("attn_impl", ["reference", "fused"])
def test_training_forward_matches_flax(monkeypatch, attn_impl, linear_impl):
    """``training=True`` under replayed Gumbel noise, f32: logits and every
    statistic to 1e-4 relative (1e-4 of the logits' largest magnitude).
    'fused' runs the JAX kernel in interpret mode and the port's Function
    on its plain versions; 'int8_qat' runs the fake-quant linears on both
    sides (seeds without a rounding tie: see
    `test_int8_linear_eval_matches_flax`)."""
    kw = dict(attn_impl=attn_impl, linear_impl=linear_impl)
    x = _images(seed=21)[:, :32, :32]
    ref, out, model = _train_pair(monkeypatch, kw, x, seed=21,
                                  temperature=1.0)
    rl = np.asarray(ref.logits)
    np.testing.assert_allclose(out.logits.detach().numpy(), rl,
                               atol=1e-4 * np.abs(rl).max(), rtol=0)
    for field in STAT_FIELDS:
        np.testing.assert_allclose(getattr(out, field).detach().numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-4, err_msg=field)
    # Gumbel gates closed some decisions, and the statistics carry the gate
    # gradients: the sparsity loss trains the policy heads through them
    assert out.token_density.min().item() < 1.0
    assert out.flops_perc.min().item() < 1.0
    out.flops.backward(retain_graph=True)
    for head in ("token_policy", "head_policy", "layer_policy"):
        grad = getattr(model.blocks[0], head).weight.grad
        assert grad is not None and grad.abs().sum() > 0, head
    assert model.blocks[-1].qkv.weight.grad is None    # flops: gates only
    out.logits.sum().backward()
    assert model.patch_embed.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("gates,temperature", [
    (dict(), 1.0), (dict(), 5.0), (dict(token_skip=False), 5.0)],
    ids=["all_gates_T1", "all_gates_T5", "head_layer_T5"])
def test_training_gradients_match_flax(monkeypatch, gates, temperature):
    """Gradients of a loss shaped like the trainer's (a function of the
    logits plus block and network FLOPs penalties, so the gates train
    through the statistics) for EVERY parameter leaf, against ``jax.grad``
    of the flax model on the same noise, through the inverse mapping
    `to_flax_tree(grads=True)`: 1e-4 of each leaf's largest gradient."""
    from laudnet_tpu_torch.convert.from_jax import to_flax_tree

    x = _images(seed=21)[:, :32, :32]
    jmodel = jlv.LAUDViT(**TRAIN_GEOM, **gates)
    params = _flax_params(jmodel, x, seed=21)
    recorded = _record_gumbel(monkeypatch)

    def jloss(p):
        o = jmodel.apply({"params": p}, jnp.asarray(x), temperature,
                         training=True,
                         rngs={"gumbel": jax.random.PRNGKey(21)})
        return ((o.logits ** 2).sum()
                + 10 * (jnp.maximum(o.flops_perc - 0.5, 0) ** 2).mean()
                + 10 * (o.flops / 1e6 - 0.5) ** 2)

    ref_loss, ref = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, params))
    jax.effects_barrier()
    model = tlv.LAUDViT(**TRAIN_GEOM, **gates, img_size=32, device="cpu")
    load_flax_variables(model, params)
    o = model(torch.from_numpy(x), temperature, training=True,
              noise=ReplayNoise(recorded))
    loss = ((o.logits ** 2).sum()
            + 10 * ((o.flops_perc - 0.5).clamp_min(0) ** 2).mean()
            + 10 * (o.flops / 1e6 - 0.5) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(
        to_flax_tree(model, grads=True)))
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(got)
    trained = 0
    for path, leaf in leaves:
        leaf = np.asarray(leaf)
        trained += np.abs(leaf).max() > 0
        np.testing.assert_allclose(got[path], leaf, rtol=0,
                                   atol=1e-4 * np.abs(leaf).max() + 1e-9,
                                   err_msg=jax.tree_util.keystr(path))
    # a layer gate closed for both images leaves its branch untrained
    assert trained >= len(leaves) // 2
    for name in ("token_policy", "head_policy", "layer_policy"):
        if name in params["block_0"]:
            assert np.abs(got[tuple(jax.tree_util.DictKey(k) for k in (
                "block_0", name, "kernel"))]).max() > 0, name


def test_training_forward_t2t_matches_flax(monkeypatch):
    """One training case behind the T2T stem (224x224, batch 1, 3 heads, an
    odd count, fused attention); the performers' fixed ``w`` gets no
    gradient. Head and layer gates only: over 196 tokens the token gates'
    straight-through residue differs between the frameworks in some last
    bit, and the key mask amplifies that (see
    `test_straight_through_residue_reaches_the_key_mask`)."""
    kw = dict(stem="t2t", attn_impl="fused", token_skip=False)
    x = _images(seed=23, b=1)[:, :1, :1, :].repeat(224, 1).repeat(224, 2)
    x = x + np.random.default_rng(24).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    geom = dict(T2T_GEOM)
    geom.pop("stem")
    ref, out, model = _train_pair(monkeypatch, kw, x, seed=23,
                                  temperature=0.7, geom=geom)
    rl = np.asarray(ref.logits)
    np.testing.assert_allclose(out.logits.detach().numpy(), rl,
                               atol=1e-4 * np.abs(rl).max(), rtol=0)
    for field in STAT_FIELDS:
        np.testing.assert_allclose(getattr(out, field).detach().numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-4, err_msg=field)
    out.logits.sum().backward()
    assert model.t2t_stem.attn1.w.grad is None
    assert model.t2t_stem.attn1.kqv.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("attn_impl", ["reference", "fused"])
def test_training_forward_bf16_compute_matches_flax(monkeypatch, attn_impl):
    """Mixed precision (flax ``dtype=bfloat16``, the port's
    ``compute_dtype``): f32 masters, bf16 products and residual stream,
    f32 policy heads. The gates see the same f32-promoted inputs up to
    bf16 rounding differences of the stream, so with this seed every
    decision agrees and the statistics match to 1e-4; the bf16 logits are
    held to 4 bf16 ulps of their largest magnitude (the frameworks round
    the products' bias adds and the attention at different points)."""
    kw = dict(attn_impl=attn_impl)
    x = _images(seed=25)[:, :32, :32]
    ref, out, model = _train_pair(monkeypatch, kw, x, seed=25,
                                  temperature=1.0, jdtype=jnp.bfloat16)
    assert out.logits.dtype == torch.bfloat16
    assert model.head.weight.dtype == torch.float32
    rl = np.asarray(ref.logits.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(rl).max())) - 7)
    np.testing.assert_allclose(out.logits.detach().float().numpy(), rl,
                               atol=4 * ulp, rtol=0)
    for field in STAT_FIELDS:
        got = getattr(out, field)
        assert got.dtype == torch.float32, field
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-4, err_msg=field)
    out.logits.float().sum().backward()
    assert model.blocks[0].qkv.weight.grad.dtype == torch.float32


def test_straight_through_residue_reaches_the_key_mask():
    """A property of the JAX package's training forward that the port
    keeps, formula for formula: the hard gate is ``y_hard + y_soft -
    stop_gradient(y_soft)``, which in f32 is 1 - 2^-24 for about a quarter
    of the kept tokens, and the additive key mask ``(1 - mask) * -1e9``
    turns that into a score offset of -59.6: such a key is kept as a token
    and all but removed as a key. Both frameworks do this alike; which
    tokens it hits depends on the last bit of the soft sample, which is why
    the parity tests above run at few tokens."""
    g = GumbelNoise.seeded(0)
    logits = torch.zeros(4, 64, 2, 1)
    logits[:, :, 0] = 3.0                                 # keep-logit high
    mask = binary_gate(logits, 1.0, training=True, noise=g)[..., 0]
    kept = mask[mask > 0.5]
    off = (kept != 1.0).float().mean().item()
    assert 0.05 < off < 0.6, off
    assert (kept - 1.0).abs().max().item() <= 2.0 ** -23
    offsets = (1.0 - kept) * -1e9
    assert offsets.min().item() == pytest.approx(-59.6, abs=0.1)


