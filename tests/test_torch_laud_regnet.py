"""Port parity for LAUD-RegNet (`laudnet_tpu_torch/models/laud_regnet.py`)
against flax ``LAUDRegNet``, variables through `load_flax_variables`.

The recipes: `regnet_params` of all 15 published configurations gives the
JAX function's widths, depths and group widths (numpy on both sides, so
exactly). The model: a small RegNetY (depths 1-1-1-1, widths 16-32-48-64,
group width 8, SE 0.25, 32x32 input) in two configurations whose stages
between them run every ``dyn_mode`` (and ``none``) under both channel
maskers, MLPs of one and two layers and a spatial mask of two groups. Each
costs one XLA compilation per forward kind, so each carries as much as it
can. The maskers' biases are zeroed and the BatchNorms moved off identity,
so the gates close about half their decisions.

f32: logits atol 1e-4 (convolutions sum in another order than XLA's); the
gates decide on logits ~1e-6 apart and at these seeds none sits that close
to a tie, so every eval mask is equal; the densities, ``flops_perc`` and
``flops`` agree to rtol 1e-6 (means of 0/1 values summed in another
order). Training: one Gumbel forward on the same noise (numpy draws
replacing ``jax.random.gumbel``, replayed through `ReplayNoise`); the
straight-through masks carry the soft values' residue, so they agree to
1e-6 and their hard decisions exactly. bf16 rounds after every convolution
and BatchNorm on both sides: the logits agree to a few bf16 ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import laud_regnet as jrg
from laudnet_tpu.models import maskers as jmk
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.models import laud_regnet as trg
from laudnet_tpu_torch.models import maskers as tmk
from laudnet_tpu_torch.ops.gating import ReplayNoise

torch.set_num_threads(1)
PARAMS = dict(depths=(1, 1, 1, 1), widths=(16, 32, 48, 64),
              group_widths=(8, 8, 8, 8),
              bottleneck_multipliers=(1.0, 1.0, 1.0, 1.0), se_ratio=0.25)
BASE = dict(num_classes=10, input_size=32, reduction_ratio=(4, 4, 4, 4))
CONFIGS = {
    "modes_a": dict(dyn_mode=("channel", "spatial", "both", "both"),
                    channel_masker=("MLP", "MLP", "conv_linear", "MLP"),
                    channel_masker_layers=(1, 1, 1, 2),
                    mask_spatial_granularity=(2, 2, 1, 1),
                    channel_dyn_granularity=(2, 1, 2, 1)),
    "modes_b": dict(dyn_mode=("both", "channel", "spatial", "none"),
                    channel_masker=("conv_linear", "conv_linear", "MLP",
                                    "MLP"),
                    channel_masker_layers=(2, 2, 1, 1),
                    mask_spatial_granularity=(4, 1, 2, 1),
                    channel_dyn_granularity=(1, 2, 1, 1),
                    spatial_mask_channel_group=(2, 1, 1, 1)),
}
FIELDS = ("spatial_s3", "spatial_s2", "spatial_s1", "channel_s",
          "spatial_s3_img")
MASKERS = (jmk.SpatialMasker, jmk.ChannelMaskerMLP,
           jmk.ChannelMaskerConvLinear)


def _kw(config):
    return dict(BASE, **CONFIGS[config])


def _variables(kw, seed):
    """Flax variables as numpy, drawn by the port's initialiser and carried
    over by the inverse mapping; masker biases zeroed, BatchNorms off
    identity."""
    donor = trg.LAUDRegNet(trg.RegNetParams(**PARAMS), **kw, device="cpu",
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


def _pair(config, seed, compute_dtype=None):
    kw = _kw(config)
    jmodel = jrg.LAUDRegNet(params_cfg=jrg.RegNetParams(**PARAMS),
                            dtype=None if compute_dtype is None
                            else jnp.bfloat16, **kw)
    v = _variables(kw, seed)
    model = trg.LAUDRegNet(trg.RegNetParams(**PARAMS), **kw, device="cpu",
                           compute_dtype=compute_dtype)
    load_flax_variables(model, v)
    x = np.random.default_rng(seed).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    return jmodel, v, model, x


def _port_masks(model):
    """Forward hooks recording every masker's mask, in call order."""
    masks = []
    for m in model.modules():
        if isinstance(m, (tmk.SpatialMasker, tmk.ChannelMaskerMLP,
                          tmk.ChannelMaskerConvLinear)):
            m.register_forward_hook(lambda mod, a, out: masks.append(out[0]))
    return masks


def _jax_masks(state):
    """The maskers' masks from flax's captured intermediates, in the order
    the blocks call them (channel before spatial)."""
    found = []

    def walk(tree, path):
        for k, sub in tree.items():
            if k == "__call__":
                found.append((path, sub[0][0]))
            elif isinstance(sub, dict):
                walk(sub, path + (k,))
    walk(state["intermediates"], ())
    order = {"masker_channel": 0, "masker_spatial": 1}
    found.sort(key=lambda pm: (pm[0][0], order[pm[0][1]]))
    return [np.asarray(m) for _, m in found]


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
    np.testing.assert_allclose(float(out.flops.detach()), float(ref.flops),
                               rtol=1e-6)


@pytest.mark.parametrize("key", sorted(jrg._REGNET_CFGS))
def test_regnet_params_match_jax(key):
    cfg = jrg._REGNET_CFGS[key]
    assert trg._REGNET_CFGS[key] == cfg
    want, got = jrg.regnet_params(**cfg), trg.regnet_params(**cfg)
    for field in ("depths", "widths", "group_widths",
                  "bottleneck_multipliers", "se_ratio"):
        assert getattr(got, field) == getattr(want, field), field
    ctor = getattr(trg, f"lad_regnet_{key}")
    model = ctor(device="meta")
    assert [len(st) for st in model.stages()] == list(want.depths)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_eval_matches_flax(config):
    jmodel, v, model, x = _pair(config, seed=len(config))
    ref, state = jax.jit(lambda v, x: jmodel.apply(
        v, x, 0.1, training=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, MASKERS)))(
        v, jnp.asarray(x))
    masks = _port_masks(model)
    with torch.no_grad():
        out = model(torch.from_numpy(x), 0.1)
    _compare(out, ref, logits_atol=1e-4)
    want = _jax_masks(state)
    assert len(masks) == len(want) > 0
    for got, w in zip(masks, want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert 0.05 < float(out.flops_perc.mean()) < 0.98


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_gumbel_training_forward_matches_flax(config, monkeypatch):
    jmodel, v, model, x = _pair(config, seed=3)
    recorded = []
    noise_rng = np.random.default_rng(11)

    def numpy_gumbel(key, shape=(), dtype=float, **kw):
        recorded.append(noise_rng.gumbel(size=shape).astype(np.float32))
        return jnp.asarray(recorded[-1])

    monkeypatch.setattr(jax.random, "gumbel", numpy_gumbel)
    ref, state = jax.jit(lambda v, x: jmodel.apply(
        v, x, 2.0, training=True, rngs={"gumbel": jax.random.PRNGKey(0)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, MASKERS)))(
        v, jnp.asarray(x))
    monkeypatch.undo()
    masks = _port_masks(model)
    noise = ReplayNoise(recorded)
    out = model(torch.from_numpy(x), 2.0, training=True, noise=noise)
    assert noise.used == len(recorded) > 0
    _compare(out, ref, logits_atol=1e-4)
    want = _jax_masks(state)
    assert len(masks) == len(want)
    for got, w in zip(masks, want):
        np.testing.assert_allclose(got.detach().numpy(), w, atol=1e-6)
        np.testing.assert_array_equal(got.detach().numpy() > 0.5, w > 0.5)
    # the batch statistics moved as flax moved them
    stats = to_flax_batch_stats(model)
    for blk, sub in state["batch_stats"].items():
        for bn, leaves in sub.items():
            if "mean" not in leaves:
                continue
            for k in ("mean", "var"):
                np.testing.assert_allclose(stats[blk][bn][k],
                                           np.asarray(leaves[k]),
                                           rtol=1e-4, atol=1e-6)


def test_bf16_forward_matches_flax():
    jmodel, v, model, x = _pair("modes_a", seed=1,
                                compute_dtype=torch.bfloat16)
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, 0.1, training=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x), 0.1)
    assert out.logits.dtype == torch.bfloat16
    assert ref.logits.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.isfinite(out.logits.float()).all()
    _compare(out, ref, logits_atol=3e-2)


def test_converter_round_trip_and_static_teacher():
    """``to_flax_tree`` gives the flax tree's own names and shapes (the
    grouped 3x3 kernels (kh, kw, in/g, out), the SE's biases), and
    `load_flax_variables` puts every leaf back; the static teacher's
    in-graph FLOPs are its dense count, SE included."""
    kw = _kw("modes_a")
    donor = trg.LAUDRegNet(trg.RegNetParams(**PARAMS), **kw, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tree = to_flax_tree(donor)
    jmodel = jrg.LAUDRegNet(params_cfg=jrg.RegNetParams(**PARAMS), **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)), 1.0,
        training=False))
    flat = lambda t: {"/".join(str(k.key) for k in path): leaf.shape
                      for path, leaf in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(tree) == flat(shapes["params"])
    assert flat(to_flax_batch_stats(donor)) == flat(shapes["batch_stats"])
    assert tree["stage2_0"]["b_conv"]["kernel"].shape == (3, 3, 8, 32)
    assert set(tree["stage1_0"]["se"]["fc1"]) == {"kernel", "bias"}
    back = trg.LAUDRegNet(trg.RegNetParams(**PARAMS), **kw, device="cpu")
    load_flax_variables(back, {"params": tree,
                               "batch_stats": to_flax_batch_stats(donor)})
    for (name, a), (_, b) in zip(donor.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name

    static = trg.regnet_static("y_400mf", num_classes=10, input_size=32,
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
    jstatic = jrg.regnet_static("y_400mf", num_classes=10, input_size=32)
    sv = {"params": to_flax_tree(static),
          "batch_stats": to_flax_batch_stats(static)}
    jflops = jax.jit(lambda v: jstatic.apply(
        v, jnp.zeros((1, 32, 32, 3)), 1.0, training=False).flops)(sv)
    with torch.no_grad():
        out = static(torch.zeros(1, 32, 32, 3))
    assert float(out.flops) == pytest.approx(float(jflops), rel=1e-6)
    assert torch.equal(out.flops_perc, torch.ones_like(out.flops_perc))
