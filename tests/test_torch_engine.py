"""The port's `ServingEngine` (`laudnet_tpu_torch/infer/engine.py`) against
the JAX package's, each priced by the same latency model: the JAX
package's v5e `TPUPredictor` (the port's engine through `V5eAdapter`, the
interface `sim/plan.py` reads). On the CPU neither engine uses the block
kernels, so both serve their models' own graphs. Same weights (drawn by the
port's initialiser, carried to flax), same calibration batches: the plans
must be the same decisions (mode, capacities, ranking keys, ``exact``,
``served``, ``fast_math``; latencies to rtol 1e-6, since the measured
activation rate is an f32 mean on each side) and the served logits agree
to atol 1e-4 (f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.infer import ServingEngine as JEngine
from laudnet_tpu.models import laud_resnet as jlr
from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu.sim import plan as jplan
from laudnet_tpu.sim.hardware import TPU_PRESETS
from laudnet_tpu.sim.tpu import (TPUPredictor, tpu_predict_network,
                                 tpu_predict_vit, tpu_static_block)
from laudnet_tpu_torch.convert.from_jax import (to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.infer.engine import ServingEngine, configured
from laudnet_tpu_torch.models import laud_resnet as tlr
from laudnet_tpu_torch.models import laud_vit as tlv
from laudnet_tpu_torch.sim.h100 import H100Predictor

torch.set_num_threads(1)


class V5eAdapter:
    """The JAX package's v5e latency model behind the port's predictor
    interface (as in `tests/test_torch_sim.py`)."""

    def __init__(self, batch_size=128):
        self.p = TPUPredictor(TPU_PRESETS["v5e"].with_batch(batch_size))
        self.launch_cost = self.p.spec.fusion_overhead
        self.s8_conv_mult = jplan._S8_CONV_MULT
        self.s8_export_derate = jplan._S8_EXPORT_DERATE

    def predict_vit(self, attention_f32=False, **kw):
        # the v5e model has one attention kernel for either dtype
        return tpu_predict_vit(self.p, **kw)

    def predict_network(self, model, mode, rates, grans):
        # the JAX planner prices a uniform paradigm's dense-masked form by
        # 'channel' whatever the paradigm; the port asks for the
        # paradigm's own masked form (sim/plan.py)
        if mode in ("spatial_masked", "both_masked"):
            mode = "channel"
        return tpu_predict_network(self.p, model, mode, rates, grans)

    def static_block(self, geom):
        return tpu_static_block(self.p, geom)


def assert_same_plan(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in ("ranking", "predicted_latency", "dense_latency",
                "predicted_speedup", "fidelity"):
        a, b = g.pop(key), w.pop(key)
        if b is None:
            assert a is None
        elif isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6)
    assert g == w


VIT = dict(depth=3, dim=64, num_heads=4, mlp_ratio=2.0, patch_size=8,
           num_classes=10, head_skip=False, layer_skip=False)


@pytest.fixture(scope="module")
def vit():
    model = tlv.LAUDViT(**VIT, img_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    return model, x


@pytest.mark.parametrize("closed", [True, False])
def test_vit_engine_matches_jax(vit, closed):
    """``closed``: the token policies' biases shut half the tokens (the
    plan selects); else the gates stay open (no-selection plan)."""
    donor, x = vit
    bias = torch.tensor([0.0, 1.5 if closed else -5.0])
    model = tlv.LAUDViT(**VIT, img_size=32, device="cpu").eval()
    model.load_state_dict(donor.state_dict())
    with torch.no_grad():
        for blk in model.blocks:
            blk.token_policy.bias.copy_(bias)
    params = to_flax_tree(model)
    jm = jlv.LAUDViT(**VIT)
    want_engine = JEngine(jm, {"params": params}, batch_size=128)
    want = want_engine.calibrate([jnp.asarray(x)], quantile=1.0, margin=1e-6)
    engine = ServingEngine(model, batch_size=128, predictor=V5eAdapter())
    got = engine.calibrate([torch.from_numpy(x)], quantile=1.0, margin=1e-6)
    assert_same_plan(got, want)
    assert got.served == got.mode == ("token" if closed else "dense-masked")
    np.testing.assert_allclose(engine(torch.from_numpy(x)).numpy(),
                               np.asarray(want_engine(jnp.asarray(x))),
                               atol=1e-4)


RESNET = dict(layers=(3, 4, 6, 3), num_classes=10, input_size=64,
              width_mult=0.25, dyn_mode=("channel",) * 4,
              channel_dyn_granularity=(2, 2, 2, 2),
              channel_masker=("MLP",) * 4, channel_masker_layers=(2,) * 4)


@pytest.fixture(scope="module")
def resnet():
    """An input-dependent ~50% channel policy: masker output biases zeroed,
    their final kernels scaled (the JAX test's scheme)."""
    model = tlr.LAUDResNet(**RESNET, device="cpu",
                           generator=torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        for names in model.block_names:
            for n in names:
                fc2 = getattr(model, n).masker_channel.fc2
                fc2.weight.mul_(30.0)
                fc2.bias.zero_()
    variables = {"params": to_flax_tree(model),
                 "batch_stats": to_flax_batch_stats(model)}
    x = np.random.default_rng(0).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    return model, variables, x


class _JittedLAUDResNet(jlr.LAUDResNet):
    """The JAX model with its ``apply`` jitted (once per argument
    structure): the JAX engine's calibration calls it eagerly, op by op,
    which costs a compile per operation on the CPU."""

    def apply(self, variables, *args, **kwargs):
        fn = _JITTED_APPLY.setdefault(self, jax.jit(
            super().apply, static_argnames=("training", "method",
                                            "capture_intermediates")))
        return fn(variables, *args, **kwargs)


_JITTED_APPLY = {}


def test_resnet_engine_static_export_matches_jax(resnet, monkeypatch):
    from laudnet_tpu.infer import export_pruned as jex

    build = jex.export_pruned_resnet

    def traced_export(variables, masks, **kw):
        # the export's weight folding inside the forward the engine jits:
        # built eagerly, it compiles operation by operation on the CPU
        return lambda x: build(variables, masks, **kw)(x)

    monkeypatch.setattr(jex, "export_pruned_resnet", traced_export)
    model, variables, x = resnet
    want_engine = JEngine(_JittedLAUDResNet(**RESNET), variables)
    want = want_engine.calibrate([jnp.asarray(x)], allow_static_export=True,
                                 fidelity_threshold=0.5)
    engine = ServingEngine(model, predictor=V5eAdapter())
    got = engine.calibrate([torch.from_numpy(x)], allow_static_export=True,
                           fidelity_threshold=0.5)
    assert_same_plan(got, want)
    assert got.served == got.mode == "static-export" and not got.exact
    assert 0.5 <= got.fidelity["mean_agreement"] < 1.0
    np.testing.assert_allclose(engine(torch.from_numpy(x)).numpy(),
                               np.asarray(want_engine(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)


def test_resnet_fidelity_gate_demotes(resnet):
    model, _, x = resnet
    xt = torch.from_numpy(x)
    engine = ServingEngine(model, predictor=V5eAdapter())
    plan = engine.calibrate([xt], allow_static_export=True,
                            fidelity_threshold=1.01)
    assert plan.mode == plan.served == "dense-masked" and plan.exact
    assert "rejected" in plan.notes and "static-export" in plan.ranking
    assert plan.predicted_latency == plan.ranking["dense-masked"]
    with torch.no_grad():
        ref = model(xt, 0.1).logits
    np.testing.assert_allclose(engine(xt).numpy(), ref.numpy(), atol=1e-5)


def test_resnet_engine_int8_and_spatial_capacity(resnet):
    """The CNN forms the H100 plan ranks, built from configured copies
    that share the model's weights: W8A8 (`conv_impl='int8'`) and spatial
    capacity (`execution='sparse'`)."""
    model, _, x = resnet
    xt = torch.from_numpy(x)
    q = configured(model, conv_impl="int8")
    assert q.layer1_0.conv2.weight is model.layer1_0.conv2.weight
    assert model.conv_impl == "dense" and q.conv_impl == "int8"
    engine = ServingEngine(model, predictor=V5eAdapter())
    plan = engine.calibrate([xt], allow_int8=True)
    assert plan.served == plan.mode == "dense-masked-int8" and not plan.exact
    with torch.no_grad():
        np.testing.assert_allclose(engine(xt).numpy(),
                                   q(xt, 0.1).logits.numpy())
    spatial = tlr.LAUDResNet(**dict(RESNET, dyn_mode=("spatial",) * 4,
                                    mask_spatial_granularity=(4, 4, 2, 1)),
                             device="cpu",
                             generator=torch.Generator().manual_seed(2))
    sp = configured(spatial.eval(), execution="sparse",
                    patch_capacity=(1.0,) * 4)
    assert spatial.layer1_1.execution == "dense"
    with torch.no_grad():
        np.testing.assert_allclose(sp(xt, 0.1).logits.numpy(),
                                   spatial(xt, 0.1).logits.numpy(),
                                   atol=1e-4)


@pytest.mark.parametrize("compute_dtype, f32", [
    (None, True), (torch.float32, True), (torch.bfloat16, False)])
def test_engine_prices_b4_in_the_graphs_dtype(vit, monkeypatch,
                                              compute_dtype, f32):
    """On a card an f32 ViT serves its own graph with B4 (the block engine
    takes bf16 parameters), in the dtype that graph computes in; the plan
    asks the predictor, injected or not, for that kernel."""
    donor, x = vit
    model = tlv.LAUDViT(**VIT, img_size=32, device="cpu",
                        compute_dtype=compute_dtype).eval()
    model.load_state_dict(donor.state_dict())
    monkeypatch.setattr(ServingEngine, "_on_card", lambda self, m: True)
    seen = []

    class Spy(H100Predictor):
        def predict_vit(self, **kw):
            seen.append((kw["fused_attention"], kw["attention_f32"]))
            return super().predict_vit(**kw)

    engine = ServingEngine(model, batch_size=128, predictor=Spy())
    engine.calibrate([torch.from_numpy(x)], quantile=1.0, margin=1e-6)
    assert seen and set(seen) == {(True, f32)}


def test_engine_refuses_a_mesh(vit):
    """``mesh=`` takes a ``DeviceMesh`` (`parallel/mesh.py::make_mesh`; the
    engine serving over one is `tests/test_torch_parallel.py::
    test_serving_engine_mesh_serves_the_first_rank_s_weights`); anything
    else is refused before a collective is tried."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServingEngine(vit[0], mesh=object())


def test_regnet_serves_dense_masked_with_the_no_ranking_plan():
    """A LAUD-RegNet (no ``.layers``, no analytic geometry for its widths)
    gets JAX's honest no-ranking plan and serves its own dense-masked
    graph (`tests/test_engine.py::test_serving_engine_regnet_no_ranking_
    plan`): the same plan on both sides, the same logits."""
    from laudnet_tpu.models import laud_regnet as jrg
    from laudnet_tpu_torch.models import laud_regnet as trg

    kw = dict(num_classes=10, dyn_mode=("channel", "channel"),
              spatial_mask_channel_group=(1, 1),
              mask_spatial_granularity=(1, 1), channel_dyn_granularity=(1, 1),
              channel_masker=("MLP", "MLP"), channel_masker_layers=(1, 1),
              reduction_ratio=(16, 16))
    p = dict(depths=(1, 1), widths=(24, 56), group_widths=(8, 8),
             bottleneck_multipliers=(1.0, 1.0), se_ratio=0.25)
    model = trg.LAUDRegNet(trg.RegNetParams(**p), **kw, device="cpu",
                           generator=torch.Generator().manual_seed(1)).eval()
    v = {"params": to_flax_tree(model),
         "batch_stats": to_flax_batch_stats(model)}
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    jengine = JEngine(jrg.LAUDRegNet(params_cfg=jrg.RegNetParams(**p), **kw),
                      v)
    want = jengine.calibrate([jnp.asarray(x)])
    engine = ServingEngine(model)
    got = engine.calibrate([torch.from_numpy(x)])
    assert got.served == got.mode == "dense-masked" and got.ranking == {}
    assert_same_plan(got, want)
    out = engine(torch.from_numpy(x))
    assert out.shape == (1, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(jengine(x)),
                               atol=1e-4)
