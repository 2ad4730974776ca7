"""The port's GPU roofline simulator (`laudnet_tpu_torch/sim/roofline.py`,
`dynamic.py`, `transformer.py`, `adavit.py`, `models.predict_network` and
`cli.py`) against the JAX package's on the same inputs, on each of the five
GPU presets: the same block reports (latency, compute and memory terms,
float for float: the arithmetic is the same Python) and the same CLI
output, character for character.

The simulator searches every tile configuration of every operator, so a
whole network takes seconds a preset on each side. The tests cut the
geometry, not the arithmetic: two blocks of ResNet-50 (the first, with its
strided projection, and a stride-1 one) and RegNetY-400MF's first block
(grouped 3x3, SE) stand in for the networks, and T2T-ViT runs one layer at
batch 8, each through the same functions and the same CLI paths. The
convolution search, a pure function of the spec and the shape, is memoised
on both sides alike (`memo_conv`), so the CLI's five ViT rows search the
T2T stem they share once."""

import contextlib
import io

import pytest

from laudnet_tpu.sim import cli as jcli
from laudnet_tpu.sim import hardware as jhw
from laudnet_tpu.sim import models as jmodels
from laudnet_tpu.sim import roofline as jroofline
from laudnet_tpu.sim.adavit import simulate_laud_t2t_vit as jsim_vit
from laudnet_tpu.sim.dynamic import DynamicPredictor as JPredictor
from laudnet_tpu.sim.transformer import TransformerPredictor as JTransformer
from laudnet_tpu_torch.sim import cli as tcli
from laudnet_tpu_torch.sim import hardware as thw
from laudnet_tpu_torch.sim import models as tmodels
from laudnet_tpu_torch.sim import roofline as troofline
from laudnet_tpu_torch.sim.adavit import simulate_laud_t2t_vit as tsim_vit
from laudnet_tpu_torch.sim.dynamic import DynamicPredictor as TPredictor
from laudnet_tpu_torch.sim.transformer import TransformerPredictor as TTrans

PRESETS = sorted(jhw.GPU_PRESETS)


def _same(got, want):
    assert (got.latency, got.compute_latency, got.memory_latency) == (
        want.latency, want.compute_latency, want.memory_latency)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture
def memo_conv(monkeypatch):
    """`Predictor.conv` of both packages, each behind its own cache keyed
    by (spec, arguments): the same inputs get back the report computed
    for them, which no caller mutates."""
    for cls in (jroofline.Predictor, troofline.Predictor):
        cache = {}

        def conv(self, *args, _conv=cls.conv, _cache=cache, **kw):
            key = (self.spec, args, tuple(sorted(kw.items())))
            if key not in _cache:
                _cache[key] = _conv(self, *args, **kw)
            return _cache[key]
        monkeypatch.setattr(cls, "conv", conv)


@pytest.fixture
def short_geometry(monkeypatch):
    """Both packages' ResNet-50 cut to two blocks and T2T-ViT to one
    layer (the geometry tables are module dicts: patched in place)."""
    r50 = jmodels.MODEL_GEOMETRY["resnet50"]
    for mod in (jmodels, tmodels):
        monkeypatch.setitem(mod.MODEL_GEOMETRY, "resnet50",
                            [r50[0], r50[1]])
    for mod in (jcli, tcli):
        monkeypatch.setitem(mod.VIT_GEOMETRY, "t2t_vit",
                            dict(mod.VIT_GEOMETRY["t2t_vit"], depth=1))


def test_presets_and_geometry_are_the_jax_packages():
    assert thw.GPU_PRESETS == {k: thw.DeviceSpec(**vars(v))
                               for k, v in jhw.GPU_PRESETS.items()}
    assert {k: [vars(g) for g in v]
            for k, v in tmodels.MODEL_GEOMETRY.items()} == {
        k: [vars(g) for g in v] for k, v in jmodels.MODEL_GEOMETRY.items()}


@pytest.mark.parametrize("preset", PRESETS)
def test_predictions_and_cli_match_jax(preset, short_geometry, memo_conv):
    jspec = jhw.GPU_PRESETS[preset]
    tspec = thw.GPU_PRESETS[preset]
    jp, tp = JPredictor(jspec), TPredictor(tspec)

    # the four block forms of RegNetY-400MF's first block (SE, groups)
    g = jmodels.MODEL_GEOMETRY["regnety_400mf"][0]
    tg = tmodels.BlockGeom(**vars(g))
    for jf, tf, args in (
            (jmodels.static_block_latency, tmodels.static_block_latency, ()),
            (jmodels.spatial_block_latency, tmodels.spatial_block_latency,
             (2, 0.4)),
            (jmodels.channel_block_latency, tmodels.channel_block_latency,
             (2, 0.6)),
            (jmodels.layer_block_latency, tmodels.layer_block_latency,
             (0.5,))):
        _same(tf(tp, tg, *args), jf(jp, g, *args))

    # the network sweep, on the cut ResNet-50, by the function and the CLI
    _same(tmodels.predict_network(tp, "resnet50", "spatial", [0.5, 0.5],
                                  [4, 4]),
          jmodels.predict_network(jp, "resnet50", "spatial", [0.5, 0.5],
                                  [4, 4]))
    argv = ["resnet50", "--hardware", preset, "--act-rate", "0.5"]
    got = _stdout(tcli.main, argv)
    assert got == _stdout(jcli.main, argv)
    assert got.count("ms/batch") == 4

    # the T2T-ViT paradigm sweep through the CLI, then its s+c+l row
    # float for float (the operators' searches already memoised)
    argv = ["t2t_vit", "--hardware", preset, "--act-rate", "0.5",
            "--batch-size", "8"]
    got = _stdout(tcli.main, argv)
    assert got == _stdout(jcli.main, argv) and got.count("ms/batch") == 5
    jt, tt = JTransformer(jspec.with_batch(1)), TTrans(tspec.with_batch(1))
    kw = dict(B=8, depth=1, dim=448, head_num=7, mlp_ratio=3.0,
              token_density=0.5, head_density=0.5, layer_density=0.5)
    _same(tsim_vit(tt, **kw), jsim_vit(jt, **kw))


@pytest.mark.parametrize("argv, message", [
    (["resnet50", "--hardware", "v5e"], "TPU engine"),
    (["resnet50", "--mode", "pallas"], "TPU engine"),
    (["resnet50", "--mode", "channel_gather"], "TPU engine"),
    (["resnet50", "--mode", "spatial-channel-layer-layer"],
     "TPU hardware models only"),
    (["resnet50", "--plan", "1,0.5"], "ViT models")])
def test_cli_refuses_the_tpu_engines(argv, message):
    with pytest.raises(SystemExit, match=message):
        tcli.main(argv)


def test_cli_plan_prices_on_the_h100_model():
    from laudnet_tpu_torch.sim.plan import plan_vit_serving

    keeps = [1.0] * 3 + [0.7] * 4 + [0.5] * 5
    out = _stdout(tcli.main, ["deit_small", "--plan",
                              ",".join(map(str, keeps))])
    want = plan_vit_serving(keeps, spec="h100", batch_size=128,
                            fused_block=True)
    assert "(h100)" in out and f"mode     : {want.mode}\n" in out
    assert f"speedup  : {want.predicted_speedup:.3f}x" in out
