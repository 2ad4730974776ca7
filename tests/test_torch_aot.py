"""Serving artifacts through `torch.export` (`laudnet_tpu_torch/infer/
aot.py`) on the CPU, against the live models and against the JAX
package's StableHLO artifact of the same weights (`tests/test_aot.py`).

On the CPU every kernel wrapper runs its plain version, so a round trip
alone would pass with no op registered at all: each test also holds the
exported graph to the registered ``laudnet::*`` op nodes the live path
calls (B4 in `LAUDViT(attn_impl='fused')`, B1 in the dense block engine, B2
in the engine with selection, B6 in the int8 engine). The loaded program
runs the same CPU implementations on the same weights: its logits equal
the live model's bit for bit. Against JAX (f32, XLA's summation order):
atol 1e-5, the JAX round trip's own bound."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.infer.aot import load_serving_artifact as jload
from laudnet_tpu.infer.aot import save_serving_artifact as jsave
from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu_torch.convert.from_jax import to_flax_tree
from laudnet_tpu_torch.infer import aot
from laudnet_tpu_torch.infer.fused_vit import build_fused_vit
from laudnet_tpu_torch.models import laud_vit as tlv

torch.set_num_threads(1)
VIT = dict(depth=2, dim=64, num_heads=4, mlp_ratio=2.0, patch_size=8,
           num_classes=10, head_skip=False, layer_skip=False)


def _ops(blob):
    """The ``laudnet::*`` ops a serialised program calls, with counts."""
    program = torch.export.load(io.BytesIO(blob))
    names = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "laudnet."):
            key = str(node.target).split(".")[1]
            names[key] = names.get(key, 0) + 1
    return names


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_roundtrip_tiny_vit_equals_the_model_and_jax(tmp_path):
    model = tlv.LAUDViT(**VIT, token_capacity=(1.0, 0.5), attn_impl="fused",
                        img_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(1)).eval()
    x = _images((2, 32, 32, 3))
    path = aot.save_serving_artifact(str(tmp_path / "vit"), model,
                                     (2, 32, 32, 3), metadata={"note": "t"})
    assert path.endswith(".pt2")
    meta = json.load(open(tmp_path / "vit.json"))
    assert meta == {"batch_shape": [2, 32, 32, 3], "dtype": "float32",
                    "temperature": 0.1, "model": "LAUDViT", "note": "t"}
    assert _ops(open(path, "rb").read()) == {"vit_attention": 2}

    serve = aot.load_serving_artifact(str(tmp_path / "vit"))  # no suffix
    got = serve(torch.from_numpy(x))
    with torch.no_grad():
        want = model(torch.from_numpy(x), 0.1).logits
    assert torch.equal(got, want)

    # the JAX package's artifact of the same weights
    jmodel = jlv.LAUDViT(**VIT, token_capacity=(1.0, 0.5))
    jpath = jsave(str(tmp_path / "jvit"), jmodel,
                  {"params": to_flax_tree(model)}, (2, 32, 32, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(jload(jpath)(
        jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("engine", ["dense", "select", "int8"])
def test_block_engines_export_their_kernel_ops(engine):
    """The block engine as the serving engine builds it: one B1 a layer
    (dense), B2 segments between gathers (selection), one B6 a layer
    (int8); a wrong batch shape is refused by the program."""
    model = tlv.LAUDViT(depth=2, dim=128, num_heads=2, mlp_ratio=2.0,
                        patch_size=8, num_classes=11, head_skip=False,
                        layer_skip=False, token_skip=engine == "select",
                        img_size=32, device="cpu",
                        generator=torch.Generator().manual_seed(2)).eval()
    kw = {"dense": {}, "select": dict(token_capacity=(1.0, 0.5)),
          "int8": dict(int8=True)}[engine]
    fwd = build_fused_vit(model, **kw)
    blob = aot.export_serving_fn(fwd, (2, 32, 32, 3), device="cpu")
    want_ops = {"dense": {"vit_block": 2}, "select": {"vit_segment": 2},
                "int8": {"vit_block_int8": 2}}[engine]
    assert _ops(blob) == want_ops
    served = torch.export.load(io.BytesIO(blob)).module()
    x = torch.from_numpy(_images((2, 32, 32, 3), seed=3))
    assert torch.equal(served(x), fwd(x))
    with pytest.raises(Exception):
        served(torch.zeros(3, 32, 32, 3))


def test_export_rejects_wrong_shape(tmp_path):
    blob = aot.export_serving_fn(lambda x: x * 2.0, (4, 3), device="cpu")
    path = tmp_path / "double.pt2"
    path.write_bytes(blob)
    serve = aot.load_serving_artifact(str(path))
    assert torch.equal(serve(torch.ones(4, 3)), torch.full((4, 3), 2.0))
    with pytest.raises(Exception):
        serve(torch.ones(5, 3))   # fixed geometry is the artifact contract


def test_regnet_roundtrip_in_bf16(tmp_path):
    """A LAUD-RegNet with bf16 compute and f32 masters, as the engine
    serves it: no kernel op on its path, the same logits from the program;
    the sidecar names the model."""
    from laudnet_tpu_torch.models import laud_regnet as trg

    model = trg.LAUDRegNet(
        trg.RegNetParams(depths=(1, 1), widths=(16, 32), group_widths=(8, 8),
                         bottleneck_multipliers=(1.0, 1.0), se_ratio=0.25),
        num_classes=10, input_size=32, dyn_mode=("channel", "both"),
        channel_dyn_granularity=(2, 1), mask_spatial_granularity=(2, 2),
        compute_dtype=torch.bfloat16, device="cpu",
        generator=torch.Generator().manual_seed(4)).eval()
    path = aot.save_serving_artifact(str(tmp_path / "regnet.pt2")[:-4],
                                     model, (2, 32, 32, 3))
    assert json.load(open(tmp_path / "regnet.json"))["model"] == "LAUDRegNet"
    assert _ops(open(path, "rb").read()) == {}
    x = torch.from_numpy(_images((2, 32, 32, 3), seed=5))
    got = aot.load_serving_artifact(path)(x)
    with torch.no_grad():
        want = model(x, 0.1).logits
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def _op_cases():
    """Each registered op at a small shape, on CPU tensors (where it runs
    its plain version)."""
    from laudnet_tpu_torch.ops import vit_block as vb

    g = torch.Generator().manual_seed(0)
    b, l, d, h = 2, 9, 128, 2
    w = lambda *s: torch.randn(*s, generator=g) * 0.05
    lin = lambda o, i: {"weight": w(o, i), "bias": w(o)}
    p = {"ln1": {"weight": 1 + w(d), "bias": w(d)},
         "ln2": {"weight": 1 + w(d), "bias": w(d)},
         "qkv": lin(3 * d, d), "proj": lin(d, d), "fc1": lin(256, d),
         "fc2": lin(d, 256)}
    x = torch.randn(b, l, d, generator=g)
    mask = (torch.rand(b, l, generator=g) > 0.3).float()
    km, rm = mask.reshape(b, 1, l), mask.reshape(b, l, 1)
    qkv = torch.randn(b, l, 3 * d, generator=g)
    ops = torch.ops.laudnet
    return {
        "vit_block": (ops.vit_block.default, (
            x, km, rm, vb.flatten_layer(p), h, torch.ones(b, h), 1e-6, True)),
        "vit_block_int8": (ops.vit_block_int8.default, (
            x, km, rm, vb.flatten_layer(vb.quantize_block_params(p),
                                        int8=True), h, None, 1e-6)),
        "vit_segment": (ops.vit_segment.default, (
            x, mask, vb.flatten_layer(p) + vb.flatten_layer(
                dict(p, token_policy=lin(2, d))), [False, True], h, 1e-6,
            False)),
        "vit_attention": (ops.vit_attention.default, (
            qkv.requires_grad_(), mask, torch.ones(b, h, requires_grad=True),
            h, 0.125, True)),
        "vit_attention_bwd": (ops.vit_attention_bwd.default, (
            qkv.detach(), mask, torch.ones(b, h), torch.randn(b, l, d,
                                                              generator=g),
            None, h, 0.125)),
        "masked_bottleneck_tail": (ops.masked_bottleneck_tail.default, (
            torch.randn(2, 8, 8, 16, generator=g).relu(),
            torch.randn(2, 8, 8, 32, generator=g),
            (torch.rand(2, 4, 4, generator=g) > 0.5).float(), w(3, 3, 16, 16),
            1 + w(16), w(16), w(16, 32), 1 + w(32), w(32), 2, 5)),
    }


@pytest.mark.parametrize("name", ["vit_block", "vit_block_int8",
                                  "vit_segment", "vit_attention",
                                  "vit_attention_bwd",
                                  "masked_bottleneck_tail"])
def test_registered_ops_pass_opcheck_on_the_cpu(name):
    """`torch.library.opcheck` of each kernel's op with its CPU (plain)
    implementation: the schema, the fake implementation against the real
    one, and B4's autograd registration (B5's op its backward). The card
    tests run the same on the CUDA implementations."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
