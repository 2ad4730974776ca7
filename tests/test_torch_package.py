"""The port package stands alone: every `laudnet_tpu_torch` module imports
with jax, flax and the JAX package made unimportable; the CPU path never
counts a kernel launch; the ctypes signatures match the CUDA source."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from laudnet_tpu_torch import device as port_device
from laudnet_tpu_torch import entry
from laudnet_tpu_torch.ops import _build, quant, vit_attention, vit_block

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "laudnet_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import laudnet_tpu_torch
names = ["laudnet_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(laudnet_tpu_torch.__path__,
                                          "laudnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # package, 6 subpackages, modules: every file is walked and imported
    names = {p.relative_to(REPO).with_suffix("").as_posix().replace("/", ".")
             for p in (REPO / "laudnet_tpu_torch").rglob("*.py")}
    names = {n[:-len(".__init__")] if n.endswith(".__init__") else n
             for n in names}
    assert int(proc.stdout.strip()) == len(names) >= 36
    for new in ("device", "ops.quant", "ops.vit_attention", "models.t2t",
                "ops.gating", "utils.metrics", "utils.logging_utils",
                "utils.config", "train.schedules", "train.losses",
                "train.hyperparams", "train.optim", "train.trainer",
                "train.checkpoint", "train.main", "entry", "ops.masking",
                "ops.sparse", "ops.norm", "ops.masked_block",
                "models.maskers", "models.resnet", "models.laud_resnet",
                "utils.flops", "ops.s8_gemm", "sim.report", "sim.tiles",
                "sim.models", "sim.hardware", "sim.h100", "sim.plan",
                "infer.calibrate", "infer.export_pruned",
                "infer.layerskip", "infer.engine", "tools.timing",
                "tools.probe_int8", "tools.probe_block_budget",
                "tools.probe_host", "tools.probe_segments",
                "tools.compare_with_torch"):
        assert f"laudnet_tpu_torch.{new}" in names


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    b, l, d, h = 2, 5, 128, 2

    def lin(o, i):
        return {"weight": torch.randn(o, i, generator=g) * 0.05,
                "bias": torch.zeros(o)}

    p = {"ln1": {"weight": torch.ones(d), "bias": torch.zeros(d)},
         "ln2": {"weight": torch.ones(d), "bias": torch.zeros(d)},
         "qkv": lin(3 * d, d), "proj": lin(d, d), "fc1": lin(256, d),
         "fc2": lin(d, 256)}
    x = torch.randn(b, l, d, generator=g)
    mask = torch.ones(b, l)
    out = vit_block.fused_vit_block(x, mask.reshape(b, 1, l),
                                    mask.reshape(b, l, 1), p, num_heads=h)
    seg, _ = vit_block.fused_vit_segment(x, mask, [p], num_heads=h)
    assert torch.equal(out, seg)
    assert vit_block.fused_vit_block.launches == 0
    assert vit_block.fused_vit_segment.launches == 0
    # a tensor on neither the CPU nor a card has no path at all
    with pytest.raises(ValueError, match="no kernel"):
        vit_block.fused_vit_block(x.to("meta"), mask, mask, p, num_heads=h)


def test_kernel_input_checks_raise_before_any_pointer_is_passed():
    """`_check_cuda` guards the raw-pointer launches; it is device-agnostic,
    so its checks run here on CPU tensors."""
    b, l, d, h, hidden = 2, 5, 128, 2, 256

    def lin(o, i):
        return {"weight": torch.zeros(o, i, dtype=torch.bfloat16),
                "bias": torch.zeros(o, dtype=torch.bfloat16)}

    ln = {"weight": torch.ones(d, dtype=torch.bfloat16),
          "bias": torch.zeros(d, dtype=torch.bfloat16)}
    p = {"ln1": ln, "ln2": ln, "qkv": lin(3 * d, d), "proj": lin(d, d),
         "fc1": lin(hidden, d), "fc2": lin(d, hidden),
         "token_policy": lin(2, d)}
    x = torch.zeros(b, l, d, dtype=torch.bfloat16)
    mask = torch.ones(b, l)
    vit_block._check_cuda(x, (mask,), [p], h)
    with pytest.raises(TypeError, match="bf16"):
        vit_block._check_cuda(x.float(), (mask,), [p], h)
    with pytest.raises(ValueError, match="heads of 64"):
        vit_block._check_cuda(x, (mask,), [p], 4)
    with pytest.raises(ValueError, match="masks"):
        vit_block._check_cuda(x, (torch.ones(b, l + 1),), [p], h)
    with pytest.raises(ValueError, match="proj.weight"):
        vit_block._check_cuda(x, (mask,), [dict(p, proj=lin(d, 2 * d))], h)
    with pytest.raises(TypeError, match="qkv.bias"):
        bad = dict(p, qkv={"weight": p["qkv"]["weight"],
                           "bias": torch.zeros(3 * d)})
        vit_block._check_cuda(x, (mask,), [bad], h)


def test_ctypes_signatures_match_the_cuda_source():
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert [s.name for s in sources] == ["attention.cu",
                                         "masked_block.cu",
                                         "probe_int8.cu",
                                         "vit_block.cu",
                                         "vit_block_rows.cu"]
    src = "".join(s.read_text() for s in sources)
    decls = dict(re.findall(r"\nint (lt_\w+)\(([^)]*)\)", src))
    assert set(decls) == set(_build._SIGNATURES)
    assert "lt_attn_fwd" in decls and "lt_attn_bwd" in decls
    assert "lt_masked_tail" in decls
    assert "lt_s8_gemm" in decls
    # the shared header is hashed with the sources, so editing it rebuilds
    assert _build.CSRC / "mma_common.cuh" in _build._sources()
    assert _build.CSRC / "wgmma.cuh" in _build._sources()
    assert _build.CSRC / "vit_block_epi.cuh" in _build._sources()
    for name, argtypes in _build._SIGNATURES.items():
        assert decls[name].count(",") + 1 == len(argtypes), name


def test_library_path_is_keyed_by_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert re.fullmatch(r"laudnet_kernels_[0-9a-f]{16}\.so", path.name)


def test_default_device_is_the_card():
    """A port constructor called without ``device`` builds on CUDA; the
    CPU is chosen only by asking for it. Read without building a model."""
    assert port_device.resolve_device(None) == torch.device("cuda")
    assert port_device.resolve_device() == torch.device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    assert port_device.resolve_device(torch.device("meta")).type == "meta"


def test_constructors_without_a_device_ask_for_cuda():
    """On a machine without a card PyTorch's own error comes through: no
    constructor catches it and falls back to the CPU."""
    from laudnet_tpu_torch import models

    if torch.cuda.is_available():
        pytest.skip("a card is present: the constructors succeed")
    for build in (lambda: models.LAUDViT(depth=1, dim=64, num_heads=1),
                  lambda: models.LAUDViTBlock(64, 1),
                  lambda: models.T2TStem(embed_dim=64),
                  lambda: models.TokenPerformer(27, 64),
                  lambda: quant.QuantDense(8, 8),
                  lambda: quant.QuantConv(8, 8, 3),
                  lambda: models.SpatialMasker(8),
                  lambda: models.LAUDBottleneck(16, 4, output_size=8),
                  lambda: models.ResNet(layers=(1, 1, 1, 1)),
                  models.uni_resnet50, entry.flagship,
                  models.laud_deit_tiny, models.laud_t2t_vit_19):
        with pytest.raises((AssertionError, RuntimeError),
                           match="(?i)cuda|nvidia"):
            build()
    assert models.laud_deit_tiny(device="cpu").head.weight.device.type == "cpu"


def test_new_wrappers_count_nothing_on_the_cpu():
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(1)
    b, l, d, h = 2, 5, 128, 2

    def lin(o, i):
        return {"weight": torch.randn(o, i, generator=g) * 0.05,
                "bias": torch.zeros(o)}

    p = {"ln1": {"weight": torch.ones(d), "bias": torch.zeros(d)},
         "ln2": {"weight": torch.ones(d), "bias": torch.zeros(d)},
         "qkv": lin(3 * d, d), "proj": lin(d, d), "fc1": lin(256, d),
         "fc2": lin(d, 256)}
    x = torch.randn(b, l, d, generator=g)
    mask = torch.ones(b, l)
    gate = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    qp = vit_block.quantize_block_params(p)
    assert qp["qkv"]["weight_q"].dtype == torch.int8
    assert qp["ln1"] is p["ln1"]
    out = vit_block.fused_vit_block_int8(
        x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), qp, num_heads=h,
        head_gate=gate)
    assert out.shape == x.shape and torch.isfinite(out).all()
    gated = vit_block.fused_vit_block(
        x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), p, num_heads=h,
        head_gate=gate)
    open_ = vit_block.fused_vit_block(
        x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), p, num_heads=h,
        head_gate=torch.ones(b, h))
    plain = vit_block.fused_vit_block(
        x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), p, num_heads=h)
    assert torch.equal(open_, plain) and not torch.equal(gated, plain)
    att = vit_attention.fused_vit_attention(
        torch.randn(b, l, 3 * d, generator=g), mask, gate, h, 0.125)
    assert att.shape == (b, l, d)
    assert vit_block.fused_vit_block_int8.launches == 0
    assert vit_block.fused_vit_block.launches == 0
    assert vit_attention.fused_vit_attention.launches == 0
    # the backward of the attention Function on CPU tensors is the plain
    # backward: no backward launch is counted either
    qkv = torch.randn(b, l, 3 * d, generator=g).requires_grad_()
    vit_attention.fused_vit_attention(qkv, mask, gate, h, 0.125).sum(
    ).backward()
    assert qkv.grad is not None and qkv.grad.abs().sum() > 0
    assert vit_attention.fused_vit_attention.bwd_launches == 0
    assert vit_attention.fused_vit_attention.launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        vit_block.fused_vit_block_int8(x.to("meta"), mask, mask, qp,
                                       num_heads=h)


def test_int8_kernel_input_checks():
    """`_check_cuda` on W8A8 parameters: codes int8, scales f32, biases
    bf16, and K a multiple of 16 (rows of s8 codes in 16-byte multiples:
    the GEMM core's TMA row stride)."""
    b, l, d, h, hidden = 2, 5, 128, 2, 256

    def qlin(o, i):
        return {"weight_q": torch.zeros(o, i, dtype=torch.int8),
                "scale": torch.ones(o),
                "bias": torch.zeros(o, dtype=torch.bfloat16)}

    ln = {"weight": torch.ones(d, dtype=torch.bfloat16),
          "bias": torch.zeros(d, dtype=torch.bfloat16)}
    p = {"ln1": ln, "ln2": ln, "qkv": qlin(3 * d, d), "proj": qlin(d, d),
         "fc1": qlin(hidden, d), "fc2": qlin(d, hidden)}
    x = torch.zeros(b, l, d, dtype=torch.bfloat16)
    mask = torch.ones(b, l)
    vit_block._check_cuda(x, (mask,), [p], h, torch.ones(b, h), int8=True)
    with pytest.raises(ValueError, match="head_gate"):
        vit_block._check_cuda(x, (mask,), [p], h, torch.ones(b, h + 1),
                              int8=True)
    with pytest.raises(TypeError, match="qkv must hold"):
        vit_block._check_cuda(x, (mask,), [p], h)       # float kernels
    with pytest.raises(TypeError, match="fc1.scale"):
        bad = dict(p, fc1=dict(p["fc1"], scale=torch.ones(hidden).half()))
        vit_block._check_cuda(x, (mask,), [bad], h, int8=True)
    with pytest.raises(TypeError, match="proj.weight_q"):
        bad = dict(p, proj=dict(p["proj"],
                                weight_q=torch.zeros(d, d, dtype=torch.uint8)))
        vit_block._check_cuda(x, (mask,), [bad], h, int8=True)
    with pytest.raises(ValueError, match="K % 16"):
        bad = dict(p, fc1=qlin(104, d), fc2=qlin(d, 104))
        vit_block._check_cuda(x, (mask,), [bad], h, int8=True)


def test_bottleneck_tail_input_checks():
    """What the CUDA tail kernel refuses, checked before any pointer is
    passed; the checks run on CPU tensors too. f32, ragged widths (padded
    by the wrapper), any patch that tiles and non-contiguous tensors
    (copied by the wrapper) pass."""
    from laudnet_tpu_torch.ops import masked_block

    bf = torch.bfloat16

    def args(c=64, co=64, hw=8, dtype=bf, cells=4):
        return dict(x1=torch.zeros(2, hw, hw, c, dtype=dtype),
                    identity=torch.zeros(2, hw, hw, co, dtype=dtype),
                    mask_cells=torch.ones(2, cells, cells),
                    w2=torch.zeros(3, 3, c, c, dtype=dtype),
                    a2=torch.ones(c), b2=torch.zeros(c),
                    w3=torch.zeros(c, co, dtype=dtype), a3=torch.ones(co),
                    b3=torch.zeros(co))

    check = masked_block._check_cuda
    check(**args(), patch=2, capacity=16)
    check(**args(dtype=torch.float32), patch=2, capacity=16)
    check(**args(c=12, co=20), patch=2, capacity=16)
    check(**args(hw=9, cells=3), patch=3, capacity=9)
    bad = args()
    bad["x1"] = torch.zeros(2, 8, 64, 8, dtype=bf).transpose(2, 3)
    check(**bad, patch=2, capacity=16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        check(**args(dtype=torch.int32), patch=2, capacity=16)
    with pytest.raises(TypeError, match="w3"):
        check(**dict(args(), w3=torch.zeros(64, 64)), patch=2, capacity=16)
    with pytest.raises(ValueError, match="patch"):
        check(**args(hw=9, cells=3), patch=2, capacity=9)
    with pytest.raises(ValueError, match="capacity"):
        check(**args(), patch=2, capacity=17)
    with pytest.raises(ValueError, match="capacity"):
        check(**args(), patch=2, capacity=0)
    with pytest.raises(ValueError, match="does not tile"):
        check(**dict(args(), mask_cells=torch.ones(2, 3, 4)), patch=2,
              capacity=4)
    with pytest.raises(ValueError, match="identity"):
        check(**dict(args(), identity=torch.zeros(2, 8, 4, 64, dtype=bf)),
              patch=2, capacity=16)
    assert masked_block.masked_bottleneck_tail.launches == 0


def test_f32_convolutions_switch_tf32_off_and_back():
    before = torch.backends.cudnn.allow_tf32
    with port_device.full_f32_convolutions():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before
    with pytest.raises(RuntimeError, match="boom"):
        with port_device.full_f32_convolutions():
            raise RuntimeError("boom")
    assert torch.backends.cudnn.allow_tf32 == before
