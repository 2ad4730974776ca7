"""The port package stands alone: every `laudnet_tpu_torch` module imports
with jax, flax and the JAX package made unimportable; the CPU path never
counts a kernel launch; the ctypes signatures match the CUDA source."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from laudnet_tpu_torch.ops import _build, vit_block

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "laudnet_tpu"):
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
    assert int(proc.stdout.strip()) >= 10  # package, 4 subpackages, modules


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
    src = (_build.CSRC / "vit_block.cu").read_text()
    decls = dict(re.findall(r"\nint (lt_\w+)\(([^)]*)\)", src))
    assert set(decls) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert decls[name].count(",") + 1 == len(argtypes), name


def test_library_path_is_keyed_by_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert re.fullmatch(r"laudnet_kernels_[0-9a-f]{16}\.so", path.name)
