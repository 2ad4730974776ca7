"""The probes' kernels' plain versions (`laudnet_tpu_torch/ops/s8_gemm.py`
for P2, `ops/vit_block.py::BlockVariant` bodies for P1) against what they
stand for: the s8 product against numpy's int64 product, bit for bit; each
carried P1 stage against the JAX probe's own body pieces on the CPU
(`tools/probe_block_budget.py::_attention` in its modes full, nosoftmax,
unnorm and unnorm_nosub, `_ln_scale_only`, `_silu_gelu`) and the JAX block
kernel's (`laudnet_tpu/ops/pallas/vit_block.py::_ln`, `_ln_onepass`,
`_gelu_exact`, `_gelu_tanh`). The attention rounds p and its output to
bf16 where the JAX pieces round them and sums in another order: 4 bf16
ulps of the largest output. The f32 pieces agree to 1e-5 (LayerNorm) and
2e-6 (the A-S polynomial of the JAX erf GELU is within 1.5e-7 of erf).
The P1 mode table is checked against the JAX probe's mode sets, and the
carried modes' plain layers run through `fused_vit_block`'s ``variant``
on the CPU."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops.pallas import vit_block as jvb
from laudnet_tpu_torch.ops import s8_gemm, vit_block
from laudnet_tpu_torch.tools import probe_block_budget as tprobe

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "jax_probe_block_budget",
    Path(__file__).resolve().parents[1] / "tools" / "probe_block_budget.py")
jprobe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jprobe)


@pytest.mark.parametrize("m,k,n", [(64, 4096, 48), (37, 16, 5),
                                   (100, 1040, 77)])
def test_s8_plain_is_the_integer_product(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    want = a.astype(np.int64) @ w.astype(np.int64).T
    got = s8_gemm.s8_gemm(torch.from_numpy(a), torch.from_numpy(w).t())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("mode,softmax", [("full", "exact"),
                                          ("nosoftmax", "linear"),
                                          ("unnorm", "deferred"),
                                          ("unnorm_nosub", "nomax")])
def test_attention_forms_match_the_jax_probe(mode, softmax):
    b, l, d, heads = 2, 37, 256, 4
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * d)).astype(
        np.float32)).to(torch.bfloat16)
    kmask = (rng.random((b, l)) > 0.3).astype(np.float32)
    kmask[:, 0] = 1.0
    neg = (1.0 - kmask) * vit_block.NEG
    want = jprobe._attention(
        jnp.asarray(_bf16_np(qkv), jnp.bfloat16),
        jnp.asarray(neg[:, None, :]), d, d // heads, heads // 2,
        (d // heads) ** -0.5, jnp.bfloat16, mode)
    got = vit_block.attention(qkv, torch.from_numpy(neg), heads,
                              (d // heads) ** -0.5, softmax=softmax)
    want = np.asarray(want.astype(jnp.float32))
    top = np.abs(want).max()
    tol = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(_bf16_np(got) - want).max() <= tol


def test_norms_and_activations_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 384)).astype(np.float32) * 2 + 0.3
    w = (1 + 0.1 * rng.standard_normal(384)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(384)).astype(np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, bias))
    for port, jax_fn in ((vit_block.layer_norm, jvb._ln),
                         (vit_block.layer_norm_onepass, jvb._ln_onepass),
                         (vit_block.layer_norm_scale,
                          jprobe._ln_scale_only)):
        np.testing.assert_allclose(
            port(tx, tw, tb, 1e-6).numpy(),
            np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias), 1e-6)), atol=1e-5)
    u = np.linspace(-6, 6, 2001).astype(np.float32)
    tu = torch.from_numpy(u)
    for port, jax_fn, atol in ((vit_block.gelu_exact, jvb._gelu_exact, 2e-6),
                               (vit_block.gelu_tanh, jvb._gelu_tanh, 1e-6),
                               (vit_block.silu_gelu, jprobe._silu_gelu,
                                1e-6)):
        np.testing.assert_allclose(port(tu).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(u))),
                                   atol=atol)


def test_mode_table_covers_the_jax_probe():
    jax_modes = {"full", "nogelu", "silu_gelu", "nosoftmax", "unnorm",
                 "noln", "ln_onepass", "nomask", "stackq", "f32attn",
                 "fast_exact", "fast_tanh", "fast_silu", "post_vselect",
                 "post_premask", "post_noexp", "post_nosub", "post_nomask",
                 "post_noln", "post_nogelu", "post_norowmask",
                 "post_bf16res", "tanh_gelu", "stackq_unnorm",
                 "combo_exact", "combo_tanh", "combo_silu",
                 # `_attention`'s own forms behind post_premask, post_vselect
                 "premask", "vselect"}
    assert set(tprobe.MODES) | set(tprobe.LEFT_BEHIND) == jax_modes
    assert not set(tprobe.MODES) & set(tprobe.LEFT_BEHIND)
    for modes in tprobe.SETS.values():
        assert set(modes) <= jax_modes
    assert tprobe.MODES["full"] == vit_block.EXACT
    assert tprobe.MODES["fast_tanh"] == vit_block.FAST


@pytest.mark.parametrize("mode", sorted(tprobe.MODES))
def test_block_variant_plain_layer(mode):
    """Each carried mode's plain layer on the CPU: finite, and the
    production bodies equal to `fused_vit_block`'s plain version."""
    g = torch.Generator().manual_seed(3)
    b, l, d, heads, hidden = 2, 17, 128, 2, 256
    x = torch.randn(b, l, d, generator=g).to(torch.bfloat16)
    mask = (torch.rand(b, l, generator=g) > 0.3).float()
    mask[:, 0] = 1.0

    def lin(n, k):
        return {"weight": (torch.randn(n, k, generator=g) * 0.05).to(
            torch.bfloat16), "bias": (torch.randn(n, generator=g) * 0.05).to(
            torch.bfloat16)}

    ln = {"weight": torch.ones(d, dtype=torch.bfloat16),
          "bias": torch.zeros(d, dtype=torch.bfloat16)}
    p = {"ln1": ln, "ln2": ln, "qkv": lin(3 * d, d), "proj": lin(d, d),
         "fc1": lin(hidden, d), "fc2": lin(d, hidden)}
    args = (x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), p)
    v = tprobe.MODES[mode]
    out = vit_block.fused_vit_block(*args, num_heads=heads, variant=v)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    prod = {vit_block.EXACT: False, vit_block.FAST: True}
    if v in prod:
        assert torch.equal(out, vit_block.fused_vit_block(
            *args, num_heads=heads, fast_math=prod[v]))
