"""Port parity for the fused attention forward
(`laudnet_tpu_torch/ops/vit_attention.py::fused_vit_attention`; on CPU
tensors it runs its plain version) against the JAX kernel
`fused_vit_attention(interpret=True)` and against both packages'
`reference_vit_attention`.

Tolerances: f32, atol 1e-5 (f32 summation order only). bf16, two bf16 ulps
(8 significant bits) of the largest output: the JAX kernel rounds p to bf16
before P.V and the plain version does not, and both round the output
once."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops.pallas import vit_attention as jva
from laudnet_tpu_torch.ops import vit_attention as tva

torch.set_num_threads(1)


def _inputs(heads, seed, b=2, l=23):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, l, 3 * heads * 64)).astype(np.float32)
    key_mask = (rng.random((b, l)) > 0.3).astype(np.float32)   # ragged
    key_mask[:, 0] = 1.0
    head_mask = (rng.random((b, heads)) > 0.4).astype(np.float32)
    head_mask[0, 0], head_mask[1, -1] = 0.0, 1.0
    return qkv, key_mask, head_mask


@pytest.fixture(scope="module", params=[2, 3], ids=["2heads", "3heads"])
def case(request):
    """Inputs and the JAX kernel's outputs (interpret mode), f32 and bf16,
    with and without a head mask. 3 heads takes the JAX kernel's
    fake-head route; the port has no such route."""
    heads = request.param
    qkv, km, hm = _inputs(heads, seed=heads)
    ref = {}
    for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        for gated in (False, True):
            out = jva.fused_vit_attention(
                jnp.asarray(qkv, jdt), jnp.asarray(km),
                jnp.asarray(hm) if gated else None, heads, 0.125, 8, True)
            ref[dt, gated] = np.asarray(out.astype(jnp.float32))
    return heads, qkv, km, hm, ref


def _tol(dt, ref):
    if dt == "f32":
        return 1e-5
    return 2 * 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("gated", [False, True], ids=["nogate", "headmask"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_attention_matches_jax_kernel(case, dt, gated):
    heads, qkv, km, hm, ref = case
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    before = tva.fused_vit_attention.launches
    out = tva.fused_vit_attention(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(km),
        torch.from_numpy(hm) if gated else None, heads, 0.125)
    assert tva.fused_vit_attention.launches == before      # CPU: plain
    assert out.dtype == tdt and out.shape == (2, 23, heads * 64)
    np.testing.assert_allclose(out.float().numpy(), ref[dt, gated],
                               atol=_tol(dt, ref[dt, gated]), rtol=0)
    if gated:   # a closed head's lanes are exactly zero
        assert not out[0, :, :64].any()


@pytest.mark.parametrize("gated", [False, True], ids=["nogate", "headmask"])
def test_fused_attention_matches_both_references(case, gated):
    heads, qkv, km, hm, _ = case
    g = hm if gated else None
    jref = jva.reference_vit_attention(
        jnp.asarray(qkv), jnp.asarray(km),
        None if g is None else jnp.asarray(g), heads, 0.125)
    args = (torch.from_numpy(qkv), torch.from_numpy(km),
            None if g is None else torch.from_numpy(g), heads, 0.125)
    out = tva.fused_vit_attention(*args)
    assert torch.equal(out, tva.reference_vit_attention(*args))
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)


def test_masked_keys_do_not_contribute():
    qkv, km, _ = _inputs(2, seed=7)
    t = torch.from_numpy(qkv)
    out = tva.fused_vit_attention(t, torch.from_numpy(km), None, 2, 0.125)
    noisy = t.clone()
    dropped = torch.from_numpy(km)[0] == 0
    noisy[0, dropped, 128:] += 5.0                # k and v of masked keys
    out2 = tva.fused_vit_attention(noisy, torch.from_numpy(km), None, 2,
                                   0.125)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-6)


def test_forward_only_until_the_training_slice():
    qkv, km, _ = _inputs(2, seed=8)
    t = torch.from_numpy(qkv).requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        tva.fused_vit_attention(t, torch.from_numpy(km), None, 2, 0.125)
    with torch.no_grad():
        out = tva.fused_vit_attention(t, torch.from_numpy(km), None, 2,
                                      0.125)
    assert not out.requires_grad
    with pytest.raises(ValueError, match="no kernel"):
        tva.fused_vit_attention(t.detach().to("meta"), torch.from_numpy(km),
                                None, 2, 0.125)
