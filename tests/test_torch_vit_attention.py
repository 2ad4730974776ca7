"""Port parity for the fused attention
(`laudnet_tpu_torch/ops/vit_attention.py::fused_vit_attention`; on CPU
tensors it runs its plain forward and its plain backward) against the JAX
kernels `fused_vit_attention(interpret=True)`, forward and backward, and
against both packages' `reference_vit_attention`.

Forward tolerances: f32, atol 1e-5 (f32 summation order only). bf16, two
bf16 ulps (8 significant bits) of the largest output: the JAX kernel rounds
p to bf16 before P.V and the plain version does not, and both round the
output once.

Backward tolerances, against ``jax.grad`` through the Pallas backward in
interpret mode: f32, rtol 3e-5 and atol 2e-3, the bound of the JAX
package's own backward test. bf16: the plain backward rounds P, dS and the
gated dO to bf16 where the kernel does, so both sides differ in f32
summation order only, which flips single bf16 roundings of dS and of the
result: two bf16 ulps of the largest gradient entry for dqkv, and 2e-2 of
the largest entry for dhead (an f32 sum of bf16-rounded products)."""

import math

import jax
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


def test_function_runs_under_grad_and_other_devices_have_no_path():
    qkv, km, _ = _inputs(2, seed=8)
    t = torch.from_numpy(qkv).requires_grad_()
    out = tva.fused_vit_attention(t, torch.from_numpy(km), None, 2, 0.125)
    assert out.requires_grad
    with torch.no_grad():
        out = tva.fused_vit_attention(t, torch.from_numpy(km), None, 2,
                                      0.125)
    assert not out.requires_grad
    with pytest.raises(ValueError, match="no kernel"):
        tva.fused_vit_attention(t.detach().to("meta"), torch.from_numpy(km),
                                None, 2, 0.125)


# --- the backward (kernel B5's plain version behind the Function) ----------

def _bwd_inputs(heads, seed, b=2, l=19):
    qkv, km, hm = _inputs(heads, seed, b=b, l=l)
    cot = np.random.default_rng(seed + 100).standard_normal(
        (b, l, heads * 64)).astype(np.float32)
    return qkv, km, hm, cot


def _jax_grads(qkv, km, hm, cot, heads, jdt):
    """dqkv, dkey_mask and dhead of the JAX fused attention: its Pallas
    backward in interpret mode (the fake-head route for odd head counts)."""
    def f(a, m, g):
        out = jva.fused_vit_attention(a, m, g, heads, 0.125, 2, True)
        return (out.astype(jnp.float32) * jnp.asarray(cot)).sum()

    args = (jnp.asarray(qkv, jdt), jnp.asarray(km),
            None if hm is None else jnp.asarray(hm))
    nums = (0, 1) if hm is None else (0, 1, 2)
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(f, argnums=nums)(*args)]


def _port_grads(qkv, km, hm, cot, heads, tdt):
    t = torch.from_numpy(qkv).to(tdt).requires_grad_()
    m = torch.from_numpy(km).requires_grad_()
    g = None if hm is None else torch.from_numpy(hm).requires_grad_()
    before = tva.fused_vit_attention.bwd_launches
    out = tva.fused_vit_attention(t, m, g, heads, 0.125)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert tva.fused_vit_attention.bwd_launches == before      # CPU: plain
    return t.grad, m.grad, None if g is None else g.grad


@pytest.mark.parametrize("gated", [False, True], ids=["nogate", "headmask"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [4, 3, 7])
def test_function_gradients_match_jax_pallas_backward(heads, dt, gated):
    qkv, km, hm, cot = _bwd_inputs(heads, seed=10 + heads)
    hm = hm if gated else None
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = _jax_grads(qkv, km, hm, cot, heads, jdt)
    dqkv, dmask, dhead = _port_grads(qkv, km, hm, cot, heads, tdt)
    assert dqkv.dtype == tdt and dqkv.shape == qkv.shape
    assert dmask is None and not ref[1].any()   # no gradient into the mask
    if dt == "f32":
        np.testing.assert_allclose(dqkv.numpy(), ref[0], rtol=3e-5,
                                   atol=2e-3)
    else:
        top = np.abs(ref[0]).max()
        tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        np.testing.assert_allclose(dqkv.float().numpy(), ref[0], atol=tol,
                                   rtol=0)
    if gated:
        assert dhead.shape == hm.shape
        if dt == "f32":
            np.testing.assert_allclose(dhead.numpy(), ref[2], rtol=3e-5,
                                       atol=2e-3)
        else:
            np.testing.assert_allclose(dhead.numpy(), ref[2], rtol=0,
                                       atol=2e-2 * np.abs(ref[2]).max())
        # head 0 of image 0 is closed: zero dq, dk, dv, non-zero dgate
        closed = dqkv[0].reshape(-1, 3, heads, 64)[:, :, 0]
        assert not closed.any() and dhead[0, 0] != 0


@pytest.mark.parametrize("gated", [False, True], ids=["nogate", "headmask"])
@pytest.mark.parametrize("heads", [2, 3])
def test_plain_backward_matches_autograd_of_the_plain_forward(heads, gated):
    """`reference_vit_attention_bwd` at f32 (its roundings are no-ops)
    against torch.autograd through `reference_vit_attention`: atol 1e-5,
    f32 summation order."""
    qkv, km, hm, cot = _bwd_inputs(heads, seed=20 + heads)
    t = torch.from_numpy(qkv).requires_grad_()
    g = torch.from_numpy(hm).requires_grad_() if gated else None
    out = tva.reference_vit_attention(t, torch.from_numpy(km), g, heads,
                                      0.125)
    out.backward(torch.from_numpy(cot))
    dqkv, dhead = tva.reference_vit_attention_bwd(
        t.detach(), torch.from_numpy(km), None if g is None else g.detach(),
        torch.from_numpy(cot), heads, 0.125)
    np.testing.assert_allclose(dqkv.numpy(), t.grad.numpy(), atol=1e-5,
                               rtol=0)
    if gated:
        np.testing.assert_allclose(dhead.numpy(), g.grad.numpy(), atol=1e-4,
                                   rtol=1e-5)
    else:
        assert dhead is None


def test_plain_backward_rounds_where_the_kernel_rounds():
    """At bf16 the plain backward differs from an f32 backward of the same
    bf16 inputs (it rounds P, dS and the gated dO), but stays within a few
    bf16 ulps of it: the rounding points are there and nowhere worse."""
    qkv, km, hm, cot = _bwd_inputs(2, seed=31)
    qb = torch.from_numpy(qkv).to(torch.bfloat16)
    cb = torch.from_numpy(cot).to(torch.bfloat16)
    args = (torch.from_numpy(km), torch.from_numpy(hm))
    lo, _ = tva.reference_vit_attention_bwd(qb, *args, cb, 2, 0.125)
    hi, _ = tva.reference_vit_attention_bwd(qb.float(), *args, cb.float(), 2,
                                            0.125)
    assert lo.dtype == torch.bfloat16
    err = (lo.float() - hi).abs().max().item()
    top = hi.abs().max().item()
    assert 0 < err <= 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
