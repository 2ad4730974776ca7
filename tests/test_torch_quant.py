"""Port parity for W8A8 quantisation (`laudnet_tpu_torch/ops/quant.py`)
against `laudnet_tpu/ops/quant.py`, and for the plain W8A8 block
(`ops/vit_block.py::fused_vit_block_int8_reference`) against the JAX
kernel `fused_vit_block_int8` in interpret mode.

Codes must be equal exactly and scales to rtol 1e-6 (the same f32
operations; a scale may differ in its last bit where a framework folds a
constant). The block compares in f32 at atol 1e-4: both sides are f32
around exact integer products, and differ in f32 summation order and in
the erf (the JAX kernel's polynomial is within 1.5e-7 of it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops import quant as jq
from laudnet_tpu.ops.pallas import vit_block as jvb
from laudnet_tpu_torch.ops import quant as tq
from laudnet_tpu_torch.ops import vit_block as tvb

torch.set_num_threads(1)


def _rows(seed=0, rows=9, k=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32) * 3.0
    x[2] = 0.0                                  # a masked-out token
    # a row whose scale is exactly 1 (|x|max = 127) holding half-way
    # values: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0 under rint, where
    # round-half-away would give 1, 2, 3, -1
    x[4] = 0.0
    x[4, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    return x


def test_quantize_rows_codes_equal():
    x = _rows()
    jq_, js = jq.quantize_rows(jnp.asarray(x))
    q, s = tq.quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert not q[2].any()                       # zeros stay zeros
    assert q[4, :6].tolist() == [127, 0, 2, 2, 0, -2]   # rint, not round


def test_quantize_rows_bf16_input():
    x = _rows(seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    jq_, js = jq.quantize_rows(xb)
    q, s = tq.quantize_rows(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


def test_quantize_weight_codes_equal():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)  # (K, N)
    w[:, 7] = 0.0                               # a dead channel: eps floor
    jq_, js = jq.quantize_weight(jnp.asarray(w))
    q, s = tq.quantize_weight(torch.from_numpy(w.T.copy()))   # (N, K)
    assert q.shape == (40, 96) and s.shape == (40,)
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq_))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert not q[7].any()


@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_matches_jax(bias):
    rng = np.random.default_rng(2)
    x = _rows(seed=2, rows=2 * 5, k=64).reshape(2, 5, 64)
    w = (rng.standard_normal((64, 24)) * 0.1).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    ref = jq.int8_linear(jnp.asarray(x), jwq, jws,
                         None if b is None else jnp.asarray(b))
    wq, ws = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    out = tq.int8_linear(torch.from_numpy(x), wq, ws,
                         None if b is None else torch.from_numpy(b))
    assert out.dtype == torch.float32 and out.shape == (2, 5, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_int_matmul_is_exact_at_the_largest_codes():
    """K = 1536 at |code| = 127: the sum 127^2 * 1536 = 24,774,144 is above
    f32's 2^24 integer range, so an f32 product would round it."""
    xq = torch.full((3, 1536), 127, dtype=torch.int8)
    wq = torch.full((2, 1536), -127, dtype=torch.int8)
    wq[1, ::2] = 126
    out = tq.int_matmul(xq, wq)
    expect = (xq.long() @ wq.long().t()).float()
    assert torch.equal(out, expect)
    assert out[0, 0].item() == -127 * 127 * 1536


def test_quant_dense_is_a_linear_with_int8_forward():
    layer = tq.QuantDense(64, 24, device="cpu")
    assert sorted(n for n, _ in layer.named_parameters()) == ["bias",
                                                              "weight"]
    x = torch.from_numpy(_rows(seed=4, rows=6, k=64))
    with torch.no_grad():
        out = layer(x)
        wq, ws = tq.quantize_weight(layer.weight)
        expect = tq.int8_linear(x, wq, ws, layer.bias)
        dense = torch.nn.functional.linear(x, layer.weight, layer.bias)
    assert torch.equal(out, expect)
    rel = ((out - dense).norm() / dense.norm()).item()
    assert 0 < rel < 0.02, rel          # quantised, and close to the float


# --- the W8A8 block: plain version vs the JAX kernel in interpret mode -----

def _block_setup(d, heads, hidden, seed):
    rng = np.random.default_rng(seed)
    b, l = 2, 19

    def mk(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"ln1": {"scale": 1.0 + mk(d), "bias": mk(d)},
              "ln2": {"scale": 1.0 + mk(d), "bias": mk(d)},
              "qkv": {"kernel": mk(d, 3 * d), "bias": mk(3 * d)},
              "proj": {"kernel": mk(d, d), "bias": mk(d)},
              "fc1": {"kernel": mk(d, hidden), "bias": mk(hidden)},
              "fc2": {"kernel": mk(hidden, d), "bias": mk(d)}}
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    mask = (rng.random((b, l)) > 0.3).astype(np.float32)   # ragged
    mask[:, 0] = 1.0
    gate = (rng.random((b, heads)) > 0.4).astype(np.float32)
    gate[0, 0], gate[1, 1] = 0.0, 1.0
    return params, x, mask, gate


def _jax_qparams(params):
    q = {"ln1": {k: jnp.asarray(v) for k, v in params["ln1"].items()},
         "ln2": {k: jnp.asarray(v) for k, v in params["ln2"].items()}}
    for name in ("qkv", "proj", "fc1", "fc2"):
        kq, ks = jq.quantize_weight(jnp.asarray(params[name]["kernel"]))
        q[name] = {"kernel_q": kq, "scale": ks,
                   "bias": jnp.asarray(params[name]["bias"])}
    return q


def _torch_params(params):
    p = {}
    for name, sub in params.items():
        if "scale" in sub:
            p[name] = {"weight": torch.from_numpy(sub["scale"]),
                       "bias": torch.from_numpy(sub["bias"])}
        else:
            p[name] = {"weight": torch.from_numpy(sub["kernel"].T.copy()),
                       "bias": torch.from_numpy(sub["bias"])}
    return p


@pytest.fixture(scope="module")
def block():
    params, x, mask, gate = _block_setup(256, 4, 512, seed=5)
    return params, x, mask, gate, _jax_qparams(params), \
        tvb.quantize_block_params(_torch_params(params))


@pytest.mark.parametrize("gated", [False, True])
def test_int8_block_reference_matches_jax_kernel(block, gated):
    params, x, mask, gate, jqp, tqp = block
    b, l, d = x.shape
    hg = None
    if gated:   # the TPU kernel takes the gate expanded to feature lanes
        hg = jnp.repeat(jnp.asarray(gate), 64, axis=-1).reshape(b, 1, d)
    ref = jvb.fused_vit_block_int8(
        jnp.asarray(x), jnp.asarray(mask).reshape(b, 1, l),
        jnp.asarray(mask).reshape(b, l, 1), jqp, num_heads=4, head_gate=hg,
        interpret=True)
    tm = torch.from_numpy(mask)
    before = tvb.fused_vit_block_int8.launches
    out = tvb.fused_vit_block_int8(
        torch.from_numpy(x), tm.reshape(b, 1, l), tm.reshape(b, l, 1), tqp,
        num_heads=4, head_gate=torch.from_numpy(gate) if gated else None)
    assert tvb.fused_vit_block_int8.launches == before    # CPU: plain
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_int8_block_weights_quantise_as_jax(block):
    _, _, _, _, jqp, tqp = block
    for name in ("qkv", "proj", "fc1", "fc2"):
        np.testing.assert_array_equal(tqp[name]["weight_q"].numpy().T,
                                      np.asarray(jqp[name]["kernel_q"]))
        np.testing.assert_allclose(tqp[name]["scale"].numpy(),
                                   np.asarray(jqp[name]["scale"]), rtol=1e-6)


def test_int8_block_is_close_to_the_float_block(block):
    """Inexact by the quantisation of the products' operands only."""
    params, x, mask, _, _, tqp = block
    b, l, _ = x.shape
    tm = torch.from_numpy(mask)
    args = (torch.from_numpy(x), tm.reshape(b, 1, l), tm.reshape(b, l, 1))
    q = tvb.fused_vit_block_int8_reference(*args, tqp, num_heads=4)
    f = tvb.fused_vit_block_reference(*args, _torch_params(params),
                                      num_heads=4)
    rel = ((q - f).norm() / f.norm()).item()
    assert 0 < rel < 0.02, rel


@pytest.mark.parametrize("name", ["fake_quant_weight", "fake_quant_rows",
                                  "fake_quant_per_image", "QuantConv"])
def test_training_and_cnn_parts_raise(name):
    with pytest.raises(NotImplementedError, match="slice of the port"):
        getattr(tq, name)(torch.zeros(2, 2))
