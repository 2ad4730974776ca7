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


def _jax_value_and_grad(fn, x, cot):
    import jax
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("name", ["fake_quant_weight", "fake_quant_rows",
                                  "fake_quant_per_image", "QuantConv"])
def test_training_and_cnn_parts_raise(name):
    """Parts that once raised. The CNN family's two now run and are held to
    JAX; the QAT fake-quant of rows and weights quantise and dequantise: an
    int8-representable input comes back unchanged."""
    if name == "fake_quant_per_image":
        x = np.random.default_rng(3).standard_normal(
            (3, 5, 5, 4)).astype(np.float32)
        cot = np.random.default_rng(4).standard_normal(x.shape).astype(
            np.float32)
        ref, ref_grad = _jax_value_and_grad(jq.fake_quant_per_image, x, cot)
        t = torch.from_numpy(x).requires_grad_()
        out = tq.fake_quant_per_image(t)
        out.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(t.grad.numpy(), ref_grad)
        return
    if name == "QuantConv":
        _check_quant_conv(CONV_CASES["3x3"], fake=False)
        return
    x = torch.tensor([[127.0, -64.0, 3.0], [2.0, 0.0, -127.0]])
    assert torch.equal(getattr(tq, name)(x), x)


# --- W8A8 convolutions vs JAX ------------------------------------------------
# features, kernel, strides, padding, dilation, groups, input channels, size
CONV_CASES = {
    "1x1": (16, 1, 1, 0, 1, 1, 8, 6),
    "3x3": (8, 3, 1, 1, 1, 1, 8, 6),
    "3x3_stride2": (8, 3, 2, 1, 1, 1, 8, 7),
    "stem_7x7": (8, 7, 2, 3, 1, 1, 3, 16),
    "downsample": (16, 1, 2, 0, 1, 1, 8, 7),
    "groups_dilated": (8, 3, 1, 2, 2, 2, 8, 8),
    "valid": (8, 3, 1, 0, 1, 1, 8, 6),
}


def _check_quant_conv(case, fake, seed=0):
    """`QuantConv` against the flax one on the same kernel and images. The
    integer sums are exact on both sides and the dequantisation is the same
    two f32 multiplies: rtol 1e-6. The fake-quant form is a float
    convolution summed in another order: atol 1e-5. Seeds were checked to
    have no code on a rounding tie, where the frameworks may differ."""
    import jax

    features, k, stride, pad, dil, groups, cin, size = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, size, size, cin)) * 2.0).astype(np.float32)
    jpad = "VALID" if pad == 0 and k > 1 else pad
    if k == 1:
        jpad = "SAME"
    jconv = jq.QuantConv(features, (k, k), strides=stride, padding=jpad,
                         kernel_dilation=dil, feature_group_count=groups,
                         fake=fake)
    v = jconv.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    kernel = np.asarray(v["params"]["kernel"])
    ref = np.asarray(jconv.apply(v, jnp.asarray(x)))
    conv = tq.QuantConv(cin, features, k, stride, pad, dil, groups,
                        device="cpu", fake=fake)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
        out = conv(torch.from_numpy(x))
    assert out.shape == ref.shape
    if fake:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)
    return conv, x


@pytest.mark.parametrize("case,fake", [(c, False) for c in sorted(CONV_CASES)]
                         + [(c, True) for c in ("1x1", "3x3_stride2",
                                                "groups_dilated")])
def test_quant_conv_matches_jax(case, fake):
    _check_quant_conv(CONV_CASES[case], fake, seed=len(case))


def test_fake_quant_conv_gradients_match_jax():
    """The QAT convolution's straight-through gradients, to the input and
    to the kernel, against flax's on the same cotangent: float convolutions
    summed in another order, 1e-4 of each gradient's largest entry."""
    import jax

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 6, 6, 8)) * 2.0).astype(np.float32)
    jconv = jq.QuantConv(8, (3, 3), strides=2, padding=1, fake=True)
    v = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(v["params"]["kernel"])
    cot = rng.standard_normal((2, 3, 3, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda k, x: jconv.apply({"params": {"kernel": k}}, x),
                     jnp.asarray(kernel), jnp.asarray(x))
    jgk, jgx = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    conv = tq.QuantConv(8, 8, 3, 2, 1, device="cpu", fake=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
    t = torch.from_numpy(x).requires_grad_()
    conv(t).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), jgx, rtol=0,
                               atol=1e-4 * np.abs(jgx).max())
    gk = conv.weight.grad.numpy().transpose(2, 3, 1, 0)
    np.testing.assert_allclose(gk, jgk, rtol=0,
                               atol=1e-4 * np.abs(jgk).max())


def test_quant_conv_is_exact_where_f32_is_not():
    """127^2 * 9 * 512 exceeds 2^24: the sums must not pass through f32."""
    xq = torch.full((1, 512, 3, 3), 127.0)
    wq = torch.full((8, 512, 3, 3), 127, dtype=torch.int8)
    wq[:, 0, 0, 0] = 126
    acc = tq.int_conv2d(xq, wq, (1, 1), (0, 0), (1, 1), 1)
    exact = 127 * 127 * 9 * 512 - 127
    assert acc.shape == (1, 8, 1, 1)
    assert float(acc[0, 0, 0, 0]) == float(np.float32(exact))


def test_quant_conv_keeps_conv2d_s_parameter_and_per_image_scale():
    conv, x = _check_quant_conv(CONV_CASES["3x3"], fake=False)
    assert [n for n, _ in conv.named_parameters()] == ["weight"]
    assert conv.weight.shape == (8, 8, 3, 3)
    # one image's outlier must not change another image's output
    x2 = x.copy()
    x2[1] *= 50.0
    with torch.no_grad():
        a, b = conv(torch.from_numpy(x)), conv(torch.from_numpy(x2))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
    # the QAT form passes gradients straight through to input and weight
    t = torch.from_numpy(x).requires_grad_()
    conv(t, fake=True).sum().backward()
    assert t.grad.abs().sum() > 0 and conv.weight.grad.abs().sum() > 0


# --- QAT: fake-quant values and straight-through gradients vs JAX ----------

def test_fake_quant_rows_matches_jax():
    """Values to 1e-6 (one f32 multiply of exact codes by the scale) and the
    straight-through gradient exactly: the cotangent passes unchanged."""
    x = _rows(seed=7)
    cot = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    ref, ref_grad = _jax_value_and_grad(jq.fake_quant_rows, x, cot)
    t = torch.from_numpy(x).requires_grad_()
    out = tq.fake_quant_rows(t)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(t.grad.numpy(), ref_grad)
    np.testing.assert_array_equal(ref_grad, cot)
    # the values are the dequantised codes: at most half a step from x
    q, s = tq.quantize_rows(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), (q.float() * s).numpy(),
                               atol=1e-7)
    assert (out.detach() - t.detach()).abs().max() <= 0.5001 * s.max()


def test_fake_quant_rows_bf16_rounds_deq_to_the_input_dtype():
    x = _rows(seed=9)
    ref = jq.fake_quant_rows(jnp.asarray(x, jnp.bfloat16))
    out = tq.fake_quant_rows(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    # one bf16 ulp of the largest value: x + (deq - x) re-rounds in bf16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2.0 ** -7 * 4, rtol=0)


def test_fake_quant_weight_matches_jax():
    """The port's weight is the flax kernel transposed; values to 1e-7
    and the cotangent passes unchanged."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)  # (K, N)
    cot = rng.standard_normal(w.shape).astype(np.float32)
    ref, ref_grad = _jax_value_and_grad(jq.fake_quant_weight, w, cot)
    t = torch.from_numpy(w.T.copy()).requires_grad_()
    out = tq.fake_quant_weight(t)
    out.backward(torch.from_numpy(cot.T.copy()))
    np.testing.assert_allclose(out.detach().numpy(), ref.T, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_array_equal(t.grad.numpy(), ref_grad.T)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quant_dense_fake_matches_jax(dt):
    """``QuantDense(fake=True)`` against flax's, same weights: output and
    the gradients of input, kernel and bias. f32: 1e-5 (f32 summation
    order). bf16 input: two bf16 ulps of the largest output (the product
    accumulates in another order before its one rounding), gradients to
    one bf16 ulp of their largest entry."""
    import jax

    rng = np.random.default_rng(12)
    x = _rows(seed=12, rows=6, k=64)
    k = (rng.standard_normal((64, 24)) * 0.1).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32) * 0.1
    cot = rng.standard_normal((6, 24)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jlayer = jq.QuantDense(24, fake=True)

    def f(params, xx):
        out = jlayer.apply({"params": params}, xx)
        return (out.astype(jnp.float32) * cot).sum(), out

    params = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
    (_, ref), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x, jdt))
    layer = tq.QuantDense(64, 24, device="cpu", fake=True)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(k.T.copy()))
        layer.bias.copy_(torch.from_numpy(b))
    t = torch.from_numpy(x).to(tdt).requires_grad_()
    out = layer(t)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dt == "f32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        tol = dict(atol=2 * ulp, rtol=0)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, **tol)
    # bf16 gradients: one bf16 ulp of each gradient's largest entry (the
    # bias's is a sum of the cotangent's rows rounded to bf16)
    for got, want in ((t.grad.float().numpy(), gx.astype(jnp.float32)),
                      (layer.weight.grad.numpy(), gp["kernel"].T),
                      (layer.bias.grad.numpy(), gp["bias"])):
        want = np.asarray(want)
        gtol = tol if dt == "f32" else dict(
            atol=2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7), rtol=0)
        np.testing.assert_allclose(got, want, **gtol)
    # the same parameters with ``fake`` off are the real W8A8 product
    layer.fake = False
    with torch.no_grad():
        real = layer(t.detach())
        wq, ws = tq.quantize_weight(layer.weight)
        assert torch.equal(real, tq.int8_linear(t.detach(), wq, ws,
                                                layer.bias).to(tdt))
