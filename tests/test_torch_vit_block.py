"""Port parity for the block kernels' plain versions
(`laudnet_tpu_torch/ops/vit_block.py`) against the JAX Pallas kernels in
interpret mode (`laudnet_tpu/ops/pallas/vit_block.py`), plus the gate and
reference attention. Inputs come from numpy with a seed; both sides run
f32 and differ only in summation order, hence atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.ops import gating as jgating
from laudnet_tpu.ops.pallas import vit_attention as jattn
from laudnet_tpu.ops.pallas import vit_block as jvb
from laudnet_tpu_torch.ops import gating, vit_attention, vit_block

torch.set_num_threads(1)
ATOL = 1e-4


def _layer_np(rng, d, hidden, policy=False, dtype=np.float32):
    """One layer's params in the flax layout (numpy)."""
    def mk(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    p = {"ln1": {"scale": 1.0 + mk(d), "bias": mk(d)},
         "ln2": {"scale": 1.0 + mk(d), "bias": mk(d)},
         "qkv": {"kernel": mk(d, 3 * d), "bias": mk(3 * d)},
         "proj": {"kernel": mk(d, d), "bias": mk(d)},
         "fc1": {"kernel": mk(d, hidden), "bias": mk(hidden)},
         "fc2": {"kernel": mk(hidden, d), "bias": mk(d)}}
    if policy:
        p["token_policy"] = {"kernel": mk(d, 2, scale=0.3),
                             "bias": np.zeros(2, dtype)}
    return p


def _to_jax(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def _to_torch(p):
    """flax layout -> the port's torch.nn.Linear layout."""
    out = {}
    for name, sub in p.items():
        if "scale" in sub:
            out[name] = {"weight": torch.from_numpy(sub["scale"]),
                         "bias": torch.from_numpy(sub["bias"])}
        else:
            out[name] = {"weight": torch.from_numpy(
                np.ascontiguousarray(sub["kernel"].T)),
                "bias": torch.from_numpy(sub["bias"])}
    return out


def _ragged_mask(rng, b, l):
    mask = (rng.random((b, l)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return mask


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("dim,heads", [(256, 4), (128, 2)])
def test_block_matches_jax_kernel(dim, heads, fast_math):
    rng = np.random.default_rng(dim + fast_math)
    b, l = 2, 19
    p = _layer_np(rng, dim, 2 * dim)
    x = rng.standard_normal((b, l, dim)).astype(np.float32)
    mask = _ragged_mask(rng, b, l)
    ref = jvb.fused_vit_block(
        jnp.asarray(x), jnp.asarray(mask.reshape(b, 1, l)),
        jnp.asarray(mask.reshape(b, l, 1)),
        _to_jax({"ln1": p["ln1"], "qkv": p["qkv"], "proj": p["proj"],
                 "ln2": p["ln2"], "fc1": p["fc1"], "fc2": p["fc2"]}),
        num_heads=heads, fast_math=fast_math, interpret=True)
    out = vit_block.fused_vit_block(
        torch.from_numpy(x), torch.from_numpy(mask.reshape(b, 1, l)),
        torch.from_numpy(mask.reshape(b, l, 1)), _to_torch(p),
        num_heads=heads, fast_math=fast_math)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert vit_block.fused_vit_block.launches == 0  # CPU: plain version


@pytest.mark.parametrize("fast_math", [False, True])
def test_segment_matches_jax_kernel(fast_math):
    """Three layers; the second and third carry interior token policies
    that drop tokens, composed into a ragged entry mask."""
    rng = np.random.default_rng(7 + fast_math)
    b, l, d, h = 2, 17, 256, 4
    layers = [_layer_np(rng, d, 512), _layer_np(rng, d, 512, policy=True),
              _layer_np(rng, d, 512, policy=True)]
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    mask = _ragged_mask(rng, b, l)
    jlayers = []
    for p in layers:
        q = {"ln1": p["ln1"], "qkv": p["qkv"], "proj": p["proj"],
             "ln2": p["ln2"], "fc1": p["fc1"], "fc2": p["fc2"]}
        if "token_policy" in p:
            q["token_policy"] = p["token_policy"]
        jlayers.append(_to_jax(q))
    ref, ref_mask = jvb.fused_vit_segment(
        jnp.asarray(x), jnp.asarray(mask), jlayers, num_heads=h,
        fast_math=fast_math, interpret=True)
    out, out_mask = vit_block.fused_vit_segment(
        torch.from_numpy(x), torch.from_numpy(mask),
        [_to_torch(p) for p in layers], num_heads=h, fast_math=fast_math)
    ref_mask = np.asarray(ref_mask)
    assert ref_mask.sum() < mask.sum()  # the interior gates dropped tokens
    np.testing.assert_array_equal(out_mask.numpy(), ref_mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert vit_block.fused_vit_segment.launches == 0


def test_segment_interior_policy_gates_in_compute_dtype():
    """A logit pair that ties in bf16 (1 vs 1 + 2^-9, which rounds to 1)
    but not in f32 must KEEP the token in bf16 (the JAX kernel's rounding
    point, `tests/test_fused_vit_block.py`); in f32 it drops it."""
    rng = np.random.default_rng(3)
    b, l, d, h = 2, 8, 128, 2
    p0 = _to_torch(_layer_np(rng, d, 256))
    p1 = _to_torch(_layer_np(rng, d, 256))
    p1["token_policy"] = {"weight": torch.zeros(2, d),
                          "bias": torch.tensor([1.0, 1.0 + 2.0 ** -9])}
    x = torch.from_numpy(rng.standard_normal((b, l, d)).astype(np.float32))
    mask0 = torch.ones(b, l)

    def cast(p, dt):
        return {k: {kk: t.to(dt) if k != "token_policy" or kk == "weight"
                    else t for kk, t in v.items()} for k, v in p.items()}

    _, mask = vit_block.fused_vit_segment(
        x.bfloat16(), mask0, [cast(p0, torch.bfloat16),
                              cast(p1, torch.bfloat16)], num_heads=h)
    np.testing.assert_array_equal(mask.numpy(), np.ones((b, l)))
    _, mask32 = vit_block.fused_vit_segment(x, mask0, [p0, p1], num_heads=h)
    expect = np.zeros((b, l))
    expect[:, 0] = 1.0  # class token pinned
    np.testing.assert_array_equal(mask32.numpy(), expect)


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(5)
    b, l, h, dh = 2, 13, 3, 32
    qkv = rng.standard_normal((b, l, 3 * h * dh)).astype(np.float32)
    mask = _ragged_mask(rng, b, l)
    head_mask = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    for hm in (None, head_mask):
        ref = jattn.reference_vit_attention(
            jnp.asarray(qkv), jnp.asarray(mask),
            None if hm is None else jnp.asarray(hm), h, dh ** -0.5)
        out = vit_attention.reference_vit_attention(
            torch.from_numpy(qkv), torch.from_numpy(mask),
            None if hm is None else torch.from_numpy(hm), h, dh ** -0.5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_binary_gate_matches_jax_with_ties():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 2, 6)).astype(np.float32)
    logits[:, 1, :2] = logits[:, 0, :2]  # ties resolve to on
    ref = jgating.binary_gate(jnp.asarray(logits), 1.0, training=False)
    out = gating.binary_gate(torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[:, :2].eq(1.0).all()
    with pytest.raises(ValueError, match="noise source"):
        gating.binary_gate(torch.from_numpy(logits), 1.0, training=True)


def _jax_int8_params(p):
    """flax-layout params -> the JAX W8A8 block's ``qparams``."""
    from laudnet_tpu.ops import quant as jq

    q = {"ln1": p["ln1"], "ln2": p["ln2"]}
    for name in ("qkv", "proj", "fc1", "fc2"):
        kq, ks = jq.quantize_weight(jnp.asarray(p[name]["kernel"]))
        q[name] = {"kernel_q": kq, "scale": ks,
                   "bias": jnp.asarray(p[name]["bias"])}
    return q


@pytest.mark.parametrize("int8", [False, True])
def test_layer_matches_jax_at_widths_off_the_tile(int8):
    """D = 192 (3 heads of 64) and hidden 576: no product width is a
    multiple of the GEMM core's 128 x 192 / 224 tiles except 192 itself,
    and L = 11 rows of 2 images. The port's plain layer (what the CUDA
    layer is held to on the card) against the JAX kernel in interpret
    mode, f32, atol 1e-4 (summation order; the W8A8 block also the erf
    polynomial, `tests/test_torch_quant.py`). The JAX kernels take 3 heads
    with a zero fake head padded in, as the JAX engine builds them
    (`infer/fused_vit.py::_pad_fake_head`, bit-exact); the port takes 3
    heads as they are."""
    from laudnet_tpu.infer.fused_vit import _pad_fake_head

    rng = np.random.default_rng(11 + int8)
    b, l, d, heads, hidden = 2, 11, 192, 3, 576
    p = _layer_np(rng, d, hidden)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    mask = _ragged_mask(rng, b, l)
    jargs = (jnp.asarray(x), jnp.asarray(mask.reshape(b, 1, l)),
             jnp.asarray(mask.reshape(b, l, 1)))
    targs = (torch.from_numpy(x), torch.from_numpy(mask.reshape(b, 1, l)),
             torch.from_numpy(mask.reshape(b, l, 1)))
    jp = _pad_fake_head(_to_jax(p), d, heads)
    if int8:
        ref = jax.jit(lambda *a: jvb.fused_vit_block_int8(
            *a, num_heads=heads, interpret=True))(*jargs, _jax_int8_params(jp))
        out = vit_block.fused_vit_block_int8(
            *targs, vit_block.quantize_block_params(_to_torch(p)),
            num_heads=heads)
    else:
        ref = jax.jit(lambda *a: jvb.fused_vit_block(
            *a, num_heads=heads, interpret=True))(*jargs, jp)
        out = vit_block.fused_vit_block(*targs, _to_torch(p), num_heads=heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _bf16_params(p):
    return {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
            for k, v in _to_torch(p).items()}


def _compose_row_epilogues(int8):
    """The row epilogues of `block_gemm_reference` chained as the CUDA
    layers launch them. bf16: a segment at `test_segment_matches_jax_kernel`'s
    sizes (three layers, interior token policies, ragged entry mask):
    proj_ln gives x2 and LN2, fc2_ln the next layer's LN1 and token gate.
    W8A8: the layer at `test_layer_matches_jax_at_widths_off_the_tile`'s
    (D = 192, hidden 576): proj_ln gives LN2's codes, fc1_q the GELU
    output's. Returns (composed, plain) outputs and masks."""
    from laudnet_tpu_torch.ops.quant import quantize_rows

    gemm, ln, neg = vit_block.block_gemm, vit_block.layer_norm, vit_block.NEG
    if int8:
        rng = np.random.default_rng(11)
        b, l, d, heads, hidden = 2, 11, 192, 3, 576
        layers = [_layer_np(rng, d, hidden)]
    else:
        rng = np.random.default_rng(7)
        b, l, d, heads, hidden = 2, 17, 256, 4, 512
        layers = [_layer_np(rng, d, hidden),
                  _layer_np(rng, d, hidden, policy=True),
                  _layer_np(rng, d, hidden, policy=True)]
    ps = [_bf16_params(p) for p in layers]
    x = torch.from_numpy(rng.standard_normal((b, l, d)).astype(
        np.float32)).to(torch.bfloat16)
    mask0 = torch.from_numpy(_ragged_mask(rng, b, l))
    m = b * l
    xf, mask = x.reshape(m, d), mask0.reshape(-1)
    if int8:
        p, qp = ps[0], vit_block.quantize_block_params(ps[0])
        q1, s1 = quantize_rows(ln(xf, p["ln1"]["weight"], p["ln1"]["bias"]))
        qkv = gemm(q1, qp["qkv"], "qkv", a_scale=s1.reshape(-1))
        att = vit_block.attention(qkv.reshape(b, l, 3 * d), (1.0 - mask0) * neg,
                                  heads, 64 ** -0.5).reshape(m, d)
        qa, sa = quantize_rows(att.float())
        x2, q2, s2 = gemm(qa, qp["proj"], "proj_ln", a_scale=sa.reshape(-1),
                          resid=xf, row_mask=mask, ln=p["ln2"])
        qu, su = gemm(q2, qp["fc1"], "fc1_q", a_scale=s2)
        out = gemm(qu, qp["fc2"], "fc2", a_scale=su, resid=x2, row_mask=mask)
        ref = vit_block.fused_vit_block_int8_reference(
            x, mask0.reshape(b, 1, l), mask0.reshape(b, l, 1), qp,
            num_heads=heads)
        return out.reshape(b, l, d), ref, mask, mask0.reshape(-1)
    ref, ref_mask = vit_block.fused_vit_segment_reference(x, mask0, ps,
                                                          num_heads=heads)
    h1 = ln(xf, ps[0]["ln1"]["weight"], ps[0]["ln1"]["bias"]).to(
        torch.bfloat16)
    for i, p in enumerate(ps):
        qkv = gemm(h1, p["qkv"], "qkv").reshape(b, l, 3 * d)
        att = vit_block.attention(qkv, (1.0 - mask.reshape(b, l)) * neg,
                                  heads, 64 ** -0.5).reshape(m, d)
        x2, h2 = gemm(att, p["proj"], "proj_ln", resid=xf, row_mask=mask,
                      ln=p["ln2"])
        u = gemm(h2, p["fc1"], "fc1")
        if i + 1 < len(ps):
            xf, h1, mask = gemm(u, p["fc2"], "fc2_ln", resid=x2,
                                row_mask=mask, ln=ps[i + 1]["ln1"],
                                policy=ps[i + 1].get("token_policy"),
                                seq_len=l)
        else:
            xf = gemm(u, p["fc2"], "fc2", resid=x2, row_mask=mask)
    assert ref_mask.sum() < mask0.sum()  # the interior gates dropped tokens
    return xf.reshape(b, l, d), ref, mask, ref_mask.reshape(-1)


@pytest.mark.parametrize("int8", [False, True, "rows", "rows-int8"])
def test_block_gemm_reference_composes_the_layer(int8):
    """The four products of `block_gemm_reference` (what each launch of
    the GEMM core is held to on the card) chained with the layer's
    LayerNorms, attention and row quantisers give the plain layer bit for
    bit, bf16 and W8A8; on the CPU `block_gemm` runs that plain version.
    The row epilogues ('rows', 'rows-int8': `_compose_row_epilogues`)
    chained without those launches give the plain segment and W8A8 layer
    bit for bit, and the segment's token mask (the plain versions are held
    to the JAX kernels in interpret mode by the tests above)."""
    from laudnet_tpu_torch.ops.quant import quantize_rows

    if isinstance(int8, str):
        before = vit_block.block_gemm.launches
        out, ref, mask, ref_mask = _compose_row_epilogues(int8 == "rows-int8")
        assert vit_block.block_gemm.launches == before
        assert torch.equal(out, ref) and torch.equal(mask, ref_mask)
        return
    rng = np.random.default_rng(21 + int8)
    b, l, d, heads, hidden = 2, 9, 128, 2, 256
    p = _to_torch(_layer_np(rng, d, hidden))
    p = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
         for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((b, l, d)).astype(
        np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy(_ragged_mask(rng, b, l))
    m, rm = b * l, mask.reshape(-1)
    neg = (1.0 - mask) * vit_block.NEG
    gemm = vit_block.block_gemm
    before = gemm.launches
    ln = vit_block.layer_norm
    xf = x.reshape(m, d)
    if int8:
        qp = vit_block.quantize_block_params(p)

        def prod(a, name, epi, **kw):
            q, s = quantize_rows(a)
            return gemm(q, qp[name], epi, a_scale=s.reshape(-1), **kw)

        h1 = ln(xf, p["ln1"]["weight"], p["ln1"]["bias"])
        qkv = prod(h1, "qkv", "qkv").reshape(b, l, 3 * d)
        att = vit_block.attention(qkv, neg, heads, 64 ** -0.5).reshape(m, d)
        x2 = prod(att.float(), "proj", "proj", resid=xf, row_mask=rm)
        u = prod(ln(x2, p["ln2"]["weight"], p["ln2"]["bias"]), "fc1", "fc1")
        out = prod(u, "fc2", "fc2", resid=x2, row_mask=rm)
        ref = vit_block.fused_vit_block_int8_reference(
            x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), qp,
            num_heads=heads)
    else:
        h1 = ln(xf, p["ln1"]["weight"], p["ln1"]["bias"]).to(torch.bfloat16)
        qkv = gemm(h1, p["qkv"], "qkv").reshape(b, l, 3 * d)
        att = vit_block.attention(qkv, neg, heads, 64 ** -0.5).reshape(m, d)
        x2 = gemm(att, p["proj"], "proj", resid=xf, row_mask=rm)
        h2 = ln(x2.to(torch.bfloat16), p["ln2"]["weight"],
                p["ln2"]["bias"]).to(torch.bfloat16)
        u = gemm(h2, p["fc1"], "fc1")
        out = gemm(u, p["fc2"], "fc2", resid=x2, row_mask=rm)
        ref = vit_block.fused_vit_block_reference(
            x, mask.reshape(b, 1, l), mask.reshape(b, l, 1), p,
            num_heads=heads)
    assert gemm.launches == before  # CPU: the plain version
    assert torch.equal(out.reshape(b, l, d), ref)
