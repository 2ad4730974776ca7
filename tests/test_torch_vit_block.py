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
