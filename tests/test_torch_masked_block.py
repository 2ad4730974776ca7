"""Port parity for the block-sparse bottleneck tail
(`laudnet_tpu_torch/ops/masked_block.py`, kernel B3): the plain PyTorch
version, which is what the wrapper runs for CPU tensors, against the JAX
function with its Pallas kernel in interpret mode
(`laudnet_tpu/ops/pallas/masked_block.py::masked_bottleneck_tail`), at the
sizes of `tests/test_pallas_masked.py`. f32 on both sides: the two sum the
nine taps in another order, so atol 1e-4 (the JAX test's own bound against
its dense graph). The CUDA kernel itself is held to the plain version on a
card (`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from laudnet_tpu.ops.pallas import masked_block as jmb
from laudnet_tpu_torch.ops import masked_block as tmb

torch.set_num_threads(1)

NAMES = ("x1", "identity", "mask_cells", "w2", "a2", "b2", "w3", "a3", "b3")


def _inputs(seed, b, patch, hm, c, co, density=0.6):
    rng = np.random.default_rng(seed)
    h = hm * patch
    n = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    return dict(
        x1=n(b, h, h, c), identity=n(b, h, h, co),
        mask_cells=(rng.random((b, hm, hm)) < density).astype(np.float32),
        w2=n(3, 3, c, c, scale=0.1), a2=n(c, scale=0.1) + 1.0,
        b2=n(c, scale=0.1), w3=n(c, co, scale=0.1),
        a3=n(co, scale=0.1) + 1.0, b3=n(co, scale=0.1))


def _both(t, patch, capacity):
    with pltpu.force_tpu_interpret_mode():
        ref = jmb.masked_bottleneck_tail(
            *(jnp.asarray(t[k]) for k in NAMES), patch=patch,
            capacity=capacity)
    before = tmb.masked_bottleneck_tail.launches
    got = tmb.masked_bottleneck_tail(
        *(torch.from_numpy(t[k]) for k in NAMES), patch=patch,
        capacity=capacity)
    # a CPU tensor takes the plain version: no kernel was launched
    assert tmb.masked_bottleneck_tail.launches == before
    return got.numpy(), np.asarray(ref)


# Each case compiles the interpreted kernel anew, and that unrolls over the
# patches of a grid step (256 / patch^2 of them): half a minute at patch 2
# and two minutes at patch 1. Those two patch sizes are held to the plain
# version on the card (`tests/test_torch_kernels_cuda.py`), and the plain
# version at patch 2 to a dense convolution below.
@pytest.mark.parametrize("patch,hm,c,co,capacity_share", [
    (4, 4, 8, 16, 1.0), (7, 2, 8, 16, 0.5)])
def test_plain_version_matches_interpreted_pallas(patch, hm, c, co,
                                                  capacity_share):
    t = _inputs(patch + hm, 2, patch, hm, c, co)
    capacity = max(1, int(capacity_share * hm * hm))
    got, ref = _both(t, patch, capacity)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("kind", ["all_active", "all_zero"])
def test_mask_extremes(kind):
    t = _inputs(3, 1, 4, 4, 8, 8)
    t["mask_cells"] = (np.ones if kind == "all_active" else np.zeros)(
        (1, 4, 4), np.float32)
    if kind == "all_zero":
        full, ref = _both(t, 4, 16)
        np.testing.assert_allclose(full, ref, atol=1e-4)
        np.testing.assert_array_equal(full, np.maximum(t["identity"], 0.0))
        return
    # capacity binds: the first 8 cells in raster order are computed as at
    # full capacity, the rest fall back to relu(identity)
    half, ref_half = _both(t, 4, 8)
    np.testing.assert_allclose(half, ref_half, atol=1e-4)
    full = tmb.masked_bottleneck_tail(
        *(torch.from_numpy(t[k]) for k in NAMES), patch=4,
        capacity=16).numpy()
    np.testing.assert_array_equal(half[0, :8], full[0, :8])
    np.testing.assert_array_equal(half[0, 8:],
                                  np.maximum(t["identity"], 0.0)[0, 8:])
    assert not np.allclose(half, full)


def test_plain_version_rounds_where_the_kernel_rounds():
    """bf16: the ReLU output and the second affine are rounded to bf16
    before they are used, and the residual add is a bf16 add."""
    t = {k: torch.from_numpy(v) for k, v in
         _inputs(5, 2, 2, 4, 16, 16).items()}
    bf = {k: (v.to(torch.bfloat16) if k in ("x1", "identity", "w2", "w3")
              else v) for k, v in t.items()}
    got = tmb.reference_masked_bottleneck_tail(**bf, patch=2, capacity=16)
    assert got.dtype == torch.bfloat16
    up = {k: v.float() for k, v in bf.items()}
    x = torch.nn.functional.conv2d(
        up["x1"].permute(0, 3, 1, 2).double(),
        up["w2"].permute(3, 2, 0, 1).double(), padding=1).permute(0, 2, 3, 1)
    h = torch.relu(x.float() * up["a2"] + up["b2"]).to(torch.bfloat16)
    y = ((h.double() @ up["w3"].double()).float() * up["a3"] + up["b3"]).to(
        torch.bfloat16)
    mask = bf["mask_cells"].repeat_interleave(2, 1).repeat_interleave(2, 2)
    want = torch.relu(bf["identity"] + y * mask[..., None].to(torch.bfloat16))
    # f64 sums against f32 sums: a rounding of h or y flips at most rarely,
    # by one bf16 ulp of an O(1) value
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -5
    assert (got == want).float().mean().item() > 0.98


def test_fold_bn():
    rng = np.random.default_rng(2)
    scale, bias, mean = (rng.standard_normal(8).astype(np.float32)
                         for _ in range(3))
    var = (rng.random(8) + 0.1).astype(np.float32)
    a, b = tmb.fold_bn(*(torch.from_numpy(v) for v in (scale, bias, mean,
                                                       var)))
    ja, jb = jmb.fold_bn(*(jnp.asarray(v) for v in (scale, bias, mean, var)))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


def test_no_kernel_for_other_devices():
    t = {k: torch.from_numpy(v).to("meta") for k, v in
         _inputs(0, 1, 2, 2, 8, 8).items()}
    with pytest.raises(ValueError, match="no kernel"):
        tmb.masked_bottleneck_tail(**t, patch=2, capacity=4)
