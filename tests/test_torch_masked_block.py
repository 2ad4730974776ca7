"""Port parity for the block-sparse bottleneck tail
(`laudnet_tpu_torch/ops/masked_block.py`, kernel B3): the plain PyTorch
version, which is what the wrapper runs for CPU tensors, against the JAX
function with its Pallas kernel in interpret mode
(`laudnet_tpu/ops/pallas/masked_block.py::masked_bottleneck_tail`), at the
sizes of `tests/test_pallas_masked.py`. f32 on both sides: the two sum the
nine taps in another order, so atol 1e-4 (the JAX test's own bound against
its dense graph). The CUDA kernel itself is held to the plain version on a
card (`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`)."""

import functools

import jax
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


@functools.partial(jax.jit, static_argnames="capacity")
def _jax_selection(mask_cells, *, capacity):
    """The JAX kernel's own selection
    (`laudnet_tpu/ops/pallas/masked_block.py:194-198`): stable top-k over
    each image's flat mask, a slot valid where its value is > 0.5."""
    b = mask_cells.shape[0]
    vals, idx = jax.lax.top_k(mask_cells.reshape(b, -1), capacity)
    return idx, vals > 0.5


@pytest.mark.parametrize("kind,b,hm,capacity", [
    ("random", 4, 4, 16), ("random", 3, 7, 25), ("all_zero", 2, 4, 16),
    ("all_active", 2, 4, 16), ("binding", 3, 4, 3), ("random", 1, 5, 10)])
def test_selection_matches_the_jax_top_k(kind, b, hm, capacity):
    """`reference_select_cells`, the selection kernel's plain version,
    keeps the cells the JAX kernel keeps, in its order: image-major, raster
    order within an image; slots past the count hold -1."""
    rng = np.random.default_rng(hm + capacity)
    mask = (rng.random((b, hm, hm)) < 0.5).astype(np.float32)
    if kind == "all_zero":
        mask[:] = 0.0
    elif kind in ("all_active", "binding"):
        mask[:] = 1.0
    idx, valid = map(np.asarray, _jax_selection(jnp.asarray(mask),
                                                capacity=capacity))
    n_cells = hm * hm
    want = [i * n_cells + int(idx[i, k]) for i in range(b)
            for k in range(capacity) if valid[i, k]]
    slots, n_valid, selected = tmb.reference_select_cells(
        torch.from_numpy(mask), capacity)
    assert n_valid.tolist() == [len(want)]
    assert slots.dtype == torch.int32 and slots.shape == (b * capacity,)
    assert slots[:len(want)].tolist() == want
    assert (slots[len(want):] == -1).all()
    flags = np.zeros(b * n_cells, np.uint8)
    flags[want] = 1
    np.testing.assert_array_equal(selected.numpy(), flags)


def test_plain_version_at_a_ragged_patch_and_widths():
    """Patch 3 (outside the CUDA kernel's former {1, 2, 4, 7}) and widths
    that are not multiples of 8 (C = 12, Co = 20), f32, every active cell
    selected: the dense graph with the mask, summed in f64."""
    patch, hm, c, co = 3, 4, 12, 20
    t = {k: torch.from_numpy(v) for k, v in
         _inputs(11, 2, patch, hm, c, co).items()}
    got = tmb.reference_masked_bottleneck_tail(**t, patch=patch,
                                               capacity=hm * hm)
    d = {k: v.double() for k, v in t.items()}
    x = torch.nn.functional.conv2d(
        d["x1"].permute(0, 3, 1, 2), d["w2"].permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1)
    h = torch.relu(x * d["a2"] + d["b2"])
    y = (h @ d["w3"]) * d["a3"] + d["b3"]
    mask = d["mask_cells"].repeat_interleave(patch, 1).repeat_interleave(
        patch, 2)[..., None]
    want = torch.relu(d["identity"] + y * mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_channel_pad_is_exact():
    """The wrapper's pad of ragged widths to a multiple of 8 changes
    nothing: the plain version on the padded inputs, sliced back, equals
    the unpadded result bit for bit in f32 (a padded channel adds exact
    zeros to every sum)."""
    patch, hm, c, co = 2, 3, 12, 20
    t = {k: torch.from_numpy(v) for k, v in
         _inputs(13, 2, patch, hm, c, co).items()}
    names = ("x1", "identity", "w2", "a2", "b2", "w3", "a3", "b3")
    padded = dict(zip(names, tmb.pad_channels(*(t[k] for k in names))))
    assert padded["x1"].shape[-1] == 16 and padded["identity"].shape[-1] == 24
    assert padded["w2"].shape == (3, 3, 16, 16)
    assert padded["w3"].shape == (16, 24)
    kw = dict(patch=patch, capacity=7)
    want = tmb.reference_masked_bottleneck_tail(**t, **kw)
    got = tmb.reference_masked_bottleneck_tail(
        **padded, mask_cells=t["mask_cells"], **kw)
    assert torch.equal(got[..., :co], want)
    assert not got[..., co:].any()
    same = tmb.pad_channels(*(padded[k] for k in names))
    assert all(a is b for a, b in zip(same, padded.values()))


def test_no_kernel_for_other_devices():
    t = {k: torch.from_numpy(v).to("meta") for k, v in
         _inputs(0, 1, 2, 2, 8, 8).items()}
    with pytest.raises(ValueError, match="no kernel"):
        tmb.masked_bottleneck_tail(**t, patch=2, capacity=4)
