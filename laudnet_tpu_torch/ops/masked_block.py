"""Block-sparse bottleneck tail (kernel B3; counterpart of
`laudnet_tpu/ops/pallas/masked_block.py`).

For each selected cell of a stride-1 block's spatial mask it computes

    conv2 (3x3 over the haloed window) -> BN -> ReLU -> conv3 (1x1) -> BN

on the cell's ``patch x patch`` pixels and returns
``relu(identity + scattered)``; a cell that is not selected (inactive, or
active beyond ``capacity`` in raster order) comes out as
``relu(identity)``. BN at eval folds into per-channel affines (`fold_bn`).

`masked_bottleneck_tail` launches the CUDA kernel
(`csrc/masked_block.cu`) for CUDA tensors and runs
`reference_masked_bottleneck_tail`, the plain PyTorch version, for CPU
tensors only. Both round where the TPU kernel rounds: the ReLU output and
the second affine's output to the working type, and the residual add in
the working type. The module's sparse execution mode does not come through
here: it runs `ops/sparse.py` (`models/laud_resnet.py`), as in the JAX
package.
"""

from __future__ import annotations

import torch

from laudnet_tpu_torch.ops import sparse

PATCHES = (1, 2, 4, 7)
MIN_CHANNELS, MAX_CHANNELS = 64, 2048


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Folds eval-mode BatchNorm into a per-channel ``(a, b)``:
    ``y = a * x + b``."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


def reference_masked_bottleneck_tail(x1, identity, mask_cells, w2, a2, b2,
                                     w3, a3, b3, *, patch: int,
                                     capacity: int) -> torch.Tensor:
    """The plain version of the kernel; arguments as
    `masked_bottleneck_tail`. Stable top-k selection, haloed windows, the
    3x3 conv as nine accumulated f32 products (one per tap), the two
    affines in f32 with their outputs rounded to the working type, and the
    residual add in the working type. Plain matrix products only, so on a
    card it runs in full f32 and never in TF32."""
    dtype = x1.dtype
    b, hh, ww, c = x1.shape
    co = identity.shape[-1]
    idx, vals = sparse.select_patches(mask_cells, capacity)
    valid = (vals > 0.5).to(dtype)
    win = sparse.gather_patches(x1, idx, patch, halo=1)
    rows = b * capacity * patch * patch
    acc = torch.zeros((rows, c), dtype=torch.float32, device=x1.device)
    w2f = w2.float()
    for ki in range(3):
        for kj in range(3):
            tap = win[:, :, ki:ki + patch, kj:kj + patch, :].reshape(rows, c)
            acc += tap.float() @ w2f[ki, kj]
    h = torch.relu(acc * a2.float() + b2.float()).to(dtype)
    y = (h.float() @ w3.float()) * a3.float() + b3.float()
    patches = y.to(dtype).reshape(b, capacity, patch, patch, co)
    scattered = sparse.scatter_patches_add(
        torch.zeros_like(identity), patches, idx, valid, patch)
    return torch.relu(identity + scattered)


def _check_cuda(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                capacity):
    """What the CUDA kernel takes; anything else raises."""
    for name, t in (("x1", x1), ("identity", identity), ("w2", w2),
                    ("w3", w3)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA bottleneck-tail kernel takes bf16, "
                            f"got {name} {t.dtype}")
    for name, t in (("x1", x1), ("identity", identity)):
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"(B, H, W, C) tensor")
    b, hh, ww, c = x1.shape
    co = identity.shape[-1]
    if tuple(identity.shape[:3]) != (b, hh, ww):
        raise ValueError(f"identity {tuple(identity.shape)} does not match "
                         f"x1 {tuple(x1.shape)}")
    if patch not in PATCHES:
        raise ValueError(f"patch must be one of {PATCHES}, got {patch}")
    for name, n in (("C", c), ("Co", co)):
        if n % 8 or not MIN_CHANNELS <= n <= MAX_CHANNELS:
            raise ValueError(f"{name} must be a multiple of 8 in "
                             f"[{MIN_CHANNELS}, {MAX_CHANNELS}], got {n}")
    if mask_cells.dim() != 3 or mask_cells.shape[0] != b or (
            mask_cells.shape[1] * patch != hh
            or mask_cells.shape[2] * patch != ww):
        raise ValueError(f"mask_cells {tuple(mask_cells.shape)} does not "
                         f"tile x1 {tuple(x1.shape)} at patch {patch}")
    n_cells = mask_cells.shape[1] * mask_cells.shape[2]
    if not 1 <= capacity <= n_cells:
        raise ValueError(f"capacity must be in [1, {n_cells}], got "
                         f"{capacity}")
    if tuple(w2.shape) != (3, 3, c, c) or tuple(w3.shape) != (c, co):
        raise ValueError(f"w2 must be (3, 3, {c}, {c}) and w3 ({c}, {co}), "
                         f"got {tuple(w2.shape)} and {tuple(w3.shape)}")
    for name, t, n in (("a2", a2, c), ("b2", b2, c), ("a3", a3, co),
                       ("b3", b3, co)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
    for t in (identity, mask_cells, w2, a2, b2, w3, a3, b3):
        if t.device != x1.device:
            raise ValueError("all arguments must lie on x1's device")


def _launch(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
            capacity):
    from laudnet_tpu_torch.ops._build import check, library

    _check_cuda(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                capacity)
    b, hh, ww, c = x1.shape
    co = identity.shape[-1]
    n_cells = mask_cells.shape[1] * mask_cells.shape[2]
    dev = x1.device

    # Selection: the first ``capacity`` active cells of each image in
    # raster order, which is what a stable top-k over the 0/1 mask keeps.
    # The selected cells are compacted to the front of ``slots`` and their
    # count stays on the device: the host does not wait for it.
    active = mask_cells.reshape(b, n_cells) > 0.5
    selected = active & (active.cumsum(dim=1) <= capacity)
    flags = selected.reshape(-1).to(torch.uint8)
    n_valid = flags.sum(dtype=torch.int32).reshape(1)
    max_slots = b * capacity
    slots = torch.sort(flags, descending=True, stable=True).indices[
        :max_slots].to(torch.int32)

    # K-major weights: (out, 3 * 3 * in) with the tap outermost, and
    # (out, in)
    w2t = w2.permute(3, 0, 1, 2).reshape(c, 9 * c).contiguous()
    w3t = w3.t().contiguous()
    f32 = lambda t: t.float().contiguous()
    a2, b2, a3, b3 = f32(a2), f32(b2), f32(a3), f32(b3)
    mid = torch.empty((max_slots * patch * patch, c), dtype=torch.bfloat16,
                      device=dev)
    out = torch.empty_like(identity)
    lib = library()
    check(lib, lib.lt_masked_tail(
        x1.data_ptr(), identity.data_ptr(), slots.data_ptr(),
        n_valid.data_ptr(), flags.data_ptr(), w2t.data_ptr(), a2.data_ptr(),
        b2.data_ptr(), w3t.data_ptr(), a3.data_ptr(), b3.data_ptr(),
        mid.data_ptr(), out.data_ptr(), b, hh, ww, c, co, patch, max_slots,
        torch.cuda.current_stream(dev).cuda_stream),
        "bottleneck-tail kernel")
    masked_bottleneck_tail.launches += 1
    return out


def masked_bottleneck_tail(x1: torch.Tensor, identity: torch.Tensor,
                           mask_cells: torch.Tensor, w2, a2, b2, w3, a3, b3,
                           *, patch: int, capacity: int) -> torch.Tensor:
    """The fused sparse tail. Returns ``relu(identity + scattered)``.

    ``x1``: (B, H, W, C) conv1 output (after bn1 and ReLU) of a stride-1
    block; ``identity``: (B, H, W, Co) residual input; ``mask_cells``:
    (B, Hm, Wm) 0/1, the masker's cell decisions, H = Hm * patch; ``w2``:
    (3, 3, C, C) HWIO; ``a2``/``b2``: folded bn2; ``w3``: (C, Co);
    ``a3``/``b3``: folded bn3; ``capacity``: patch slots per image.

    CUDA tensors launch the kernel: bf16, ``patch`` in {1, 2, 4, 7}, C and
    Co multiples of 8 from 64 to 2048, any B, any capacity from 1 to
    Hm * Wm; anything else raises. CPU tensors of any float type run the
    plain version. Eval only: there is no backward."""
    if x1.device.type == "cpu":
        return reference_masked_bottleneck_tail(
            x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch=patch,
            capacity=capacity)
    if x1.device.type != "cuda":
        raise ValueError(f"no kernel for device {x1.device}")
    return _launch(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                   capacity)


masked_bottleneck_tail.launches = 0
