"""Block-sparse bottleneck tail (kernel B3; counterpart of
`laudnet_tpu/ops/pallas/masked_block.py`).

For each selected cell of a stride-1 block's spatial mask it computes

    conv2 (3x3 over the haloed window) -> BN -> ReLU -> conv3 (1x1) -> BN

on the cell's ``patch x patch`` pixels and returns
``relu(identity + scattered)``; a cell that is not selected (inactive, or
active beyond ``capacity`` in raster order) comes out as
``relu(identity)``. BN at eval folds into per-channel affines (`fold_bn`).

`masked_bottleneck_tail`, the registered op
``laudnet::masked_bottleneck_tail``, launches the CUDA kernels
(`csrc/masked_block.cu`: the cell selection, then the tail) for CUDA
tensors and runs `reference_masked_bottleneck_tail`, the plain PyTorch
version, for CPU tensors only. Both round where the TPU kernel rounds: the
ReLU output and the second affine's output to the working type, and the
residual add in the working type. `select_cells` runs the selection alone
(plain version: `reference_select_cells`). The module's sparse execution
mode does not come through here: it runs `ops/sparse.py`
(`models/laud_resnet.py`), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.ops import sparse
from laudnet_tpu_torch.ops.library import register

# csrc/masked_block.cu::FUSED_MAX_C: up to this C the tail keeps its
# intermediate in shared memory; above it, in a scratch the wrapper gives
CHANNEL_ALIGN, FUSED_MAX_C = 8, 256
TILE_ROWS = 128  # csrc/masked_block.cu::TBM: rows of the tail's tiles
_MASK_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Folds eval-mode BatchNorm into a per-channel ``(a, b)``:
    ``y = a * x + b``."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


def reference_select_cells(mask_cells: torch.Tensor, capacity: int):
    """The plain version of the selection kernel: the first ``capacity``
    active (> 0.5) cells of each image in raster order, which is what
    ``lax.top_k`` keeps of a 0/1 mask. Returns ``(slots, n_valid,
    selected)``: (B * capacity,) int32 flat cell indices (image * Hm * Wm +
    cell) of the selected cells, image-major, then -1; (1,) int32 their
    count; (B * Hm * Wm,) uint8 1 on a selected cell."""
    b = mask_cells.shape[0]
    active = mask_cells.reshape(b, -1) > 0.5
    chosen = (active & (active.cumsum(dim=1) <= capacity)).reshape(-1)
    idx = torch.nonzero(chosen).reshape(-1).to(torch.int32)
    slots = torch.full((b * capacity,), -1, dtype=torch.int32,
                       device=mask_cells.device)
    slots[:idx.numel()] = idx
    n_valid = torch.tensor([idx.numel()], dtype=torch.int32,
                           device=mask_cells.device)
    return slots, n_valid, chosen.to(torch.uint8)


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


def pad_channels(x1, identity, w2, a2, b2, w3, a3, b3):
    """Zero-pads C and Co to multiples of CHANNEL_ALIGN, which the kernel
    takes (the TPU kernel pads to its 128 lanes). A padded input channel
    has a zero weight and a zero affine, so it adds nothing; a padded
    output channel is zero and is sliced away. Returns the eight tensors,
    padded where their width is ragged."""
    pc = -x1.shape[-1] % CHANNEL_ALIGN
    pco = -identity.shape[-1] % CHANNEL_ALIGN
    if pc:
        x1 = F.pad(x1, (0, pc))
        w2 = F.pad(w2, (0, pc, 0, pc))
        a2, b2 = F.pad(a2, (0, pc)), F.pad(b2, (0, pc))
    if pco:
        identity = F.pad(identity, (0, pco))
        a3, b3 = F.pad(a3, (0, pco)), F.pad(b3, (0, pco))
    if pc or pco:
        w3 = F.pad(w3, (0, pco, 0, pc))
    return x1, identity, w2, a2, b2, w3, a3, b3


def _check_cuda(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                capacity):
    """What the CUDA kernels refuse: other working types than bf16 and
    f32 (integers too), shapes that do not match, a patch that does not
    tile H and W, a capacity outside [1, Hm * Wm], tensors on other
    devices."""
    dtype = x1.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA bottleneck-tail kernel takes bf16 or "
                        f"f32, got x1 {dtype}")
    for name, t in (("identity", identity), ("w2", w2), ("w3", w3)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} like x1, got {t.dtype}")
    for name, t in (("mask_cells", mask_cells), ("a2", a2), ("b2", b2),
                    ("a3", a3), ("b3", b3)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    if x1.dim() != 4 or identity.dim() != 4:
        raise ValueError("x1 and identity must be (B, H, W, C) tensors")
    b, hh, ww, c = x1.shape
    co = identity.shape[-1]
    if tuple(identity.shape[:3]) != (b, hh, ww):
        raise ValueError(f"identity {tuple(identity.shape)} does not match "
                         f"x1 {tuple(x1.shape)}")
    if patch < 1 or hh % patch or ww % patch:
        raise ValueError(f"patch {patch} does not tile {hh}x{ww}")
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


def _dense(t, dtype=None):
    """``t`` contiguous and 16-byte aligned (of ``dtype``): itself when it
    already is, else one copy."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scratch(b, n_cells, capacity, dev, row_tiles=0):
    """The selection's outputs: slots, counts (the count, each image's
    first slot, then ``row_tiles`` counters of the tail) and the flags."""
    return (torch.empty(b * capacity, dtype=torch.int32, device=dev),
            torch.empty(1 + b + row_tiles, dtype=torch.int32, device=dev),
            torch.empty(b * n_cells, dtype=torch.uint8, device=dev))


def _mask_arg(mask_cells):
    mask = _dense(mask_cells if mask_cells.dtype in _MASK_TYPES
                  else mask_cells.float())
    return mask, _MASK_TYPES[mask.dtype]


def select_cells(mask_cells: torch.Tensor, capacity: int):
    """The selection kernel alone; returns what `reference_select_cells`
    returns (``n_valid`` a (1,) view of the kernel's counts). CPU tensors
    run the plain version."""
    if mask_cells.device.type == "cpu":
        return reference_select_cells(mask_cells, capacity)
    if mask_cells.device.type != "cuda":
        raise ValueError(f"no kernel for device {mask_cells.device}")
    from laudnet_tpu_torch.ops._build import check, library

    if mask_cells.dim() != 3 or not mask_cells.is_floating_point():
        raise ValueError("mask_cells must be a (B, Hm, Wm) float tensor")
    b, n_cells = mask_cells.shape[0], mask_cells.shape[1] * mask_cells.shape[2]
    if not 1 <= capacity <= n_cells:
        raise ValueError(f"capacity must be in [1, {n_cells}], got "
                         f"{capacity}")
    mask, mask_type = _mask_arg(mask_cells)
    slots, counts, selected = _scratch(b, n_cells, capacity, mask.device)
    lib = library()
    check(lib, lib.lt_select_cells(
        mask.data_ptr(), mask_type, slots.data_ptr(), counts.data_ptr(),
        selected.data_ptr(), b, n_cells, capacity,
        torch.cuda.current_stream(mask.device).cuda_stream),
        "cell-selection kernel")
    select_cells.launches += 1
    return slots, counts[:1], selected


def _launch(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
            capacity):
    from laudnet_tpu_torch.ops._build import check, library

    _check_cuda(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                capacity)
    co = identity.shape[-1]
    f32 = torch.float32
    x1, identity, w2, w3 = (_dense(t) for t in (x1, identity, w2, w3))
    a2, b2, a3, b3 = (_dense(t, f32) for t in (a2, b2, a3, b3))
    if x1.shape[-1] % CHANNEL_ALIGN or co % CHANNEL_ALIGN:
        x1, identity, w2, a2, b2, w3, a3, b3 = pad_channels(
            x1, identity, w2, a2, b2, w3, a3, b3)
    b, hh, ww, c = x1.shape
    cop = identity.shape[-1]
    n_cells = (hh // patch) * (ww // patch)
    dev = x1.device
    mask, mask_type = _mask_arg(mask_cells)
    # the intermediate in device memory: f32 always, bf16 above FUSED_MAX_C
    # (its rows at the kernel's K-block multiple of 64)
    rows = b * capacity * patch * patch
    slots, counts, selected = _scratch(b, n_cells, capacity, dev,
                                       -(-rows // TILE_ROWS))
    mid = None
    if x1.dtype == f32:
        mid = torch.empty((rows, c), dtype=f32, device=dev)
    elif c > FUSED_MAX_C:
        mid = torch.empty((rows, -(-c // 64) * 64), dtype=x1.dtype,
                          device=dev)
    out = torch.empty_like(identity)
    lib = library()
    check(lib, lib.lt_masked_tail(
        x1.data_ptr(), identity.data_ptr(), mask.data_ptr(), mask_type,
        w2.data_ptr(), a2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
        a3.data_ptr(), b3.data_ptr(), slots.data_ptr(), counts.data_ptr(),
        selected.data_ptr(), None if mid is None else mid.data_ptr(),
        out.data_ptr(), int(x1.dtype == f32), b, hh, ww, c, cop, patch,
        capacity, torch.cuda.current_stream(dev).cuda_stream),
        "bottleneck-tail kernel")
    masked_bottleneck_tail.launches += 1
    return out if cop == co else out[..., :co]


def _tail_cpu(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
              capacity):
    return reference_masked_bottleneck_tail(
        x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch=patch,
        capacity=capacity)


def _tail_cuda(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
               capacity):
    return _launch(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                   capacity)


_tail_op = register(
    "masked_bottleneck_tail(Tensor x1, Tensor identity, Tensor mask_cells, "
    "Tensor w2, Tensor a2, Tensor b2, Tensor w3, Tensor a3, Tensor b3, "
    "int patch, int capacity) -> Tensor", _tail_cpu, _tail_cuda,
    lambda x1, identity, *_: identity.new_empty(identity.shape))


def masked_bottleneck_tail(x1: torch.Tensor, identity: torch.Tensor,
                           mask_cells: torch.Tensor, w2, a2, b2, w3, a3, b3,
                           *, patch: int, capacity: int) -> torch.Tensor:
    """The fused sparse tail. Returns ``relu(identity + scattered)``.

    ``x1``: (B, H, W, C) conv1 output (after bn1 and ReLU) of a stride-1
    block; ``identity``: (B, H, W, Co) residual input; ``mask_cells``:
    (B, Hm, Wm) 0/1, the masker's cell decisions, H = Hm * patch; ``w2``:
    (3, 3, C, C) HWIO; ``a2``/``b2``: folded bn2; ``w3``: (C, Co);
    ``a3``/``b3``: folded bn3; ``capacity``: patch slots per image.

    The registered op ``laudnet::masked_bottleneck_tail``. CUDA tensors
    launch the kernels (two launches: the selection and the tail): bf16 or
    f32 (x1, identity, w2 and w3 of one type), any C and Co (ragged widths
    zero-padded to a multiple of 8 and the output sliced back: a view), any
    patch that tiles H and W, any B, any capacity from 1 to Hm * Wm;
    anything else raises. CPU tensors of any float type run the plain
    version. Eval only: there is no backward."""
    if x1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x1.device}")
    return _tail_op(x1, identity, mask_cells, w2, a2, b2, w3, a3, b3, patch,
                    capacity)


masked_bottleneck_tail.launches = 0
select_cells.launches = 0
