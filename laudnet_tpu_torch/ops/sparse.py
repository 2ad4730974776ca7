"""Fixed-capacity block-sparse execution: gather -> conv -> scatter
(counterpart of `laudnet_tpu/ops/sparse.py`).

Every image contributes exactly ``capacity`` patch slots per block, active
cells first; padding slots are zeroed at scatter time. With ``capacity`` at
least the number of active cells the result equals the dense-masked graph;
the cost is set by the capacity, not by the realised density. Stock
PyTorch, NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def select_patches(mask_cells: torch.Tensor, capacity: int):
    """Picks ``capacity`` cells per image, active ones first in raster
    order (a stable descending sort: the order of ``lax.top_k``).

    ``mask_cells``: (B, Hm, Wm) 0/1 float. Returns ``(idx, valid)``: flat
    cell indices (B, K) int32 and the mask values of the selected cells
    (B, K), so a padding slot (a selected zero) adds nothing at scatter
    time."""
    b, hm, wm = mask_cells.shape
    flat = mask_cells.reshape(b, hm * wm)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    return idx[:, :capacity].to(torch.int32), vals[:, :capacity]


def gather_patches(x: torch.Tensor, idx: torch.Tensor, patch: int,
                   halo: int) -> torch.Tensor:
    """Gathers the ``patch + 2 * halo`` windows around the selected cells.

    ``x``: (B, H, W, C) with H = Hm * patch; ``idx``: (B, K) flat cell
    indices. Returns (B, K, size, size, C); halo reads outside the image
    are zero (conv padding), by gathering from a zero-padded copy."""
    b, h, w, c = x.shape
    wm = w // patch
    size = patch + 2 * halo
    if halo > 0:
        x = F.pad(x, (0, 0, halo, halo, halo, halo))
    idx = idx.long()
    r0 = (idx // wm) * patch  # the pad shift cancels the halo offset
    c0 = (idx % wm) * patch
    d = torch.arange(size, device=x.device)
    rows = r0[:, :, None] + d
    cols = c0[:, :, None] + d
    bidx = torch.arange(b, device=x.device)[:, None, None, None]
    return x[bidx, rows[:, :, :, None], cols[:, :, None, :], :]


def scatter_patches_add(base: torch.Tensor, patches: torch.Tensor,
                        idx: torch.Tensor, valid: torch.Tensor,
                        patch: int) -> torch.Tensor:
    """Scatter-adds computed patches into ``base`` (the residual identity).

    ``base``: (B, H, W, C); ``patches``: (B, K, patch, patch, C);
    ``idx``/``valid`` from `select_patches`. Padding slots are zeroed by
    ``valid``; the indices of one image are distinct, so add equals write
    on active cells and the sum has no order to depend on."""
    b, h, w, c = base.shape
    hm, wm = h // patch, w // patch
    patches = patches * valid[:, :, None, None, None].to(patches.dtype)
    cells = base.reshape(b, hm, patch, wm, patch, c).permute(0, 1, 3, 2, 4, 5)
    cells = cells.reshape(b, hm * wm, patch, patch, c)
    index = idx.long()[:, :, None, None, None].expand_as(patches)
    cells = cells.scatter_add(1, index, patches)
    cells = cells.reshape(b, hm, wm, patch, patch, c).permute(
        0, 1, 3, 2, 4, 5)
    return cells.reshape(b, h, w, c)
