"""Batch-1 layer-skipping inference engines (real compute skipping;
counterpart of `laudnet_tpu/infer/layerskip.py`).

The training graph multiplies skipped blocks by zero; these engines
*actually skip them*: each gate is read to the host and a Python branch
runs the block or not (the JAX engine's ``lax.cond``). Per-sample control
flow only works at batch 1 (SURVEY.md §7 hard-parts #6), the paper's
edge-deployment scenario (TX2/Nano run batch 1,
`DyNetSimulator/eval_example.py:150-156`); for batched serving use the
dense-masked graph. Each gate costs one read of a device value to the
host.

Both read the port's models (`LAUDResNet` in layer mode, `LAUDViT` with
layer gates) and match their eval logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.device import full_f32_convolutions
from laudnet_tpu_torch.infer.export_pruned import _conv
from laudnet_tpu_torch.ops.vit_attention import fused_vit_attention


def _bn(x, bn):
    return ((x - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)
            * bn.weight + bn.bias)


def _batch1(x):
    if x.shape[0] != 1:
        # the gate reads image 0's masker logits; at B>1 every other image
        # would silently inherit its skip decisions
        raise ValueError(
            f"layer-skip engine is batch-1 (got batch {x.shape[0]}); "
            "serve batches of 1, or use the masked graph")


def build_layer_skip_resnet(model):
    """Build ``forward(x) -> (logits, n_blocks_run)`` for a layer-mode
    `LAUDResNet` (f32). ``x``: (1, H, W, 3)."""
    blocks = [getattr(model, n) for names in model.block_names for n in names]

    def block(x, blk):
        # layer gate: GAP -> 1x1 conv -> keep iff logit0 >= logit1
        # (SpatialMasker with mask_size=1, `models/utils.py:35-65`)
        mk = blk.masker_spatial.conv
        pooled = x.mean(dim=(1, 2), keepdim=True)
        logits = _conv(pooled, mk.weight) + mk.bias
        keep = bool(logits[0, 0, 0, 0] >= logits[0, 0, 0, 1])  # host read

        identity = x
        if blk.downsample_conv is not None:
            identity = _bn(_conv(x, blk.downsample_conv.weight,
                                 stride=blk.stride), blk.downsample_bn)
        if not keep:
            return torch.relu(identity), 0
        h = torch.relu(_bn(_conv(x, blk.conv1.weight), blk.bn1))
        h = torch.relu(_bn(_conv(h, blk.conv2.weight, stride=blk.stride,
                                 padding=1), blk.bn2))
        h = _bn(_conv(h, blk.conv3.weight), blk.bn3)
        return torch.relu(h + identity), 1

    @torch.no_grad()
    def forward(x):
        _batch1(x)
        with full_f32_convolutions():
            h = _conv(x, model.conv1.weight, stride=2, padding=3)
            h = torch.relu(_bn(h, model.bn1))
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(
                0, 2, 3, 1)
            n_run = 0
            for blk in blocks:
                h, ran = block(h, blk)
                n_run += ran
            pooled = h.mean(dim=(1, 2))
            logits = pooled @ model.fc.weight.t() + model.fc.bias
        return logits, n_run

    return forward


def build_layer_skip_vit(model):
    """Batch-1 layer-skipping LAUD-ViT engine (real compute skipping).

    The model's layer paradigm gates the attention and MLP branches
    independently per image (`models/laud_vit.py`: ``layer_policy`` on
    the class token, eval ``on >= off``; branch outputs multiplied by
    the gate). At batch 1 this engine reads each gate to the host and a
    skipped branch executes NOTHING — the ViT analog of
    :func:`build_layer_skip_resnet`. The branches are the model's own
    eval arithmetic (its products, LayerNorms and policy in its compute
    dtype); the attention branch runs the fused qkv-direct attention
    (`ops/vit_attention.py::fused_vit_attention`: kernel B4 on a card, in
    the model's compute dtype, bf16 or f32).

    Returns ``forward(x) -> (logits, n_branches_run)`` for ``x`` of
    shape (1, H, W, 3); equals the model's eval logits with
    ``attn_impl='fused'`` (a model without token and head gates).
    """
    from laudnet_tpu_torch.models.laud_vit import _linear, _norm, _policy

    heads, cd = model.num_heads, model.compute_dtype
    sm_scale = (model.dim // heads) ** -0.5

    @torch.no_grad()
    def forward(x):
        _batch1(x)
        x, n, _ = model.embed(x)
        ones = torch.ones((1, n + 1), dtype=torch.float32, device=x.device)
        n_run = 0
        for blk in model.blocks:
            lg = _policy(blk.layer_policy, x[:, 0], cd).reshape(2, 2)
            attn_on, mlp_on = (bool(v) for v in (lg[0] >= lg[1]).cpu())
            if attn_on:
                qkv = _linear(blk.qkv, _norm(blk.norm1, x, cd), cd)
                out = fused_vit_attention(qkv, ones, None, heads, sm_scale)
                x = x + _linear(blk.proj, out, cd)
            if mlp_on:
                u = _linear(blk.fc1, _norm(blk.norm2, x, cd), cd)
                x = x + _linear(blk.fc2, F.gelu(u, approximate="none"), cd)
            n_run += attn_on + mlp_on
        x = _norm(model.norm, x, cd)
        return _linear(model.head, x[:, 0], cd), n_run

    return forward
