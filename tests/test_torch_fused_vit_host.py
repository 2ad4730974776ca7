"""The host side of the block engine (`laudnet_tpu_torch/infer/fused_vit.py`,
`ops/vit_block.py`) on the CPU, on the plain versions, at a test geometry
(depth 4, D = 128, 2 heads of 64, 32x32 images in patches of 8, batch 2,
bf16): a segment entry that gathers no tokens hands its token gate to the
segment's first layer (its LN1 launch on a card) instead of computing it
eagerly, with the same logits as one block a layer; and the one-call layer
and segment (``lt_vit_layer``, ``lt_vit_segment``) get scratch buffers
that are aligned and disjoint."""

import numpy as np
import pytest
import torch

from laudnet_tpu_torch.infer import fused_vit
from laudnet_tpu_torch.models import LAUDViT
from laudnet_tpu_torch.ops import vit_block

torch.set_num_threads(2)
GEOM = dict(depth=4, dim=128, num_heads=2, img_size=32, patch_size=8,
            device="cpu")


@pytest.fixture(scope="module")
def model():
    m = LAUDViT(**GEOM, generator=torch.Generator().manual_seed(3))
    m = m.to(torch.bfloat16).eval()
    with torch.no_grad():  # centred gates: about half the tokens close
        for blk in m.blocks:
            blk.token_policy.bias.zero_()
    return m


@pytest.fixture(scope="module")
def images():
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("caps,gathers,firsts", [
    ((1.0,) * 4, 0, [True]),
    ((1.0, 1.0, 0.5, 0.5), 1, [True, False]),
], ids=["mask", "token"])
def test_entry_gate_runs_in_the_segment(model, images, monkeypatch, caps,
                                        gathers, firsts):
    """Only a gather calls `gate_and_select`; every other segment entry
    passes its layer's token policy into the segment, and the logits equal
    the per-layer form's bit for bit."""
    calls, entry_policy = [], []
    seg_ref = vit_block.fused_vit_segment_reference
    sel = fused_vit.gate_and_select

    def counting_select(*a, **kw):
        calls.append(1)
        return sel(*a, **kw)

    def recording_segment(x, mask, params, **kw):
        entry_policy.append("token_policy" in params[0])
        return seg_ref(x, mask, params, **kw)

    monkeypatch.setattr(fused_vit, "gate_and_select", counting_select)
    monkeypatch.setattr(fused_vit, "fused_vit_segment_reference",
                        recording_segment)
    seg = fused_vit.build_fused_vit(model, token_capacity=caps, plain=True)
    out = seg(images)
    assert len(calls) == gathers
    assert entry_policy == firsts
    assert seg.segment_layers == ([4] if gathers == 0 else [2, 2])
    monkeypatch.setattr(fused_vit, "gate_and_select", sel)
    blk = fused_vit.build_fused_vit(model, token_capacity=caps,
                                    segments=False, plain=True)
    assert torch.equal(out, blk(images))
    assert blk.token_counts == seg.token_counts


@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("m,d,hidden", [(128 * 197, 384, 1536),
                                        (128 * 98, 768, 3072),
                                        (2 * 17, 128, 512)])
def test_layer_workspace_is_aligned_and_disjoint(m, d, hidden, segment):
    """`lt_vit_layer`'s buffers, and `lt_vit_segment`'s two alternating
    outputs and two alternating h1s after them."""
    offsets, total = vit_block._layer_workspace(m, d, hidden, segment)
    sizes = (m * d * 2, m * 3 * d * 2, m * d * 2, m * d * 4, m * d * 2,
             m * hidden * 2)  # h1, qkv, attn, x2 (f32), h2, u
    sizes += (m * d * 2,) * (4 if segment else 0)
    assert len(offsets) == len(sizes)
    ends = [o + s for o, s in zip(offsets, sizes)]
    assert all(o % 256 == 0 for o in offsets)
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + 256
