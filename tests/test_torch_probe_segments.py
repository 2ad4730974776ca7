"""The segment probe's bookkeeping
(`laudnet_tpu_torch/tools/probe_segments.py`) on the CPU, on the plain
versions, at a test geometry (depth 4, D = 128, 2 heads of 64, 32x32
images in patches of 8, batch 2, bf16): its forms carry
exactly the JAX probe's keys (`tools/probe_segments.py:62-96`, written out
here), each ``seg`` form is its ``blk`` form bit for bit, only the ``seg``
forms call the segment function, and a ``seg`` form that ran no segment
gives no ratio. The probe itself runs only on a card."""

import numpy as np
import pytest
import torch

from laudnet_tpu_torch.infer import fused_vit
from laudnet_tpu_torch.models import LAUDViT
from laudnet_tpu_torch.tools import probe_segments as probe

torch.set_num_threads(2)
JAX_DEFAULT = {"deit_s_dense_seg", "deit_s_select_seg", "deit_s_snap_seg",
               "deit_b_dense_seg", "deit_s_dense_blk", "deit_s_select_blk",
               "deit_s_snap_blk", "deit_b_dense_blk", "deit_s_dense_ratio",
               "deit_s_snap_ratio", "deit_b_dense_ratio"}
JAX_SWEEP = {"deit_s_dense_seg2", "deit_s_dense_seg3", "deit_s_dense_seg4",
             "deit_s_dense_seg6", "deit_s_snap_seg2", "deit_s_snap_seg3",
             "deit_s_snap_seg4", "deit_s_snap_seg5", "deit_b_dense_seg2",
             "deit_b_dense_seg3", "deit_b_dense_seg4"}
GEOM = dict(depth=4, dim=128, num_heads=2, img_size=32, patch_size=8,
            device="cpu")


@pytest.fixture(scope="module")
def models():
    off = dict(token_skip=False, head_skip=False, layer_skip=False)
    out = {name: LAUDViT(**GEOM, **kw, generator=torch.Generator(
        ).manual_seed(seed)).to(probe.DTYPE).eval()
        for seed, (name, kw) in enumerate((("plain_s", off), ("laud_s", {}),
                                           ("plain_b", off)))}
    with torch.no_grad():  # close the open gates: about half the tokens go
        for blk in out["laud_s"].blocks:
            blk.token_policy.bias.zero_()
    return out


@pytest.fixture(scope="module")
def images():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3))
    return torch.from_numpy(x.astype(np.float32)).to(probe.DTYPE)


@pytest.mark.parametrize("sweep", [False, True])
def test_forms_carry_the_jax_probes_keys(models, sweep):
    forms = probe.build_forms(models, sweep=sweep, plain=True)
    if sweep:
        assert set(forms) == JAX_SWEEP
    else:
        assert set(forms) | {f"{f}_ratio" for f in probe.RATIOS} == \
            JAX_DEFAULT
        assert {probe.blk_of(k) for k in forms if "_seg" in k} == \
            {k for k in forms if k.endswith("_blk")}


@pytest.mark.parametrize("sweep", [False, True])
def test_seg_forms_are_their_blk_forms_and_only_they_segment(
        models, images, monkeypatch, sweep):
    calls = []
    plain_segment = fused_vit.fused_vit_segment_reference

    def counting(*args, **kw):
        calls.append(len(args[2]))
        return plain_segment(*args, **kw)

    monkeypatch.setattr(fused_vit, "fused_vit_segment_reference", counting)
    blk_forms = probe.build_forms(models, plain=True)
    forms = probe.build_forms(models, sweep=sweep, plain=True)
    readings = probe.check_forms(forms, images, blk_forms)
    kept = readings["deit_s_snap_blk"]["logits"]
    assert torch.isfinite(kept.float()).all()
    for key, forward in forms.items():
        del calls[:]
        out = forward(images)
        if key.endswith("_blk"):
            assert calls == [] and forward.segment_layers == []
            continue
        assert calls and calls == forward.segment_layers, key
        assert torch.equal(out, blk_forms[probe.blk_of(key)](images)), key
        assert readings[key]["max_diff"] == 0.0 == readings[key]["bound"]
        assert readings[key]["launches"] == {"segment": 0, "block": 0}
    snap = forms["deit_s_snap_seg5" if sweep else "deit_s_snap_seg"]
    snap(images)
    assert snap.token_counts[-1] < snap.token_counts[0]  # it gathered
    if not sweep:
        assert forms["deit_s_dense_seg"].segment_layers == [4]
        assert forms["deit_s_select_seg"].segment_layers == [3, 1]


def test_no_ratio_from_a_seg_form_that_ran_no_segment(models, images):
    dense_true = fused_vit.build_fused_vit(models["plain_s"], segments=True,
                                           plain=True)
    blk = fused_vit.build_fused_vit(models["plain_s"], segments=False,
                                    plain=True)
    seg_r = dict(probe.run_form(dense_true, images), img_s=2.0)
    blk_r = dict(probe.run_form(blk, images), img_s=1.0)
    assert seg_r["segments"] == []
    with pytest.raises(ValueError, match="no segment"):
        probe.ratio(seg_r, blk_r)
    five = fused_vit.build_fused_vit(models["plain_s"], segments=5,
                                     plain=True)
    assert probe.ratio(dict(probe.run_form(five, images), img_s=2.0),
                       blk_r) == 2.0


def test_probe_refuses_the_cpu():
    with pytest.raises(SystemExit, match="CPU"):
        probe.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="does not run on 'cpu'"):
        probe.run(device="cpu")
