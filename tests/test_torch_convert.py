"""The port's reference-checkpoint converters (`laudnet_tpu_torch/convert/`
`torch_loader.py`, `vit_loader.py`, `torch_export.py`) against the JAX
package's on the CPU. Weights come from the port's seeded initialiser and
reach flax's layout through `to_flax_tree`; a ``.pth.tar`` written by JAX's
`save_pth_tar` loads through the port's converter into a model whose state
dict equals `load_flax_variables` of the same tree bit for bit (logits in
f32 too), and the port's `save_pth_tar` writes what JAX's `load_pth_tar`
reads back to the same arrays. Every conversion is a layout transpose, so
there is no tolerance anywhere."""

import re

import numpy as np
import pytest
import torch

from laudnet_tpu import convert as jconvert
from laudnet_tpu_torch import convert as tconvert
from laudnet_tpu_torch import models
from laudnet_tpu_torch.convert import (load_flax_variables,
                                       to_flax_tree, to_flax_variables)

torch.set_num_threads(2)
RESNETS = {
    "flagship": {},
    "channel_modes": dict(dyn_mode=("both", "both", "channel", "layer"),
                          channel_masker=("MLP", "conv_linear", "MLP", "MLP"),
                          channel_masker_layers=(2, 2, 1, 1),
                          channel_dyn_granularity=(1, 2, 1, 1)),
}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _randomise_statistics(model, seed):
    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model


def _resnet(kw, seed):
    return models.uni_resnet50(num_classes=10, input_size=32, device="cpu",
                               generator=torch.Generator().manual_seed(seed),
                               **kw)


@pytest.fixture(scope="module", params=list(RESNETS))
def resnet(request, tmp_path_factory):
    """A seeded LAUD-ResNet-50 with random BatchNorm statistics, its flax
    tree, and that tree written by JAX's `save_pth_tar`."""
    kw = RESNETS[request.param]
    source = _randomise_statistics(_resnet(kw, 0), 1)
    variables = to_flax_variables(source)
    path = tmp_path_factory.mktemp("ckpt") / "resnet.pth.tar"
    jconvert.save_pth_tar(variables, str(path), epoch=3, best_prec1=1.5)
    yield kw, variables, path
    path.unlink()


def test_resnet_checkpoint_loads_bit_for_bit(resnet):
    kw, variables, path = resnet
    state = tconvert.load_pth_tar(str(path))
    j_state = jconvert.load_pth_tar(str(path))
    assert sorted(state) == sorted(j_state)
    loaded = tconvert.convert_resnet_state_dict(state)
    _same_tree(loaded, jconvert.convert_resnet_state_dict(j_state))
    _same_tree(loaded, variables)
    ours = load_flax_variables(_resnet(kw, 5), loaded)
    ref = load_flax_variables(_resnet(kw, 6), variables)
    _same_state(ours, ref)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = ours(x, 0.1, training=False), ref(x, 0.1, training=False)
    assert torch.equal(a.logits, b.logits)


def test_port_export_is_the_jax_export(resnet, tmp_path):
    kw, variables, _ = resnet
    ours = tconvert.export_resnet_state_dict(variables)
    theirs = jconvert.export_resnet_state_dict(variables)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    path = tmp_path / "port.pth.tar"
    tconvert.save_pth_tar(variables, str(path), epoch=7)
    back = jconvert.load_pth_tar(str(path))
    assert sorted(back) == sorted(theirs)
    for k in back:
        np.testing.assert_array_equal(back[k], theirs[k], err_msg=k)
    assert torch.load(path, weights_only=False)["epoch"] == 7
    path.unlink()


def test_detection_backbone_and_merge_equal_jax(resnet):
    _, variables, path = resnet
    state = tconvert.load_pth_tar(str(path))
    prefixed = {("backbone." if i % 2 else "module.backbone.") + k: v
                for i, (k, v) in enumerate(state.items())}
    prefixed["neck.lateral.weight"] = np.zeros((4, 4), np.float32)
    ours = tconvert.convert_detection_backbone_state_dict(prefixed)
    _same_tree(ours, jconvert.convert_detection_backbone_state_dict(prefixed))
    backbone = {k: v for k, v in variables["params"].items() if k != "fc"}
    _same_tree(ours["params"]["backbone"], backbone)
    _same_tree(ours["batch_stats"]["backbone"], variables["batch_stats"])

    # strict=False: only the paths the base has, reshaped to its leaves
    base = to_flax_variables(_resnet(RESNETS["flagship"], 9))
    loaded = {"params": dict(variables["params"], extra={"w": np.ones(3)})}
    loaded["params"]["fc"] = {"kernel": variables["params"]["fc"]["kernel"]
                              .reshape(-1), "bias": np.zeros(10, np.float64)}
    merged = tconvert.merge_variables(base, loaded)
    _same_tree(merged, jax_to_numpy(jconvert.merge_variables(base, loaded)))
    assert merged["params"]["fc"]["bias"].dtype == np.float32
    assert "extra" not in merged["params"]


def jax_to_numpy(tree):
    return {k: jax_to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def test_load_pth_tar_unwraps_payloads_like_jax(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    for name, payload in (
            ("raw", {"module.fc.weight": w, "fc.bias": torch.ones(2)}),
            ("state_dict", {"state_dict": {"module.fc.weight": w},
                            "epoch": 2}),
            ("model", {"model": {"fc.weight": w}, "args": "namespace"})):
        path = tmp_path / f"{name}.pth"
        torch.save(payload, path)
        ours, theirs = (m.load_pth_tar(str(path)) for m in (tconvert,
                                                             jconvert))
        assert sorted(ours) == sorted(theirs) and "fc.weight" in ours
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
        path.unlink()


# --- RegNet -------------------------------------------------------------------

def _regnet(seed):
    return models.lad_regnet_y_400mf(
        num_classes=10, input_size=32, dyn_mode=("channel",) * 4,
        channel_dyn_granularity=(2,) * 4, channel_masker_layers=(2,) * 4,
        device="cpu", generator=torch.Generator().manual_seed(seed))


def _regnet_reference_state(variables):
    """The reference LAUD-RegNet's state-dict names (`laud_regnet.py`:
    ``stem.0/1``, ``trunk_output.blockS.blockS-B.{proj.0/1, f.{a,b,c}.{0,1},
    f.se.fc1/fc2, f.masker_channel.conv.0/2}``, ``fc``) for a flax tree."""
    out = {}
    leaf_name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "mean": "running_mean", "var": "running_var"}
    for coll in ("params", "batch_stats"):
        for path, v in _leaves(variables[coll]):
            *mods, leaf = path.split("/")
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                v = v.T
            leaf = leaf_name[leaf]
            m = re.fullmatch(r"stage(\d+)_(\d+)", mods[0])
            if not m:
                name = {"stem_conv": "stem.0", "stem_bn": "stem.1",
                        "fc": "fc"}[mods[0]]
                out[f"{name}.{leaf}"] = v
                continue
            pre = f"trunk_output.block{m[1]}.block{m[1]}-{m[2]}."
            mod = mods[1]
            if mod in ("proj_conv", "proj_bn"):
                name = "proj." + ("0" if mod == "proj_conv" else "1")
            elif mod[0] in "abc" and mod[1:] in ("_conv", "_bn"):
                name = f"f.{mod[0]}." + ("0" if mod.endswith("conv") else "1")
            elif mod == "se":
                name = f"f.se.{mods[2]}"
            else:
                name = "f.masker_channel.conv." + {"fc1": "0", "fc2": "2"}[
                    mods[2]]
            out[pre + f"{name}.{leaf}"] = v
    return out


def test_regnet_checkpoint_loads_bit_for_bit(tmp_path):
    source = _randomise_statistics(_regnet(0), 2)
    variables = to_flax_variables(source)
    state = _regnet_reference_state(variables)
    state["stem.1.num_batches_tracked"] = np.asarray(0)
    path = tmp_path / "regnet.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in state.items()}}, path)
    loaded = tconvert.convert_regnet_state_dict(tconvert.load_pth_tar(
        str(path)))
    path.unlink()
    _same_tree(loaded, jconvert.convert_regnet_state_dict(state))
    _same_tree(loaded, variables)
    _same_state(load_flax_variables(_regnet(3), loaded),
                load_flax_variables(_regnet(4), variables))
    with pytest.raises(KeyError, match="unmapped regnet keys"):
        tconvert.convert_regnet_state_dict({"trunk_output.block1.block1-0."
                                            "f.gamma": np.ones(2)})


# --- DeiT from timm names -------------------------------------------------------

def _timm_state(params):
    """A timm DeiT state dict for the flax tree's non-policy leaves, plus
    keys that have no LAUDViT analog (distillation token and head)."""
    out = {"patch_embed.proj.weight":
           params["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
           "patch_embed.proj.bias": params["patch_embed"]["bias"],
           "cls_token": params["cls_token"], "pos_embed": params["pos_embed"],
           "norm.weight": params["norm"]["scale"],
           "norm.bias": params["norm"]["bias"],
           "head.weight": params["head"]["kernel"].T,
           "head.bias": params["head"]["bias"],
           "dist_token": np.zeros((1, 1, 192), np.float32),
           "head_dist.weight": np.zeros((10, 192), np.float32)}
    timm = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
            "fc2": "mlp.fc2"}
    for name, block in params.items():
        m = re.fullmatch(r"block_(\d+)", name)
        if not m:
            continue
        for mod, tensors in block.items():
            if mod.endswith("_policy"):
                continue
            for leaf, v in tensors.items():
                key = (f"blocks.{m[1]}.{timm.get(mod, mod)}."
                       + ("weight" if leaf in ("kernel", "scale") else leaf))
                out[key] = v.T if leaf == "kernel" else v
    return out


def _deit(seed):
    return models.laud_deit_tiny(num_classes=10, img_size=32, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))


def test_deit_from_timm_names_keeps_the_policy_heads():
    source = to_flax_tree(_deit(0))
    state = _timm_state(source)
    loaded = tconvert.convert_vit_state_dict(state)
    _same_tree(loaded, jconvert.convert_vit_state_dict(state))
    target = _deit(1)
    fresh = to_flax_tree(target)
    merged = tconvert.merge_variables(fresh, loaded["params"])
    load_flax_variables(target, {"params": merged})
    back = dict(_leaves(to_flax_tree(target)))
    for k, v in _leaves(source):
        want = dict(_leaves(fresh))[k] if "_policy/" in k else v
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    bad = dict(state, **{"blocks.0.ls1.gamma": np.ones(192, np.float32)})
    for m in (tconvert, jconvert):
        with pytest.raises(ValueError, match="not plain-DeiT-shaped"):
            m.convert_vit_state_dict(bad)
