"""The checkpoint-parity gate (`laudnet_tpu_torch/tools/compare_with_torch.py`)
on the CPU without the reference tree: it refuses to run without it, its
plumbing passes and fails as it should against a stand-in reference, and
its conversion of a reference-format file is the JAX package's leaf for
leaf.

The stand-in reference is NOT the reference: it is a tree of the same shape
(``models/utils.py``, ``models/laud_resnet.py`` with ``ResNet`` and
``Bottleneck``) whose ``ResNet`` wraps the port's own model, loaded through
the port's converter, and returns the reference's tuple layout (logits at
0, ``flops_perc`` at 5). It checks the tool's plumbing: that the file, the
inputs, the options and the outputs reach both halves and are compared
with the stated bounds. Whether the port reproduces the reference is what
the tool answers on a machine that has the reference tree (`REF`) and a
released checkpoint. The images are 64x64 (the tool's ``SIZE``) to keep
it cheap."""

import numpy as np
import pytest
import torch

from laudnet_tpu import convert as jconvert
from laudnet_tpu_torch import convert as tconvert
from laudnet_tpu_torch import models
from laudnet_tpu_torch.tools import compare_with_torch as tool

torch.set_num_threads(2)
FLAGS = ["--arch", "uni_resnet50", "--batch", "2", "--device", "cpu",
         "--dyn_mode", "channel-channel-channel-channel",
         "--channel_dyn_granularity", "2-2-2-2",
         "--channel_masker_layers", "2-2-2-2"]

STAND_IN = '''\
"""A stand-in of the reference's models/laud_resnet.py: the port's model
behind the reference's interface (plumbing only, not the reference)."""
import types

import torch

from laudnet_tpu_torch import models
from laudnet_tpu_torch.convert import (convert_resnet_state_dict,
                                       load_flax_variables)

OFFSET = {offset}


class Bottleneck:
    pass


class ResNet(torch.nn.Module):
    def __init__(self, block, layers, num_classes, input_size, lr_mult,
                 **options):
        super().__init__()
        self.kw = dict(layers=tuple(layers), num_classes=num_classes,
                       input_size=input_size,
                       **{{k: tuple(v) for k, v in options.items()}})

    def load_state_dict(self, state, strict=True):
        variables = convert_resnet_state_dict(
            {{k: v.numpy() for k, v in state.items()}},
            channel_masker_layers=self.kw["channel_masker_layers"][0])
        self.net = load_flax_variables(
            models.LAUDResNet(**self.kw, device="cpu"), variables)
        return types.SimpleNamespace(missing_keys=[], unexpected_keys=[])

    def forward(self, x, temperature):
        out = self.net(x.permute(0, 2, 3, 1), temperature, training=False)
        return (out.logits + OFFSET, None, None, None, None, out.flops_perc)
'''


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A channel 2-2-2-2 `uni_resnet50` written by the port's
    `save_pth_tar`, with random BatchNorm statistics."""
    model = models.uni_resnet50(
        dyn_mode=("channel",) * 4, channel_dyn_granularity=(2,) * 4,
        channel_masker_layers=(2,) * 4, input_size=64, device="cpu",
        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    path = tmp_path_factory.mktemp("ckpt") / "laud_r50_channel.pth.tar"
    tconvert.save_pth_tar(tconvert.to_flax_variables(model), str(path))
    return str(path)


def _stand_in(root, offset):
    (root / "models").mkdir(parents=True)
    (root / "models" / "utils.py").write_text('"""Stand-in."""\n')
    (root / "models" / "laud_resnet.py").write_text(
        STAND_IN.format(offset=offset))
    return str(root)


def test_main_refuses_without_the_reference(tmp_path, monkeypatch, capsys,
                                            checkpoint):
    missing = tmp_path / "no_reference"
    monkeypatch.setattr(tool, "REF", str(missing))
    assert tool.main(["--checkpoint", checkpoint] + FLAGS) != 0
    out, err = capsys.readouterr()
    assert str(missing) in err and "PASS" not in out + err


@pytest.mark.parametrize("offset,rc,verdict", [(0.0, 0, "PASS"),
                                               (1e-2, 1, "FAIL")])
def test_main_against_a_stand_in_reference(tmp_path, monkeypatch, capsys,
                                           checkpoint, offset, rc, verdict):
    monkeypatch.setattr(tool, "REF", _stand_in(tmp_path / "ref", offset))
    monkeypatch.setattr(tool, "SIZE", 64)
    assert tool.main(["--checkpoint", checkpoint] + FLAGS) == rc
    out = capsys.readouterr().out
    assert f"PARITY: {verdict}" in out
    assert "top-1 agreement: 100.0%" in out
    assert "max |flops_perc diff|: 0.00e+00" in out
    if offset:
        assert "max |logit diff|: 1.00e-02" in out


def test_port_half_runs_alone(checkpoint, monkeypatch):
    monkeypatch.setattr(tool, "SIZE", 64)
    args = tool.parse_args(["--checkpoint", checkpoint] + FLAGS)
    state = tconvert.load_pth_tar(checkpoint)
    logits, fp = tool.port_outputs(args, state, tool.inputs(args))
    assert logits.shape == (2, 1000) and np.isfinite(logits).all()
    assert fp.shape == (16,) and ((0 < fp) & (fp <= 1)).all()


def test_conversion_is_the_jax_packages(checkpoint):
    args = tool.parse_args(["--checkpoint", checkpoint] + FLAGS)
    ours = tool.port_variables(args, tconvert.load_pth_tar(checkpoint))
    theirs = jconvert.convert_resnet_state_dict(
        jconvert.load_pth_tar(checkpoint), channel_masker_layers=2)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    ours, theirs = dict(leaves(ours)), dict(leaves(theirs))
    assert sorted(ours) == sorted(theirs) and len(ours) > 300
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
