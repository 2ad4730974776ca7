"""The training CLI on real input and reference checkpoints, on the CPU at
32x32 over a tiny image folder written to a temporary directory:
``train.main.main(--data_url ...)`` trains and validates the ViT and the
CNN flagship through the native and the PIL pipelines (the log names
which), the first batch the trainer receives is what the JAX package's
loader yields for the same arguments, a partial last val batch is weighted
exactly, ``--teacher_path`` and ``--finetune_from`` load reference
``.pth.tar`` files, and ``--evaluate_from`` on one gives the top-1 of the
model the file was written from. JAX's CLI is not run."""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from laudnet_tpu.data import loader as jloader
from laudnet_tpu.data import native_loader as jnative
from laudnet_tpu.data import transforms as jtf
from laudnet_tpu.train import main as jmain
from laudnet_tpu_torch import models
from laudnet_tpu_torch.convert import (load_flax_variables, save_pth_tar,
                                       to_flax_tree, to_flax_variables)
from laudnet_tpu_torch.data import native_loader as tnative
from laudnet_tpu_torch.data.loader import DataLoader
from laudnet_tpu_torch.train import main as tmain

torch.set_num_threads(2)
VIT = ["--arch", "laud_deit_tiny"]
CNN = ["--arch", "uni_resnet50"]


@pytest.fixture(scope="module")
def data_url(tmp_path_factory):
    """train/: 2 classes of 4 images (2 steps of 4); val/: 2 classes of 3
    (a full batch and one of 2 real rows); 24-90 px, one grayscale JPEG
    and one PNG in each split."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 3)):
        for c in range(2):
            os.makedirs(root / split / f"n0{c}")
            for i in range(n):
                w, h = (int(v) for v in rng.integers(24, 90, 2))
                mode = "L" if (c, i) == (0, 1) else "RGB"
                shape = (5, 6, 3) if mode == "RGB" else (5, 6)
                img = Image.fromarray(rng.integers(0, 255, shape, np.uint8),
                                      mode).resize((w, h), Image.BILINEAR)
                ext = "png" if (c, i) == (1, 2) else "jpg"
                img.save(root / split / f"n0{c}" / f"{i}.{ext}", quality=90)
    return str(root)


def _argv(data_url, out, *flags):
    return ["--device", "cpu", "--epochs", "1", "--batch_size", "4",
            "--input_size", "32", "--num_classes", "2", "--print_freq", "1",
            "--seed", "3", "--data_url", data_url, "--train_url", str(out),
            *flags]



def _jax_first_batch(data_url, native):
    """What JAX's CLI feeds its first step for these arguments
    (`laudnet_tpu/train/main.py:328-363`)."""
    train = os.path.join(data_url, "train")
    if native:
        ds = jloader.ImageFolderDataset(train, jtf.train_transform(32))
        loader = jnative.NativeDataLoader(ds, 4, train=True, size=32, seed=3,
                                          shard=(0, 1))
    else:
        ds = jloader.ImageFolderDataset(train, jtf.train_transform(32))
        loader = jloader.DataLoader(ds, 4, seed=3, shard=(0, 1))
    return next(iter(loader.epoch(0)))


@pytest.fixture
def first_batch(monkeypatch):
    """Records the host batch of the trainer's first `to_device` call."""
    seen = []
    to_device = tmain.Training.to_device

    def record(self, images, labels):
        seen.append((images.copy(), labels.copy()))
        return to_device(self, images, labels)

    monkeypatch.setattr(tmain.Training, "to_device", record)
    return seen


@pytest.mark.parametrize("arch", ["vit", "cnn"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_cli_trains_on_an_image_folder(data_url, tmp_path, first_batch, arch,
                                       native):
    if native and not tnative.native_available():
        pytest.skip(f"g++ or libjpeg missing: {tnative.build_error()}")
    flags = VIT if arch == "vit" else CNN
    if not native:
        flags = flags + ["--no_native_loader"]
    best = tmain.main(_argv(data_url, tmp_path, *flags))
    assert np.isfinite(best) and 0.0 <= best <= 100.0
    log = open(tmp_path / "train.log").read()
    pipeline = ("input pipeline: native C++ loader" if native
                else "input pipeline: PIL (data/transforms.py); "
                     "--no_native_loader")
    assert pipeline in log
    assert "disabling KD (alpha_kd=0)" in log   # no --teacher_path
    assert "epoch 0 [1/2]" in log and "[2/2]" not in log
    dens = np.loadtxt(tmp_path / "all_density_latest.txt")
    assert dens.shape == ((4, 12) if arch == "vit" else (4, 16))
    shutil.rmtree(tmp_path / "ckpt")
    images, labels = _jax_first_batch(data_url, native)
    assert first_batch[0][0].dtype == np.float32
    np.testing.assert_array_equal(first_batch[0][0], images)
    np.testing.assert_array_equal(first_batch[0][1], labels)


@pytest.mark.parametrize("why", ["flag", "augmentation", "no_library"])
def test_cli_says_why_it_takes_the_pil_pipeline(data_url, monkeypatch, why):
    flags = {"flag": ["--no_native_loader"],
             "augmentation": ["--colorjitter", "--change_light"],
             "no_library": []}[why]
    if why == "no_library":
        monkeypatch.setattr(tnative, "native_available", lambda: False)
        monkeypatch.setattr(tnative, "_build_error",
                            "loader.cpp:33:10: fatal error: jpeglib.h: No "
                            "such file or directory\ncompilation terminated.")
    lines = []
    args = tmain.parse_args(_argv(data_url, "unused", *VIT, *flags))
    train, val = tmain.build_loaders(args, 4, log=lines.append)
    assert type(train) is type(val) is DataLoader
    assert len(lines) == 1 and lines[0].startswith(
        "input pipeline: PIL (data/transforms.py); ")
    assert {"flag": "--no_native_loader",
            "augmentation": "--colorjitter/--autoaugment/--change_light",
            "no_library": "does not build: loader.cpp:33:10: fatal error: "
                          "jpeglib.h"}[why] in lines[0]


def test_partial_last_val_batch_is_weighted_exactly(data_url):
    for n in (4, 3, 1):
        images = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        labels = np.arange(n, dtype=np.int32)
        for a, b in zip(tmain._pad_val_batch(images, labels, 4),
                        jmain._pad_val_batch(images, labels, 4)):
            np.testing.assert_array_equal(a, b)
    args = tmain.parse_args(_argv(data_url, "unused", *VIT))
    tr = tmain.build_training(args, log=lambda *_: None)
    top1 = tmain._validate(tr)[0]
    # the six val images in one batch of six: no padding at all
    images, labels = zip(*tr.val_loader.epoch(0))
    x, y = tr.to_device(np.concatenate(images), np.concatenate(labels))
    assert x.shape[0] == 6
    whole = float(tr.eval_step(x, y)["top1"])     # an f32 percentage
    correct = round(whole * 6 / 100)
    assert abs(whole * 6 / 100 - correct) < 1e-5
    assert top1 == pytest.approx(100 * correct / 6, rel=1e-12)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The CLI's flagship and its dense ResNet-50 teacher drawn from another
    seed, with random BatchNorm means, in the reference trainer's format
    (the port's `save_pth_tar`)."""
    out = tmp_path_factory.mktemp("refs")
    args = tmain.parse_args(["--device", "cpu", "--num_classes", "2",
                             "--input_size", "32", "--seed", "11", *CNN])
    tr = tmain.build_training(args, log=lambda *_: None)
    flagship, dense = tr.model, tr.teacher
    g = torch.Generator().manual_seed(13)
    for model in (flagship, dense):
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
    paths = {"flagship": out / "flagship.pth.tar",
             "dense": out / "resnet50.pth.tar"}
    save_pth_tar(to_flax_variables(flagship), str(paths["flagship"]), epoch=1)
    save_pth_tar(to_flax_variables(dense), str(paths["dense"]))
    yield flagship, dense, paths
    for p in paths.values():
        p.unlink()


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k


def test_teacher_and_finetune_load_and_train(data_url, tmp_path,
                                             checkpoints):
    flagship, dense, paths = checkpoints
    flags = CNN + ["--teacher_path", str(paths["dense"]),
                   "--finetune_from", str(paths["flagship"])]
    lines = []
    args = tmain.parse_args(_argv(data_url, tmp_path, *flags))
    tr = tmain.build_training(args, log=lines.append)
    _same_weights(tr.teacher, dense)
    _same_weights(tr.model, flagship)
    assert tr.cfg.alpha_kd == 0.5
    assert any("loaded teacher from" in s and "of" in s for s in lines)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tr.teacher(x, training=False),
                           dense(x, training=False))
    del tr
    best = tmain.main(_argv(data_url, tmp_path, *flags))
    assert np.isfinite(best)
    log = open(tmp_path / "train.log").read()
    assert "loaded finetune weights from" in log and "disabling KD" not in log
    shutil.rmtree(tmp_path / "ckpt")


def test_evaluate_from_a_reference_file_gives_its_top1(data_url, tmp_path,
                                                       checkpoints):
    flagship, _, paths = checkpoints
    top1 = tmain.main(_argv(data_url, tmp_path / "eval", *CNN,
                            "--evaluate_from", str(paths["flagship"])))
    assert "evaluate: top1" in open(tmp_path / "eval" / "train.log").read()
    args = tmain.parse_args(_argv(data_url, tmp_path / "ref", *CNN))
    tr = tmain.build_training(args, log=lambda *_: None)
    load_flax_variables(tr.model, to_flax_variables(flagship))
    assert top1 == tmain._validate(tr)[0]
    assert not os.path.exists(tmp_path / "eval" / "ckpt" / "step_2.pt")


def test_evaluate_from_a_timm_deit_merges_the_policy_heads(data_url,
                                                            tmp_path):
    """A plain DeiT file carries no policy heads: the CLI's model keeps its
    initialised ones (same seed as the source here) and takes the rest."""
    source = models.laud_deit_tiny(num_classes=2, img_size=32, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in source.named_parameters():
            if "_policy" not in name:
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    tree = to_flax_tree(source)
    timm = {"patch_embed.proj.weight":
            tree["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
            "patch_embed.proj.bias": tree["patch_embed"]["bias"],
            "cls_token": tree["cls_token"], "pos_embed": tree["pos_embed"],
            "norm.weight": tree["norm"]["scale"], "norm.bias": tree["norm"]["bias"],
            "head.weight": tree["head"]["kernel"].T, "head.bias": tree["head"]["bias"]}
    names = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2", "norm1": "norm1", "norm2": "norm2"}
    for i in range(12):
        for mod, timm_mod in names.items():
            for leaf, v in tree[f"block_{i}"][mod].items():
                timm[f"blocks.{i}.{timm_mod}." + ("bias" if leaf == "bias"
                                                  else "weight")] = (
                    v.T if leaf == "kernel" else v)
    path = tmp_path / "deit_tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in timm.items()}}, path)
    top1 = tmain.main(_argv(data_url, tmp_path / "eval", *VIT,
                            "--evaluate_from", str(path)))
    path.unlink()
    args = tmain.parse_args(_argv(data_url, tmp_path / "ref", *VIT))
    tr = tmain.build_training(args, log=lambda *_: None)
    load_flax_variables(tr.model, {"params": tree})
    assert top1 == tmain._validate(tr)[0]
