"""The port's input pipeline (`laudnet_tpu_torch/data/`) against the JAX
package's on the CPU: the transforms and every AutoAugment op pixel for
pixel on the same PIL image and seed (tolerance 0: the same Python on the
same Pillow), the image-folder loader's epoch order, batches and shard
split, and the native C++ loader: the port's library and the JAX package's,
each built here with g++, give bit-equal batches; against the PIL path it
is held to the JAX test's bounds (`tests/test_native_loader.py`)."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from laudnet_tpu.data import auto_augment as jaa
from laudnet_tpu.data import loader as jloader
from laudnet_tpu.data import native_loader as jnative
from laudnet_tpu.data import transforms as jtf
from laudnet_tpu_torch.data import auto_augment as taa
from laudnet_tpu_torch.data import loader as tloader
from laudnet_tpu_torch.data import native_loader as tnative
from laudnet_tpu_torch.data import transforms as ttf


def _image(w, h, seed, mode="RGB"):
    """A smooth random image (an upsampled noise field), as the JAX tests
    make theirs."""
    rng = np.random.default_rng(seed)
    shape = (6, 8, 3) if mode == "RGB" else (6, 8)
    base = Image.fromarray(rng.integers(0, 255, shape, np.uint8), mode)
    return base.resize((w, h), Image.BILINEAR)


IMAGES = [(200, 150, "RGB"), (90, 120, "L"), (33, 40, "RGB"),
          (320, 96, "RGB")]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """root/<class>/<image>: 3 classes of 5 images of 40-160 px, one of
    them grayscale, one PNG and one file that is not an image at all."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for c in range(3):
        os.makedirs(root / f"class{c}")
        for i in range(5):
            w, h = (int(v) for v in rng.integers(40, 160, 2))
            mode = "L" if (c, i) == (1, 2) else "RGB"
            ext = "png" if (c, i) == (2, 4) else "jpg"
            _image(w, h, 10 * c + i, mode).save(
                root / f"class{c}" / f"{i}.{ext}", quality=92)
    (root / "class0" / "notes.txt").write_text("not an image")
    return root


# --- transforms and AutoAugment ---------------------------------------------

TRANSFORMS = {
    "train": lambda m: m.train_transform(48),
    "train_unnormalized": lambda m: m.train_transform(40, normalize=False),
    "colorjitter": lambda m: m.train_transform(48, color_jitter=0.4),
    "autoaugment_original": lambda m: m.train_transform(
        48, auto_augment="original"),
    "autoaugment_v0": lambda m: m.train_transform(48, auto_augment="v0"),
    "change_light": lambda m: m.train_transform(48, change_light=True),
    "all_augs": lambda m: m.train_transform(
        48, color_jitter=0.4, auto_augment="original", change_light=True),
    "eval": lambda m: m.eval_transform(48),
    "eval_ratio": lambda m: m.eval_transform(32, crop_ratio=0.5,
                                             normalize=False),
    "ecenter_crop": lambda m: m.ecenter_crop_transform(48),
    "tencrop": lambda m: m.tencrop_transform(32),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_are_pixel_equal_to_jax(name):
    ours, theirs = TRANSFORMS[name](ttf), TRANSFORMS[name](jtf)
    for k, (w, h, mode) in enumerate(IMAGES):
        img = _image(w, h, k, mode)
        for seed in (0, 7, 123_456_789):
            a, b = ours(img, seed), theirs(img, seed)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {k} {seed}")


def test_crop_primitives_and_constants_equal_jax():
    img = _image(150, 110, 3)
    for seed in range(20):  # 10 failed draws fall back to a center crop
        a = ttf.random_resized_crop(img, 32, random.Random(seed),
                                    scale=(0.9, 1.0), ratio=(3.0, 4.0))
        b = jtf.random_resized_crop(img, 32, random.Random(seed),
                                    scale=(0.9, 1.0), ratio=(3.0, 4.0))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for size in (17, 64, 200):
        np.testing.assert_array_equal(
            np.asarray(ttf.resize_shorter(img, size)),
            np.asarray(jtf.resize_shorter(img, size)))
        if size <= 110:
            np.testing.assert_array_equal(
                np.asarray(ttf.center_crop(img, size)),
                np.asarray(jtf.center_crop(img, size)))
    x = np.random.default_rng(1).random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttf.lighting_noise(x, random.Random(5)),
        jtf.lighting_noise(x, random.Random(5)))
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "LIGHTING_EIGVAL",
                 "LIGHTING_EIGVEC"):
        np.testing.assert_array_equal(getattr(ttf, name), getattr(jtf, name))


def test_auto_augment_tables_equal_jax():
    assert taa.POLICIES == jaa.POLICIES
    assert taa.IMAGENET_FILL == jaa.IMAGENET_FILL
    assert set(taa.OPS) == set(jaa.OPS)
    for op in taa.OPS:
        for level in range(11):
            assert (taa.magnitude_to_arg(op, level, random.Random(level))
                    == jaa.magnitude_to_arg(op, level, random.Random(level)))
    with pytest.raises(KeyError):
        taa.magnitude_to_arg("NoSuchOp", 3)


@pytest.mark.parametrize("op", sorted(jaa.OPS))
def test_auto_augment_op_is_pixel_equal_to_jax(op):
    img = _image(64, 48, 2)
    for level in (0, 3, 7, 10):
        for seed in (0, 1):
            a = taa.apply_op(img, op, level, random.Random(seed))
            b = jaa.apply_op(img, op, level, random.Random(seed))
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{op} {level} {seed}")


@pytest.mark.parametrize("config", ["v0", "original"])
def test_auto_augment_policy_is_pixel_equal_to_jax(config):
    ours = taa.auto_augment_transform(config)
    theirs = jaa.auto_augment_transform(config)
    img = _image(56, 56, 4)
    for seed in range(12):
        np.testing.assert_array_equal(
            np.asarray(ours(img, random.Random(seed))),
            np.asarray(theirs(img, random.Random(seed))))


# --- the image-folder loader ------------------------------------------------

def _batches(loader, epoch):
    return [(x.copy(), y.copy()) for x, y in loader.epoch(epoch)]


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs)
    for (a, b), (c, d) in zip(ours, theirs):
        assert a.dtype == c.dtype == np.float32 and b.dtype == d.dtype
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_image_folder_dataset_equals_jax(folder):
    ours = tloader.ImageFolderDataset(str(folder), ttf.eval_transform(32))
    theirs = jloader.ImageFolderDataset(str(folder), jtf.eval_transform(32))
    assert ours.class_to_idx == theirs.class_to_idx
    assert ours.samples == theirs.samples and len(ours) == 15
    for i in (0, 7, 14):
        a, b = ours.load(i, 3), theirs.load(i, 3)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, seed=3),
    dict(batch_size=4, seed=3, shard=(1, 2)),
    dict(batch_size=3, seed=1, shard=(2, 4), drop_last=False),
    dict(batch_size=4, shuffle=False, drop_last=False)],
    ids=["train", "shard", "shard_padded", "val"])
def test_data_loader_epoch_equals_jax(folder, kw):
    ours = tloader.DataLoader(
        tloader.ImageFolderDataset(str(folder), ttf.train_transform(32)),
        num_workers=3, **kw)
    theirs = jloader.DataLoader(
        jloader.ImageFolderDataset(str(folder), jtf.train_transform(32)),
        num_workers=2, **kw)
    assert len(ours) == len(theirs) > 0
    for epoch in (0, 2):
        _same_batches(_batches(ours, epoch), _batches(theirs, epoch))


def test_shard_padding_and_synthetic_batches_equal_jax():
    for n, count in ((7, 2), (8, 2), (10, 3), (1, 4), (0, 2)):
        np.testing.assert_array_equal(
            tloader._pad_order_for_shards(np.arange(n), count),
            jloader._pad_order_for_shards(np.arange(n), count))
    s1 = tloader._pad_order_for_shards(np.arange(7), 2)[1::2]
    assert len(s1) == 4 and s1[-1] == 0     # wrapped from the front
    for (a, b), (c, d) in zip(tloader.synthetic_batches(3, 8, 10, 2, seed=4),
                              jloader.synthetic_batches(3, 8, 10, 2, seed=4)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_loader_raises_a_failed_image_instead_of_hanging(tmp_path):
    """A file PIL cannot read ends the epoch with PIL's error (the JAX
    loader's producer thread would die and leave its consumer waiting);
    a consumer that stops early releases the producer."""
    for c in ("a", "b"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            _image(40, 40, i).save(tmp_path / c / f"{i}.jpg")
    ds = tloader.ImageFolderDataset(str(tmp_path), ttf.eval_transform(16))
    loader = tloader.DataLoader(ds, 2, shuffle=False, num_workers=2)
    batches = loader.epoch(0)
    next(batches)
    batches.close()                         # abandoned mid-epoch
    (tmp_path / "b" / "1.jpg").write_bytes(b"\xff\xd8\xff\xe0garbage")
    with pytest.raises(OSError):
        list(loader.epoch(0))


# --- the native loader -------------------------------------------------------

@pytest.fixture(scope="module")
def native():
    if not (tnative.native_available() and jnative.native_available()):
        pytest.skip(f"g++ or libjpeg missing: {tnative.build_error()}")
    return tnative


def test_native_library_is_the_port_s_own_build(native):
    assert os.path.exists(native._LIB_PATH)
    assert os.path.dirname(native._LIB_PATH).startswith(
        os.path.dirname(os.path.abspath(tnative.__file__)))
    assert os.path.realpath(native._LIB_PATH) != os.path.realpath(
        jnative._LIB_PATH)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_native_batches_bit_equal_to_jax_build(native, folder, train,
                                               normalize):
    ds = tloader.ImageFolderDataset(str(folder), None)
    paths = [p for p, _ in ds.samples]      # a PNG and a grayscale JPEG
    seeds = [1_000_003 * 2 + i for i in range(len(paths))]
    kw = dict(size=40, train=train, normalize=normalize, num_threads=3)
    a = native.NativeBatchTransform(**kw).load(paths, seeds)
    b = jnative.NativeBatchTransform(**kw).load(paths, seeds)
    assert a.shape == (len(paths), 40, 40, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()


def test_native_decode_and_eval_within_the_jax_test_bounds(native, tmp_path):
    p = str(tmp_path / "a.jpg")
    _image(140, 100, 1).save(p, quality=95)
    ours = native.decode_image(p)
    np.testing.assert_array_equal(ours, jnative.decode_image(p))
    with Image.open(p) as img:
        pil = np.asarray(img.convert("RGB"), np.float32)
    assert np.abs(ours - pil).max() <= 1.0 + 1e-6   # test_native_loader:45
    x = native.NativeBatchTransform(64, train=False, normalize=False).load(
        [p], [0])[0]
    with Image.open(p) as img:
        ref = ttf.eval_transform(64, normalize=False)(img)
    assert np.abs(x - ref).max() <= 6.0 / 255.0     # test_native_loader:56
    assert abs(float(x.mean() - ref.mean())) < 1.0 / 255.0
    xn = native.NativeBatchTransform(32, train=False).load([p], [0])[0]
    with Image.open(p) as img:
        refn = ttf.eval_transform(32)(img)
    assert np.abs(xn - refn).max() <= 6.0 / 255.0 / 0.22  # :66


def test_native_png_grayscale_and_corrupt_files(native, tmp_path):
    png = str(tmp_path / "a.png")
    _image(80, 90, 5).save(png)
    gray = str(tmp_path / "gray.jpg")
    _image(70, 60, 9, "L").save(gray, quality=95)
    t = native.NativeBatchTransform(32, train=False, normalize=False)
    with Image.open(png) as img:           # the PIL path, exactly
        np.testing.assert_array_equal(
            t.load([png], [0])[0], ttf.eval_transform(32, normalize=False)(img))
    g = native.decode_image(gray)
    assert g.shape == (60, 70, 3)
    np.testing.assert_array_equal(g[..., 0], g[..., 1])
    with Image.open(gray) as img:
        assert np.abs(g - np.asarray(img.convert("RGB"), np.float32)
                      ).max() <= 1.0 + 1e-6
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0garbage-not-a-real-jpeg")
    assert native.decode_image(bad) is None
    with pytest.raises(OSError):           # PIL rejects it too
        t.load([gray, bad], [0, 1])
    assert t.load([gray], [0]).shape == (1, 32, 32, 3)


def test_native_transform_raises_without_its_library(monkeypatch, tmp_path):
    """Where the library does not build, the native transform refuses
    rather than run PIL on every image under the native pipeline's name
    (the CLI logs the PIL pipeline instead: `train.main.build_loaders`)."""
    monkeypatch.setattr(tnative, "_load_lib", lambda: None)
    monkeypatch.setattr(tnative, "_build_error", "jpeglib.h: No such file")
    p = str(tmp_path / "a.jpg")
    _image(40, 40, 0).save(p)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        tnative.NativeBatchTransform(16).load([p], [0])
    assert not tnative.native_available()


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, train=True, seed=1),
    dict(batch_size=4, train=True, seed=1, shard=(2, 4)),
    dict(batch_size=4, train=False, drop_last=False)],
    ids=["train", "shard_padded", "val"])
def test_native_data_loader_equals_jax(native, folder, kw):
    ds = tloader.ImageFolderDataset(str(folder), None)
    jds = jloader.ImageFolderDataset(str(folder), None)
    ours = native.NativeDataLoader(ds, size=32, num_threads=2, **kw)
    theirs = jnative.NativeDataLoader(jds, size=32, num_threads=2, **kw)
    assert len(ours) == len(theirs) > 0
    _same_batches(_batches(ours, 1), _batches(theirs, 1))
