"""The port's COCO reader (`laudnet_tpu_torch/data/coco.py`) against the
JAX package's on a synthetic mini-COCO written to a temporary directory:
the parse and label map, each resize-padded example (image, boxes, labels,
masks from polygons, raw and compressed RLE), the batches with their
shuffles, wrapped tails and shard split, the mask decoders, and the
directory layouts `open_coco` resolves. Everything must be equal."""

import json

import numpy as np
import pytest
from PIL import Image

from laudnet_tpu.data import coco as jcoco
from laudnet_tpu_torch.data import coco as tcoco


def _rle(mask):
    """Column-major run lengths, zeros first (COCO's raw RLE)."""
    counts, run, val = [], 0, 0
    for x in mask.T.reshape(-1):
        if x == val:
            run += 1
        else:
            counts.append(run)
            run, val = 1, 1 - val
    counts.append(run)
    return counts


def _rle_string(counts):
    """pycocotools' rleToString (the inverse of decode_rle_string)."""
    s = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c5 = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c5 & 0x10)
                        or x == -1 and (c5 & 0x10))
            if more:
                c5 |= 0x20
            s.append(chr(c5 + 48))
    return "".join(s)


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """8 images of 40-90 px, 3 non-contiguous categories, polygon, raw-RLE
    and string-RLE segmentations, a crowd region and an image without
    annotations; written in the flat layout and the standard one."""
    root = tmp_path_factory.mktemp("mini_coco")
    (root / "images").mkdir()
    (root / "annotations").mkdir()
    (root / "val2017").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    ann_id = 1
    for i in range(8):
        w, h = (int(v) for v in rng.integers(40, 90, 2))
        arr = (rng.random((h, w, 3)) * 80).astype(np.uint8)
        for m in range(0 if i == 5 else 1 + i % 4):
            bw, bh = int(rng.integers(6, w // 2)), int(rng.integers(6, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            arr[y0:y0 + bh, x0:x0 + bw, m % 3] = 230
            mask = np.zeros((h, w), np.uint8)
            mask[y0:y0 + bh, x0:x0 + bw] = 1
            kind = (i + m) % 3
            if kind == 0:
                seg = [[x0, y0, x0 + bw, y0, x0 + bw / 2, y0 + bh]]
            elif kind == 1:
                seg = dict(size=[h, w], counts=_rle(mask))
            else:
                seg = dict(size=[h, w], counts=_rle_string(_rle(mask)))
            annotations.append(dict(
                id=ann_id, image_id=i, category_id=[2, 5, 9][m % 3],
                bbox=[x0, y0, bw, bh], area=bw * bh,
                iscrowd=int(i == 3 and m == 0), segmentation=seg))
            ann_id += 1
        name = f"img_{i}.jpg"
        Image.fromarray(arr).save(root / "images" / name, quality=90)
        Image.fromarray(arr).save(root / "val2017" / name, quality=90)
        images.append(dict(id=i, file_name=name, height=h, width=w))
    ann = dict(images=images, annotations=annotations,
               categories=[dict(id=9, name="blue"), dict(id=2, name="red"),
                           dict(id=5, name="green")])
    (root / "train.json").write_text(json.dumps(ann))
    (root / "annotations" / "instances_val2017.json").write_text(
        json.dumps(ann))
    return root


def _datasets(root, filter_empty=True):
    args = (str(root / "train.json"), str(root / "images"))
    return (tcoco.CocoDataset(*args, filter_empty=filter_empty),
            jcoco.CocoDataset(*args, filter_empty=filter_empty))


@pytest.mark.parametrize("filter_empty", [True, False])
def test_parse_and_labels_equal_jax(mini_coco, filter_empty):
    ours, theirs = _datasets(mini_coco, filter_empty)
    assert len(ours) == len(theirs) == (7 if filter_empty else 8)
    assert ours.cat2label == theirs.cat2label == {2: 0, 5: 1, 9: 2}
    assert ours.class_names == theirs.class_names == ["red", "green", "blue"]
    assert ours.images == theirs.images


@pytest.mark.parametrize("target", [(64, 64), (32, 48), (96, 80)])
def test_examples_equal_jax(mini_coco, target):
    ours, theirs = _datasets(mini_coco, filter_empty=False)
    for i in range(len(ours)):
        a = ours.example(i, target, max_gt=3, with_masks=True)
        b = theirs.example(i, target, max_gt=3, with_masks=True)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, image_size=48, with_masks=True, shuffle=True,
         seed=2, epochs=2),
    dict(batch_size=4, image_size=(40, 56), max_gt=2),
    dict(batch_size=2, image_size=32, shard_index=1, shard_count=3,
         shuffle=True, seed=5)],
    ids=["masks_shuffled", "rect", "shard"])
def test_batches_equal_jax(mini_coco, kw):
    ours, theirs = _datasets(mini_coco)
    a = list(tcoco.coco_detection_batches(ours, **kw))
    b = list(jcoco.coco_detection_batches(theirs, **kw))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y) == (5 if kw.get("with_masks") else 4)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def test_mask_decoders_equal_jax():
    rng = np.random.default_rng(3)
    mask = (rng.random((13, 9)) > 0.5).astype(np.uint8)
    counts = _rle(mask)
    s = _rle_string(counts)
    assert tcoco.decode_rle_string(s) == jcoco.decode_rle_string(s) == counts
    np.testing.assert_array_equal(tcoco.decode_rle_counts(counts, 13, 9), mask)
    np.testing.assert_array_equal(tcoco.decode_rle_counts([1, 2, 3], 2, 3),
                                  jcoco.decode_rle_counts([1, 2, 3], 2, 3))
    for seg, h, w in ((dict(size=(13, 9), counts=s), 13, 9),
                      (dict(size=(13, 9), counts=counts), 26, 5),
                      ([[2, 3, 10, 3, 10, 8, 2, 8]], 12, 14),
                      ([[0, 0, 12, 0, 12, 12, 0, 12],
                        [4, 4, 8, 4, 8, 8, 4, 8]], 12, 12),
                      ([[0.5, 0.2, 9.7, 1.1, 3.3, 9.9], [1, 1, 2, 2]], 11, 10)):
        np.testing.assert_array_equal(
            tcoco.segmentation_to_mask(seg, h, w),
            jcoco.segmentation_to_mask(seg, h, w))


def test_open_coco_layouts_equal_jax(mini_coco):
    for split in ("train", "val"):
        ours = tcoco.open_coco(str(mini_coco), split)
        theirs = jcoco.open_coco(str(mini_coco), split)
        assert ours.img_dir == theirs.img_dir
        assert ours.images == theirs.images
    assert len(tcoco.open_coco(str(mini_coco), "val")) == 8  # unfiltered
    with pytest.raises(FileNotFoundError):
        tcoco.open_coco(str(mini_coco), "test2027")
