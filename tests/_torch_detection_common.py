"""What the detection parity tests share: the test geometry, variables
for both sides (drawn by the port's initialiser and carried to flax's
layout by `to_flax_variables`, which costs no XLA compilation; JAX's own
``lazy_init`` where a test holds the converter to JAX's tree) moved off
their identity points, JAX's Gumbel, uniform and integer draws recorded in
call order for the port to replay, and comparisons."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_variables)

LAYERS = (1, 1, 1, 1)
NUM_CLASSES = 3
MAX_GT = 4
SQUARE, RECT = (64, 64), (64, 96)
NUM_PROPOSALS = 16


def images(shape, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b,) + tuple(shape) + (3,)).astype(np.float32)


def lazy_variables(module, shape, seed=0, b=2, **kw):
    """``module``'s variables from ``lazy_init`` on a (b, h, w, 3) f32
    input, as nested numpy dicts."""
    v = jax.jit(lambda: module.lazy_init(
        {"params": jax.random.PRNGKey(seed)},
        jax.ShapeDtypeStruct((b,) + tuple(shape) + (3,), jnp.float32),
        training=False, **kw))()
    return jax.tree_util.tree_map(np.array, dict(v))


def port_variables(model, seed=0):
    """Draws ``model``'s parameters with its own initialiser from ``seed``
    and returns them, shaken, as flax variables (numpy), loaded back into
    ``model``."""
    model.init_weights(torch.Generator().manual_seed(seed))
    v = shake(to_flax_variables(model), seed)
    load_flax_variables(model, v)
    return v


def shake(variables, seed=0):
    """Zeroes the gating heads' biases (their gates then close about half
    their decisions) and moves every BatchNorm's affine and statistics off
    identity, in place."""
    rng = np.random.default_rng(seed)

    def walk(tree, masker):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, masker or k.startswith("masker"))
            elif masker and k == "bias":
                tree[k] = np.zeros_like(leaf)
            elif k == "var":
                tree[k] = (rng.random(leaf.shape) + 0.5).astype(np.float32)
            elif k == "mean":
                tree[k] = (rng.standard_normal(leaf.shape) * 0.1).astype(
                    np.float32)
            elif k == "scale":
                tree[k] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)
                           ).astype(np.float32)

    walk(variables, False)
    return variables


@contextlib.contextmanager
def recorded_gumbel(monkeypatch):
    """Every ``jax.random.gumbel`` draw of the functions traced inside the
    block, in call order (an ordered ``jax.debug.callback``)."""
    recorded = []
    original = jax.random.gumbel

    def recording(key, shape=(), dtype=float, **kw):
        out = original(key, shape, dtype, **kw)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), out,
                           ordered=True)
        return out

    monkeypatch.setattr(jax.random, "gumbel", recording)
    try:
        yield recorded
        jax.effects_barrier()
    finally:
        monkeypatch.setattr(jax.random, "gumbel", original)


@contextlib.contextmanager
def recorded_draws(monkeypatch):
    """Every ``jax.random.uniform`` and ``jax.random.randint`` draw of the
    functions traced inside the block, in call order (for a
    `detection.detr.ReplayDraws`)."""
    recorded = []

    def recording(original):
        def draw(*args, **kw):
            out = original(*args, **kw)
            jax.debug.callback(lambda v: recorded.append(np.asarray(v)), out,
                               ordered=True)
            return out
        return draw

    originals = {name: getattr(jax.random, name)
                 for name in ("uniform", "randint")}
    for name, original in originals.items():
        monkeypatch.setattr(jax.random, name, recording(original))
    try:
        yield recorded
        jax.effects_barrier()
    finally:
        for name, original in originals.items():
            monkeypatch.setattr(jax.random, name, original)


def jitter(tree, seed=0, scale=0.05):
    """Moves every all-zero f32 leaf of a flax tree (the zero-initialised
    kernels and biases) to small normal values, in place, so that no
    parameter sits on a point where its gradient or effect vanishes."""
    rng = np.random.default_rng(seed)
    for k, leaf in tree.items():
        if isinstance(leaf, dict):
            jitter(leaf, int(rng.integers(1 << 30)), scale)
        elif leaf.dtype == np.float32 and not leaf.any():
            tree[k] = (rng.standard_normal(leaf.shape) * scale).astype(
                np.float32)
    return tree


def np_(x):
    """A tensor or JAX array as f32 numpy (bool and ints kept)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or \
        x.dtype.name == "bfloat16" else x


def assert_close(got, ref, rtol, atol, what=""):
    np.testing.assert_allclose(np_(got), np_(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def rel_err(got, ref):
    """||got - ref|| / ||ref|| in f64."""
    g, r = np_(got).astype(np.float64), np_(ref).astype(np.float64)
    return float(np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30))


def gt_batch(shape, seed=0, b=2, m=MAX_GT, masks=False):
    """Padded ground truth: 1..m boxes an image (the rest invalid)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    valid = np.zeros((b, m), np.float32)
    gmask = np.zeros((b, m, h, w), np.float32)
    for i in range(b):
        for j in range(int(rng.integers(1, m + 1))):
            bw, bh = rng.integers(w // 6, w // 2), rng.integers(h // 6, h // 2)
            x0, y0 = rng.integers(0, w - bw), rng.integers(0, h - bh)
            boxes[i, j] = (x0, y0, x0 + bw, y0 + bh)
            labels[i, j] = rng.integers(0, NUM_CLASSES)
            valid[i, j] = 1.0
            gmask[i, j, y0:y0 + bh, x0:x0 + bw] = rng.random((bh, bw)) > 0.3
    return (boxes, labels, valid) + ((gmask,) if masks else ())


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


def write_mini_coco(root, n=6, seed=0):
    """A flat-layout COCO directory (``train.json``, ``val.json``,
    ``images/``): ``n`` JPEGs of 40-90 px with 1-3 bright rectangles of 3
    categories, polygon and raw-RLE segmentations."""
    import json

    from PIL import Image

    (root / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    imgs, anns = [], []
    for i in range(n):
        w, h = (int(v) for v in rng.integers(40, 90, 2))
        arr = (rng.random((h, w, 3)) * 80).astype(np.uint8)
        for m in range(1 + i % 3):
            bw, bh = int(rng.integers(8, w // 2)), int(rng.integers(8, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            arr[y0:y0 + bh, x0:x0 + bw, m % 3] = 230
            mask = np.zeros((h, w), np.uint8)
            mask[y0:y0 + bh, x0:x0 + bw] = 1
            seg = ([[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]
                   if (i + m) % 2 else dict(size=[h, w], counts=_rle(mask)))
            anns.append(dict(id=len(anns) + 1, image_id=i,
                             category_id=[3, 7, 8][m % 3],
                             bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0,
                             segmentation=seg))
        Image.fromarray(arr).save(root / "images" / f"img_{i}.jpg",
                                  quality=92)
        imgs.append(dict(id=i, file_name=f"img_{i}.jpg", height=h, width=w))
    ann = dict(images=imgs, annotations=anns,
               categories=[dict(id=c, name=str(c)) for c in (3, 7, 8)])
    for split in ("train", "val"):
        (root / f"{split}.json").write_text(json.dumps(ann))
    return root
