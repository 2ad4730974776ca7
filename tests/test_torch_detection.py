"""Port parity of the CNN detectors' modules
(`laudnet_tpu_torch/detection/`) against the JAX package's
(`laudnet_tpu/detection/`) at test geometry: LAUD-ResNet (1, 1, 1, 1),
64 x 64 and 64 x 96 images, 3 classes, batch 2; both sides run the same
variables (gating biases zeroed, BatchNorms off identity) through
`load_flax_variables` and `to_flax_variables`, which
`test_jax_initial_variables_load_and_round_trip` holds to JAX's own
initial tree; every JAX function runs jitted.

Tolerances, f32: features and raw outputs atol 1e-4 at rtol 1e-4 (the
convolutions sum in another order than XLA's); densities and FLOPs rtol
1e-6 (the same 0/1 masks, means in another order). The decode computes
sigmoid, softmax and exp in f64 rounded to f32 (so that a card and the CPU
decode alike, `detection/retinanet.py`), against XLA's f32 functions:
boxes and scores rtol 1e-6. RoIAlign and the mask targets: COORD_ATOL. NMS keep/alive, the assignments and the
classes agree exactly. bf16 (``dtype=jnp.bfloat16`` against
``compute_dtype=torch.bfloat16``): both sides round after every
convolution, BatchNorm and Dense, in different summation orders, so the
raw outputs agree to 2e-2 of their norm and the gate masks on 99 % of
their decisions; the second stage of a two-stage model is compared on
JAX's proposals, because a bf16 objectness reorders near-equal proposals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_detection_common import (LAYERS, MAX_GT, NUM_CLASSES,
                                     NUM_PROPOSALS, RECT, SQUARE, assert_close,
                                     gt_batch, images, lazy_variables, np_,
                                     port_variables, recorded_gumbel,
                                     rel_err)
from laudnet_tpu.detection import backbone as jb
from laudnet_tpu.detection import fpn as jf
from laudnet_tpu.detection import retinanet as jr
from laudnet_tpu.detection import train as jt
from laudnet_tpu.detection import two_stage as jts
from laudnet_tpu.detection import two_stage_train as jtt
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_batch_stats,
                                                to_flax_variables)
from laudnet_tpu_torch.detection import backbone as tb
from laudnet_tpu_torch.detection import fpn as tf
from laudnet_tpu_torch.detection import retinanet as tr
from laudnet_tpu_torch.detection import train as tt
from laudnet_tpu_torch.detection import two_stage as tts
from laudnet_tpu_torch.detection import two_stage_train as ttt
from laudnet_tpu_torch.ops.gating import ReplayNoise

torch.set_num_threads(1)
ADDITIONAL = ("flops", "dense_flops", "flops_perc", "channel_sparsity",
              "layer_sparsity", "flops_img", "s3_img")
# XLA contracts ``box + grid * h`` into an FMA on the CPU, so a bilinear
# sample's coordinate (up to ~300) may differ by an ulp (~3e-5) and its
# weights by as much over the stride: roi_align and crop_gt_mask agree to
# this absolute bound on values of order 1.
COORD_ATOL = 3e-5
# Training-mode BatchNorm normalises C5 over 8-12 samples a channel, and a
# near-zero batch variance there amplifies the summation-order difference
# (1.6e-4 on a feature of 0.56 measured where oneDNN runs 2-8 threads).
TRAIN_FEATURE_ATOL = 1e-3
BACKBONES = {
    # every dyn_mode in one backbone; the stem and stage 1 frozen
    "mixed_frozen": dict(dyn_mode=("channel", "layer", "spatial", "static"),
                         frozen_stages=1, norm_eval=True),
    # the other order; BatchNorm on batch statistics in training
    "reversed_bn_train": dict(dyn_mode=("static", "spatial", "layer",
                                        "channel"), norm_eval=False),
}


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def test_jax_initial_variables_load_and_round_trip():
    """JAX's initial variables of a Mask R-CNN whose backbone has every
    dyn_mode fill the port's model leaf for leaf (`load_flax_variables` is
    strict both ways) and come back bit for bit, the transposed
    convolution's flipped taps included."""
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS,
              dyn_mode=("channel", "layer", "spatial", "static"),
              with_masks=True, num_proposals=8)
    v = lazy_variables(jts.FasterRCNN(**kw), SQUARE, b=1)
    model = tts.FasterRCNN(**kw, device="cpu")
    load_flax_variables(model, v)
    back = to_flax_variables(model)
    ref = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(got[path], leaf, str(path))
    # flax's transposed convolution: output pixel 2i + a takes tap 1 - a
    deconv = model.mask_head.deconv
    x = torch.zeros(1, 1, 1, deconv.in_channels)
    x[..., 0] = 1.0
    y = deconv(x)[0, ..., 0] - deconv.bias[0]
    k = v["params"]["mask_head"]["deconv"]["kernel"][:, :, 0, 0]
    np.testing.assert_allclose(y.detach().numpy(), k[::-1, ::-1], atol=1e-7)


def backbone_pair(name, seed=0):
    kw = dict(layers=LAYERS, **BACKBONES[name])
    model = tb.LAUDDetBackbone(**kw, device="cpu")
    return jb.LAUDDetBackbone(**kw), port_variables(model, seed), model


def compare_additional(got, ref, what):
    for k in ADDITIONAL:
        assert_close(got[k], ref[k], 1e-6, 0, f"{what} {k}")


@pytest.mark.parametrize("name,shape", [("mixed_frozen", SQUARE),
                                        ("reversed_bn_train", RECT)])
def test_backbone_eval_matches_flax(name, shape):
    jmodel, v, model = backbone_pair(name)
    x = images(shape, 1)
    jfeats, jadd, jcfg = jax.jit(
        lambda v, x: jmodel.apply(v, x, training=False)[:2])(v, x), None, None
    jfeats, jadd = jfeats
    feats, add, cfg = model(t(x))
    assert cfg == {"dyn_mode": BACKBONES[name]["dyn_mode"],
                   "sparsity_target": 0.5}
    assert len(feats) == 4
    for i, (f, jf_) in enumerate(zip(feats, jfeats)):
        assert f.shape == jf_.shape
        assert_close(f, jf_, 1e-4, 1e-4, f"feature {i}")
    compare_additional(add, jadd, name)
    assert 0.0 < float(add["flops"]) < float(add["dense_flops"])


@pytest.mark.parametrize("name,shape", [("mixed_frozen", RECT),
                                        ("reversed_bn_train", SQUARE)])
def test_backbone_training_matches_flax(monkeypatch, name, shape):
    """Training forward on JAX's recorded Gumbel draws: features, the
    statistics, the updated BatchNorm statistics (``norm_eval=False``), and
    no gradient into the frozen stem and stage."""
    jmodel, v, model = backbone_pair(name, seed=2)
    x = images(shape, 3)
    with recorded_gumbel(monkeypatch) as recorded:
        (jfeats, jadd), mut = jax.jit(lambda v, x: (
            lambda o: (o[0][:2], o[1]))(jmodel.apply(
                v, x, training=True, rngs={"gumbel": jax.random.PRNGKey(4)},
                mutable=["batch_stats"])))(v, x)
    noise = ReplayNoise(recorded)
    feats, add, _ = model(t(x), training=True, noise=noise)
    assert noise.used == len(recorded) > 0
    for i, (f, jf_) in enumerate(zip(feats, jfeats)):
        assert_close(f, jf_, 1e-4, TRAIN_FEATURE_ATOL, f"feature {i}")
    compare_additional(add, jadd, name)
    got = dict(jax.tree_util.tree_leaves_with_path(
        to_flax_batch_stats(model)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            mut["batch_stats"]):
        assert_close(got[path], leaf, 1e-5, 1e-6, str(path))
    loss = sum(f.float().sum() for f in feats) + add["flops"] / 1e9
    loss.backward()
    frozen = model.frozen_stages
    for pname, p in model.named_parameters():
        stage = (0 if pname.split(".")[0] in ("conv1", "bn1")
                 else int(pname[5]))
        if stage <= frozen:
            assert p.grad is None or not p.grad.any(), pname
    if frozen >= 1:
        assert model.layer2_0.conv1.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fpn_matches_flax(dtype):
    """Odd level sizes (25 x 42 under 13 x 21): the top-down path crops."""
    jd, td = ((None, None) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32)
             for (h, w, c) in ((50, 84, 64), (25, 42, 96), (13, 21, 128))]
    jmodel = jf.FPN(out_channels=32, dtype=jd)
    v = jax.tree_util.tree_map(np.array, dict(jax.jit(
        lambda: jmodel.init(jax.random.PRNGKey(0), feats))()))
    ref = jax.jit(jmodel.apply)(v, feats)
    model = tf.FPN([64, 96, 128], out_channels=32, device="cpu",
                   compute_dtype=td)
    load_flax_variables(model, v)
    got = model([t(f) for f in feats])
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        if dtype == "f32":
            assert_close(g, r, 1e-4, 1e-4, f"level {i}")
        else:
            assert g.dtype == torch.bfloat16
            assert rel_err(g, r) < 2e-2, i


def test_anchors_bit_for_bit_and_decode():
    shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    for kw in ({}, dict(scales=(8.0,), ratios=(0.5, 1.0, 2.0),
                        base_size_factor=1.0)):
        strides = [8, 16, 32, 64, 128] if not kw else [4, 8, 16, 32, 64]
        ref = np.asarray(jax.jit(lambda: jr.make_anchors(shapes, strides,
                                                         **kw))())
        got = tr.make_anchors(shapes, strides, device="cpu", **kw).numpy()
        np.testing.assert_array_equal(got, ref)
    deltas = np.random.default_rng(6).standard_normal(
        (2,) + ref.shape).astype(np.float32) * 3
    deltas[0, :4, 2:] = [[12.0, -12.0], [4.0, -10.0], [0.0, 0.0],
                         [-30, 30]]  # the clamps
    assert_close(tr.decode_boxes(t(ref), t(deltas)),
                 jax.jit(jr.decode_boxes)(ref, deltas), 1e-6, 1e-5)


def nms_cases(n=200, b=3, seed=7):
    """Random boxes, with planted score ties (equal scores, among them
    zeros and negatives) and IoU chains (each box overlapping the next
    just above the threshold, so the greedy order decides)."""
    rng = np.random.default_rng(seed)
    xy = rng.random((b, n, 2)) * 80
    wh = rng.random((b, n, 2)) * 30 + 1
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.random((b, n)).astype(np.float32)
    scores[:, 10:30] = 0.5                        # a tie block
    scores[:, 30:35] = 0.0                        # dead at the start
    scores[:, 35:38] = -0.1
    for k in range(40, 60):                       # a chain, shift 0.3 of w
        boxes[:, k] = boxes[:, 40] + np.float32([6 * (k - 40), 0] * 2)
        boxes[:, k, 2] = boxes[:, k, 0] + 20
        boxes[:, k, 3] = boxes[:, k, 1] + 20
    scores[:, 40:60] = np.linspace(0.9, 0.8, 20)
    boxes[:, 60:70] = boxes[:, 10:20]             # duplicates, tied scores
    scores[:, 60:70] = 0.5
    return boxes, scores


@pytest.mark.parametrize("threshold,max_out", [(0.5, 100), (0.7, 400)])
def test_nms_bit_for_bit(threshold, max_out):
    boxes, scores = nms_cases()
    jkeep, jalive = jax.jit(jax.vmap(
        lambda b, s: jr.nms(b, s, threshold, max_out)))(boxes, scores)
    keep, alive = tr.nms(t(boxes), t(scores), threshold, max_out)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    assert int(alive.sum()) > 0
    assert max_out < boxes.shape[1] or not alive.all()  # some suppressed
    k1, a1 = tr.nms(t(boxes[1]), t(scores[1]), threshold, max_out)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(jkeep[1]))
    np.testing.assert_array_equal(a1.numpy(), np.asarray(jalive[1]))


def pyramid_and_boxes(seed=8, c=16):
    rng = np.random.default_rng(seed)
    sizes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32)
             for h, w in sizes]
    n = 60
    xy = rng.random((2, n, 2)) * np.float32([96, 64])
    wh = np.exp(rng.uniform(0, np.log(200), (2, n, 2)))  # every level
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, :3] = [[-5, -5, 10, 10], [90, 60, 120, 90], [0, 0, 0, 0]]
    return feats, boxes


@pytest.mark.parametrize("out_size", [7, 14])
def test_roi_align_matches_jax(out_size):
    feats, boxes = pyramid_and_boxes()
    strides = [4, 8, 16, 32]
    ref = jax.jit(jax.vmap(lambda f, b: jts.roi_align(
        f, b, strides, out_size)))(feats, boxes)
    got = tts.roi_align([t(f) for f in feats], t(boxes), strides, out_size)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_close(got, ref, 1e-6, COORD_ATOL)
    one = tts.roi_align([t(f[1]) for f in feats], t(boxes[1]), strides,
                        out_size)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())
    # bf16 features promote to f32 on both sides
    fb = [f.astype(jnp.bfloat16) for f in feats]
    ref_b = jax.jit(jax.vmap(lambda f, b: jts.roi_align(
        f, b, strides, out_size)))([jnp.asarray(f) for f in fb], boxes)
    got_b = tts.roi_align([t(f, torch.float32).bfloat16() for f in feats],
                          t(boxes), strides, out_size)
    assert got_b.dtype == torch.float32 and ref_b.dtype == jnp.float32
    assert_close(got_b, ref_b, 1e-6, COORD_ATOL)


DETECTORS = {
    "retinanet": (jr.RetinaNet, tr.RetinaNet,
                  dict(dyn_mode=("channel",) * 4), RECT),
    "faster_rcnn": (jts.FasterRCNN, tts.FasterRCNN,
                    dict(dyn_mode=("layer",) * 4,
                         num_proposals=NUM_PROPOSALS), SQUARE),
    "mask_rcnn": (jts.FasterRCNN, tts.FasterRCNN,
                  dict(dyn_mode=("spatial",) * 4, with_masks=True,
                       num_proposals=NUM_PROPOSALS), RECT),
}
_VARIABLES = {}


def detector_pair(kind, dtype):
    jcls, tcls, kw, shape = DETECTORS[kind]
    jd, td = ((None, None) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS, **kw)
    jmodel = jcls(**kw, dtype=jd)
    model = tcls(**kw, device="cpu", compute_dtype=td)
    if kind not in _VARIABLES:
        _VARIABLES[kind] = port_variables(model, 1)
    load_flax_variables(model, _VARIABLES[kind])
    return jmodel, _VARIABLES[kind], model, shape


STATIC = ("model_configs", "image_hw", "level_shapes")


def jax_eval(jmodel, v, x):
    return jax.jit(lambda v, x: {k: o for k, o in jmodel.apply(
        v, x, training=False).items() if k not in STATIC})(v, x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(DETECTORS))
def test_detector_eval_matches_flax(kind, dtype):
    jmodel, v, model, shape = detector_pair(kind, dtype)
    x = images(shape, 9)
    ref = jax_eval(jmodel, v, x)
    with torch.no_grad():
        out = model(t(x))
    raw = (("cls_logits", "box_deltas") if kind == "retinanet" else
           ("rpn_obj", "rpn_reg"))
    for k in raw:
        assert out[k].dtype == torch.float32 and ref[k].dtype == jnp.float32
        if dtype == "f32":
            assert_close(out[k], ref[k], 1e-4, 1e-4, k)
        else:
            assert rel_err(out[k], ref[k]) < 2e-2, k
    for k in ("flops_perc", "channel_sparsity", "layer_sparsity"):
        if dtype == "f32":
            assert_close(out["additional"][k], ref["additional"][k], 1e-6, 0,
                         k)
        else:
            assert_close(out["additional"][k], ref["additional"][k], 0,
                         0.01, k)
    if kind == "retinanet":
        return
    if dtype == "f32":
        # the decoded RPN deltas, which agree to 1e-4, times anchor sizes
        # up to 128
        assert_close(out["proposals"], ref["proposals"], 1e-4, 1e-3)
        np.testing.assert_array_equal(np_(out["proposal_valid"]),
                                      np_(ref["proposal_valid"]))
        second = out["cls_logits"], out["box_deltas"], out.get("mask_logits")
        tol = dict(rtol=1e-4, atol=1e-4)
    else:
        # the second stage on JAX's proposals (the module docstring)
        with torch.no_grad():
            feats, _, _ = model.backbone(t(x))
            pyramid = model.neck(feats)
            second = model.roi_heads(pyramid, t(ref["proposals"]), *shape)
    for name, got, want in zip(("cls", "reg", "mask"), second,
                               (ref["cls_logits"], ref["box_deltas"],
                                ref.get("mask_logits"))):
        if want is None:
            assert got is None
        elif dtype == "f32":
            assert_close(got, want, what=name, **tol)
        else:
            assert got.dtype == torch.float32
            assert rel_err(got, want) < 2e-2, name


def raw_outputs(kind, seed=10):
    """Raw detector outputs drawn at random, for both detects."""
    rng = np.random.default_rng(seed)
    if kind == "retinanet":
        shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
        n = sum(h * w for h, w in shapes) * 9
        return {"cls_logits": rng.standard_normal(
                    (2, n, NUM_CLASSES)).astype(np.float32) * 3 - 2,
                "box_deltas": rng.standard_normal(
                    (2, n, 4)).astype(np.float32) * 0.5,
                "level_shapes": shapes}
    p = 48
    xy = rng.random((2, p, 2)) * 60
    props = np.concatenate([xy, xy + rng.random((2, p, 2)) * 40 + 4],
                           -1).astype(np.float32)
    return {"cls_logits": rng.standard_normal(
                (2, p, NUM_CLASSES + 1)).astype(np.float32) * 2,
            "box_deltas": rng.standard_normal(
                (2, p, 4)).astype(np.float32) * 0.3,
            "proposals": props,
            "proposal_valid": rng.random((2, p)) > 0.2,
            "image_hw": (64, 96)}


@pytest.mark.parametrize("kind", ["retinanet", "faster_rcnn"])
def test_detect_matches_jax(kind):
    """Both decodes on the same raw outputs: boxes and scores within the
    f64-vs-f32 transcendental rounding, classes, validity and proposal
    indices exactly."""
    raw = raw_outputs(kind)
    tin = {k: (t(v) if isinstance(v, np.ndarray) else v)
           for k, v in raw.items()}
    if kind == "retinanet":
        ref = jax.jit(lambda c, d: jr.RetinaNet.detect(
            {"cls_logits": c, "box_deltas": d,
             "level_shapes": raw["level_shapes"]}, (64, 96)))(
            raw["cls_logits"], raw["box_deltas"])
        got = tr.RetinaNet.detect(tin, (64, 96))
        exact = ("classes", "valid")
    else:
        ref = jax.jit(lambda c, d, p, pv: jts.FasterRCNN.detect(
            {"cls_logits": c, "box_deltas": d, "proposals": p,
             "proposal_valid": pv, "image_hw": (64, 96)}, max_detections=40))(
            raw["cls_logits"], raw["box_deltas"], raw["proposals"],
            raw["proposal_valid"])
        got = tts.FasterRCNN.detect(tin, max_detections=40)
        exact = ("classes", "indices")
    assert sorted(got) == sorted(ref)
    for k in exact:
        np.testing.assert_array_equal(np_(got[k]), np_(ref[k]), err_msg=k)
    assert_close(got["boxes"], ref["boxes"], 1e-6, 1e-5, "boxes")
    assert_close(got["scores"], ref["scores"], 1e-6, 1e-7, "scores")
    assert (np_(got["scores"]) > 0).any()


def test_assigners_match_jax():
    """assign_targets (RetinaNet), rpn_assign and roi_assign over padded
    GT, with two GTs that force the same anchor."""
    shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    anchors = np.asarray(jr.make_anchors(shapes, [8, 16, 32, 64, 128]))
    boxes, labels, valid = gt_batch(RECT, 11)
    boxes[1, 2] = boxes[1, 1] + np.float32([0.5, 0, 0.5, 0])  # collision
    valid[1, :3] = 1
    ref = jax.jit(jax.vmap(lambda b, l, v: jt.assign_targets(
        anchors, b, l, v, NUM_CLASSES)))(boxes, labels, valid)
    got = tt.assign_targets(t(anchors), t(boxes), t(labels), t(valid),
                            NUM_CLASSES)
    for name, g, r in zip(("cls", "box", "pos", "valid"), got, ref):
        if name == "box":
            assert_close(g * got[2][..., None], np_(r) * np_(ref[2])[..., None],
                         1e-6, 1e-6, name)
        else:
            np.testing.assert_array_equal(np_(g), np_(r), err_msg=name)
    rref = jax.jit(jax.vmap(lambda b, v: jtt.rpn_assign(anchors, b, v)))(
        boxes, valid)
    for g, r in zip(ttt.rpn_assign(t(anchors), t(boxes), t(valid)), rref):
        np.testing.assert_array_equal(np_(g), np_(r))
    props = raw_outputs("faster_rcnn")["proposals"]
    pvalid = (np.arange(48) < 40)[None].repeat(2, 0)
    oref = jax.jit(jax.vmap(lambda p, pv, b, l, v: jtt.roi_assign(
        p, pv, b, l, v, NUM_CLASSES)))(props, pvalid, boxes, labels, valid)
    ogot = ttt.roi_assign(t(props), t(pvalid), t(boxes), t(labels), t(valid),
                          NUM_CLASSES)
    for i, (g, r) in enumerate(zip(ogot, oref)):
        if i == 2:
            assert_close(g, r, 1e-6, 1e-6)
        else:
            np.testing.assert_array_equal(np_(g), np_(r))


def test_losses_match_jax():
    """retinanet_loss and faster_rcnn_loss (with the mask loss, its
    crop_gt_mask targets) on the same random outputs and ground truth."""
    rng = np.random.default_rng(12)
    boxes, labels, valid, gmask = gt_batch(RECT, 13, masks=True)
    add = {"flops": np.float32(3.0e8), "dense_flops": np.float32(5.0e8)}
    r = raw_outputs("retinanet")
    jtot, jm = jax.jit(lambda c, d, b, l, v: jt.retinanet_loss(
        {"cls_logits": c, "box_deltas": d, "level_shapes": r["level_shapes"],
         "additional": add}, b, l, v, num_classes=NUM_CLASSES,
        sparsity_target=0.6))(r["cls_logits"], r["box_deltas"], boxes, labels,
                              valid)
    tot, m = tt.retinanet_loss(
        {"cls_logits": t(r["cls_logits"]), "box_deltas": t(r["box_deltas"]),
         "level_shapes": r["level_shapes"],
         "additional": {k: torch.tensor(v) for k, v in add.items()}},
        t(boxes), t(labels), t(valid), num_classes=NUM_CLASSES,
        sparsity_target=0.6)
    assert_close(tot, jtot, 1e-5, 0)
    for k in jm:
        assert_close(m[k], jm[k], 1e-5, 1e-7, k)

    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    anchors = np.asarray(jr.make_anchors(shapes, [4, 8, 16, 32, 64],
                                         scales=(8.0,), base_size_factor=1.0))
    a = anchors.shape[0]
    f = raw_outputs("faster_rcnn")
    props = f["proposals"]
    props[:, -MAX_GT:] = boxes  # the ground truth the model writes in
    outs = {"rpn_obj": rng.standard_normal((2, a)).astype(np.float32),
            "rpn_reg": rng.standard_normal((2, a, 4)).astype(np.float32) * .2,
            "anchors": anchors, "proposals": props,
            "proposal_valid": f["proposal_valid"],
            "cls_logits": f["cls_logits"], "box_deltas": f["box_deltas"],
            "mask_logits": rng.standard_normal(
                (2, 48, 28, 28, NUM_CLASSES)).astype(np.float32)}
    jtot, jm = jax.jit(lambda o, b, l, v, gm: jtt.faster_rcnn_loss(
        dict(o, additional=add), b, l, v, num_classes=NUM_CLASSES,
        gt_masks=gm))(outs, boxes, labels, valid, gmask)
    tot, m = ttt.faster_rcnn_loss(
        dict({k: t(v) for k, v in outs.items()},
             additional={k: torch.tensor(v) for k, v in add.items()}),
        t(boxes), t(labels), t(valid), num_classes=NUM_CLASSES,
        gt_masks=t(gmask))
    assert sorted(m) == sorted(jm)
    assert_close(tot, jtot, 1e-5, 0)
    for k in jm:
        assert_close(m[k], jm[k], 1e-5, 1e-7, k)
    assert float(m["loss_mask"]) > 0
    # one mask and one box, as the JAX function takes them
    one = jax.jit(lambda g, b: jtt.crop_gt_mask(g, b, 28))(gmask[0, 0],
                                                           boxes[0, 0])
    assert_close(ttt.crop_gt_mask(t(gmask[0, 0]), t(boxes[0, 0]), 28), one,
                 1e-6, COORD_ATOL)
