"""The DETR family of the port (`laudnet_tpu_torch/detection/detr.py`)
against the JAX package's (`laudnet_tpu/detection/detr.py`) on the CPU, at
JAX's ``tiny_detr`` geometry (dim 32, 8 queries, backbone 1-1-1-1):
every module, the three eval forwards (learned queries, DDQ, Mask2Former)
at 64 x 64 and at 48 x 80 (where the pyramid's levels are not exact
halves: 12x20, 6x10, 3x5, 2x3), ``detr_detect`` and `evaluate_detector`,
the bit-exact ``nms_keep_mask`` and ``hungarian_match``, and the converter
both ways. ``detr_loss`` (denoising groups, the point loss on JAX's
replayed draws, every auxiliary branch) is held to JAX inside the train
steps of `test_torch_detr_train.py`.

Weights are drawn by the port's initialiser, their zero leaves moved off
zero (`jitter`), and carried to flax by `to_flax_tree`; each JAX function
is jitted once per configuration.

The forms' backbones gate in their last stage only (the gates are held
to JAX by the CNN detectors' tests), which keeps XLA's compilation of
each JAX form short.

Tolerances. Module and model outputs: norm-relative error below 1e-5 (the
products and reductions sum in another order than XLA's; 2e-6 measured);
boolean and integer outputs (keep masks, attention masks, selections,
detection indices and classes) exactly equal. The sampler's Function against autograd of the plain formula: values bit for
bit, gradients within 1e-6 by norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_detection_common import (gt_batch, images, jitter,
                                     recorded_draws, rel_err, shake)
from laudnet_tpu.detection import detr as jd
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_tree,
                                                to_flax_variables)
from laudnet_tpu_torch.detection import detr as td

torch.set_num_threads(1)
TINY = dict(num_classes=3, num_queries=8, dim=32, enc_layers=1,
            dec_layers=1, backbone_layers=(1, 1, 1, 1),
            dyn_mode=("static",) * 3 + ("channel",), sparsity_target=0.5)
ODD = (48, 80)
FORMS = {
    "learned_full_encoder": (dict(encoder="full"), ODD),
    "ddq": (dict(query_init="ddq", dec_layers=3), (64, 64)),
    "mask2former": (dict(with_masks=True, out_indices=(0, 1, 2, 3),
                         dec_layers=2, dyn_mode=("static",) * 3
                         + ("layer",)), ODD),
}
REL = 1e-5


def port_module(module, seed):
    """``module``'s parameters from the port's initialiser, zero leaves
    jittered, as a flax params tree (also loaded back)."""
    for m in module.modules():
        if hasattr(m, "init_weights") and m is not module:
            m.init_weights(torch.Generator().manual_seed(seed))
    tree = jitter(to_flax_tree(module), seed)
    load_flax_variables(module, tree)
    return tree


def detr_pair(form, seed=0):
    kw, shape = FORMS[form]
    kw = dict(TINY, **kw)
    model = td.DETRDetector(**kw, image_size=shape, device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    v = shake(to_flax_variables(model), seed)
    jitter(v["params"], seed)
    load_flax_variables(model, v)
    return model, jd.DETRDetector(**kw), v, shape


@pytest.fixture(scope="module")
def eval_outputs():
    """Per form: the port's and JAX's eval outputs on the same input (each
    JAX forward jitted once, XLA's backend at optimisation level 0: the
    same HLO through fewer LLVM passes)."""
    cache = {}

    def get(form):
        if form not in cache:
            model, jmodel, v, shape = detr_pair(form)
            x = images(shape, 3)
            fwd = jax.jit(lambda v, x: {
                k: o for k, o in jmodel.apply(v, x, training=False).items()
                if k != "model_configs"},
                compiler_options={"xla_backend_optimization_level": 0})
            ref = jax.device_get(fwd(v, x))
            with torch.no_grad():
                got = model(torch.from_numpy(x))
            cache[form] = (got, ref, model, v, x)
        return cache[form]

    return get


def assert_outputs_match(got, ref, what=""):
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, dict):
            assert_outputs_match(g, r, f"{what}{k}.")
        elif isinstance(r, (tuple, list)):
            assert len(g) == len(r), k
            for i, (gi, ri) in enumerate(zip(g, r)):
                assert_outputs_match(gi, ri, f"{what}{k}[{i}].")
        elif np.asarray(r).dtype.kind in "biu":
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=what + k)
        else:
            assert g.shape == np.shape(r), what + k
            assert rel_err(g, r) < REL, (what + k, rel_err(g, r))


# --- modules -----------------------------------------------------------------

def test_transformer_layer_matches_flax_with_a_fully_masked_row():
    """Self-attention under a mask with one row masked whole (it averages
    every value uniformly, as flax's ``finfo.min`` fill gives), and
    cross-attention, against flax's layer."""
    layer = td.TransformerLayer(32, device="cpu")
    params = port_module(layer, 1)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 6, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = rng.random((2, 6, 6)) > 0.4
    mask[0, 2] = False  # a row with every cell masked
    cmask = rng.random((2, 6, 9)) > 0.5
    jl = jd.TransformerLayer(dim=32)
    ref = jax.jit(lambda p, q, kv, m, cm: (
        jl.apply({"params": p}, q, attn_mask=m),
        jl.apply({"params": p}, q, kv, attn_mask=cm),
        jl.apply({"params": p}, q, kv)))(params, q, kv, mask, cmask)
    with torch.no_grad():
        tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
        got = (layer(tq, attn_mask=torch.from_numpy(mask)),
               layer(tq, tkv, attn_mask=torch.from_numpy(cmask)),
               layer(tq, tkv))
    for g, r in zip(got, ref):
        assert np.isfinite(g.numpy()).all()
        assert rel_err(g, r) < REL
    # the fully masked row attends to every value with weight 1/6
    with torch.no_grad():
        y = layer.norm1(tq)
        uniform = layer.attn.out(layer.attn.value(y).mean(1))
        full = torch.from_numpy(mask)
        out = layer.attn(y, y, full[:, None])
    torch.testing.assert_close(out[0, 2], uniform[0], rtol=1e-5, atol=1e-6)


def test_bilinear_sampler_point_sample_and_uncertain_points_match_jax(
        monkeypatch):
    """The sampler at border, interior and pixel-centre locations with its
    gradient (half the one-sided gradient at a clipped tie, as
    ``jnp.clip``'s gradient gives op by op),
    ``point_sample`` and ``uncertain_point_coords`` on JAX's replayed
    draws."""
    rng = np.random.default_rng(1)
    value = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (2, 40, 2)).astype(np.float32)
    # exact pixel centres: x - x0 is exactly 0 there
    locs[:, :6] = ((np.arange(6)[:, None] + 0.5)
                   / np.array([7, 5])).astype(np.float32)
    cot = rng.standard_normal((2, 40, 3)).astype(np.float32)

    def jloss(v, l):
        return (jd.bilinear_sample_level(v, l) * cot).sum()

    ref, (rgv, rgl) = jax.jit(jax.value_and_grad(jloss, (0, 1)))(value, locs)
    v = torch.from_numpy(value).requires_grad_()
    l = torch.from_numpy(locs).requires_grad_()
    out = td.bilinear_sample_level(v, l)
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_err((out * torch.from_numpy(cot)).sum(), ref) < 1e-6
    assert rel_err(v.grad, rgv) < 1e-6
    # under jit XLA contracts ``locs * w - 0.5`` into one multiply-add,
    # so the pixel centres are ties op by op only: off them, JAX's jitted
    # gradient
    assert rel_err(l.grad[:, 6:], rgl[:, 6:]) < 1e-6
    # the Function against autograd of the plain formula: the same values
    # bit for bit; the same gradients off the ties, and on a tie (x - x0
    # exactly 0) half of it, as ``jnp.clip``'s gradient takes half there
    v2 = torch.from_numpy(value).requires_grad_()
    l2 = torch.from_numpy(locs).requires_grad_()
    plain = td.bilinear_sample_level_plain(v2, l2)
    (plain * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(out, plain)
    assert rel_err(v.grad, v2.grad) < 1e-6
    assert rel_err(l.grad[:, 6:], l2.grad[:, 6:]) < 1e-6
    torch.testing.assert_close(l.grad[:, :6], l2.grad[:, :6] / 2)

    mlog = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    coords = rng.random((2, 1, 17, 2)).astype(np.float32)
    jp = jax.jit(jd.point_sample)(mlog, coords)
    assert rel_err(td.point_sample(torch.from_numpy(mlog),
                                   torch.from_numpy(coords)), jp) < 1e-6
    with recorded_draws(monkeypatch) as draws:
        jc = jax.jit(lambda k, m: jd.uncertain_point_coords(
            k, m, 20, 3.0, 0.75))(jax.random.PRNGKey(3), mlog)
    replay = td.ReplayDraws(draws)
    tc = td.uncertain_point_coords(replay, torch.from_numpy(mlog), 20, 3.0,
                                   0.75)
    assert replay.used == len(draws) == 2
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_deformable_encoder_layer_matches_flax():
    """`DeformableEncoderLayer` (with `MSDeformAttention`: heads folded
    into the batch, offsets in pixels of each level, the ring bias) over
    the odd pyramid, output and input gradient."""
    shapes = td.detr_level_shapes(ODD, (0, 1, 2, 3))
    assert shapes == [(12, 20), (6, 10), (3, 5), (2, 3)]
    layer = td.DeformableEncoderLayer(32, levels=4, device="cpu")
    layer.attn.init_weights(torch.Generator().manual_seed(2))
    bias = to_flax_tree(layer)["attn"]["sampling_offsets"]["bias"]
    np.testing.assert_array_equal(bias, td._offset_bias(8, 4, 4))
    params = port_module(layer, 2)
    rng = np.random.default_rng(2)
    n = sum(h * w for h, w in shapes)
    x = rng.standard_normal((2, n, 32)).astype(np.float32)
    # off the pixel centres: a sample whose ``x - x0`` is exactly 0 there
    # is a tie of the clip, whose gradient depends on XLA's fusion (the
    # sampler test holds the tie to JAX op by op)
    ref_pts = (td._reference_points(tuple(shapes), torch.device("cpu"))
               .numpy() + rng.uniform(-0.01, 0.01, (2, n, 2))).astype(
        np.float32)
    jl = jd.DeformableEncoderLayer(dim=32)

    def split(flat):
        outs, off = [], 0
        for h, w in shapes:
            outs.append(flat[:, off:off + h * w].reshape(-1, h, w, 32))
            off += h * w
        return outs

    def jf(p, x):
        return jl.apply({"params": p}, x, split(x), ref_pts)

    ref, rgrad = jax.jit(lambda p, x: (jf(p, x), jax.grad(
        lambda x: (jf(p, x) ** 2).sum())(x)))(params, x)
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, split(tx), torch.from_numpy(ref_pts))
    (out ** 2).sum().backward()
    assert rel_err(out, ref) < REL
    assert rel_err(tx.grad, rgrad) < REL


def test_resizes_match_jax_image_resize():
    """Nearest upsampling (half-pixel centres) and the antialiased linear
    downsampling of the mask logits, at sizes that are not exact halves."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    for size in ((6, 10), (12, 20), (7, 9)):
        ref = jax.image.resize(x, (2, size[0], size[1], 4), "nearest")
        got = td.resize_nearest(torch.from_numpy(x), size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    m = rng.standard_normal((2, 3, 12, 20)).astype(np.float32)
    for size in ((6, 10), (3, 5), (2, 3), (12, 7), (12, 20)):
        ref = jax.image.resize(m, (2, 3) + size, "linear")
        got = td.resize_linear(torch.from_numpy(m), size)
        assert rel_err(got, ref) < 1e-6, size


# --- distinct queries and matching --------------------------------------------

def test_nms_keep_mask_bit_for_bit_with_ties_chains_and_eligible():
    """Random boxes with planted score ties and duplicate boxes, a chain,
    and ``eligible`` pools, batched: the keep masks equal JAX's."""
    rng = np.random.default_rng(5)
    b, n = 3, 40
    cxy = rng.uniform(0.2, 0.8, (b, n, 2))
    wh = rng.uniform(0.05, 0.5, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(
        np.float32)
    boxes[:, 5] = boxes[:, 4]  # identical boxes
    scores = rng.uniform(0.1, 1.0, (b, n)).astype(np.float32)
    scores[:, 10:20] = scores[:, :1]  # ties in score
    scores[:, 5] = scores[:, 4]
    eligible = rng.random((b, n)) < 0.6
    jk = jax.jit(jax.vmap(jd.nms_keep_mask, in_axes=(0, 0, None, 0)),
                 static_argnums=2)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    for thr in (0.3, 0.5, 0.8):
        ref = np.asarray(jk(boxes, scores, thr, eligible))
        got = td.nms_keep_mask(tb, ts, thr, torch.from_numpy(eligible))
        np.testing.assert_array_equal(got.numpy(), ref)
        ref = np.asarray(jk(boxes, scores, thr, np.ones((b, n), bool)))
        np.testing.assert_array_equal(td.nms_keep_mask(tb, ts, thr).numpy(),
                                      ref)
    chain = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.5, 0.0, 1.5, 1.0],
                          [1.1, 0.0, 2.1, 1.0]])
    keep = td.nms_keep_mask(chain, torch.tensor([0.9, 0.8, 0.7]), 0.3)
    assert keep.tolist() == [True, False, True]


def test_hungarian_match_bit_for_bit_and_refuses_more_slots():
    """The anti-greedy matrix, integer costs full of ties, random f32
    costs with invalid slots at 1e6, and one host copy for a stack."""
    anti = np.asarray([[[1.0, 2.0], [4.0, 8.0]]], np.float32)
    assert td.hungarian_match(torch.from_numpy(anti)).tolist() == [[1, 0]]
    rng = np.random.default_rng(6)
    ties = rng.integers(0, 3, (4, 9, 5)).astype(np.float32)
    rand = rng.standard_normal((4, 9, 5)).astype(np.float32)
    rand[:, :, 3:] = 1e6
    for cost in (anti, ties, rand):
        ref = np.asarray(jax.jit(jd.hungarian_match)(cost))
        got = td.hungarian_match(torch.from_numpy(cost))
        np.testing.assert_array_equal(got.numpy(), ref)
    stack = td.hungarian_match_many(torch.from_numpy(np.stack([ties, rand])))
    np.testing.assert_array_equal(
        stack[1].numpy(), np.asarray(jd.hungarian_match(rand)))
    with pytest.raises(ValueError, match="num_queries >= max GT slots"):
        td.hungarian_match(torch.zeros((1, 2, 3)))


# --- the detector ------------------------------------------------------------

@pytest.mark.parametrize("form", sorted(FORMS))
def test_eval_forward_matches_jax(eval_outputs, form):
    """Learned queries over the full encoder, DDQ (three decoder layers:
    two distinct-query keep masks, the auxiliary outputs, the NMS-selected
    proposals) and Mask2Former (the deformable encoder over four levels,
    the pixel decoder, masked cross-attention, the per-layer mask
    predictions), the first and last at the odd size: every output."""
    got, ref, model, _, _ = eval_outputs(form)
    assert set(got) == set(ref) | {"model_configs"}
    assert_outputs_match(got, ref)
    if form == "ddq":
        keep = got["distinct_keep"]
        assert keep.shape == (2, 2, 8) and not (keep[1] & ~keep[0]).any()
    if form == "mask2former":
        mlog = got["mask_aux_outputs"][1]["mask_logits"]
        amask = model._mask_attn(mlog)
        assert (~amask).any() and amask.any(-1).all()


def test_refuses_another_input_size():
    model = td.DETRDetector(**TINY, image_size=(64, 64), device="cpu")
    with pytest.raises(ValueError, match="built for"):
        model(torch.zeros((1, 48, 80, 3)))
    with pytest.raises(ValueError, match="needs image_size"):
        td.DETRDetector(**TINY, device="cpu")


def test_detr_detect_matches_jax(eval_outputs):
    """``detr_detect`` on the Mask2Former outputs at the odd size: the
    selected queries and classes exactly, boxes and scores to an ulp."""
    got, ref, *_ = eval_outputs("mask2former")
    outs = {k: ref[k] for k in ("cls_logits", "boxes_cxcywh")}
    # a threshold inside the top scores, so that some are zeroed
    probs = jax.nn.softmax(outs["cls_logits"], -1)[..., :-1].max(-1)
    thr = float(np.median(np.sort(np.asarray(probs), -1)[:, -5:]))
    jdet = jax.jit(lambda o: jd.detr_detect(o, (48.0, 80.0), thr,
                                            max_detections=5))(outs)
    tdet = td.detr_detect({k: torch.from_numpy(np.array(v))
                           for k, v in outs.items()},
                          (48.0, 80.0), thr, max_detections=5)
    for k in ("indices", "classes"):
        np.testing.assert_array_equal(tdet[k].numpy(), np.asarray(jdet[k]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(tdet[k].numpy(), np.asarray(jdet[k]),
                                   rtol=2e-7, atol=1e-6)
    assert (tdet["scores"] == 0).any() and (tdet["scores"] > 0).any()


class _Canned:
    """A flax-like model whose ``apply`` returns given outputs: JAX's
    `evaluate_detector` then decodes, pastes and scores exactly the
    outputs JAX's forward gave, at no compilation of the model."""

    def __init__(self, outputs):
        self.outputs = outputs

    def apply(self, variables, x, training=False):
        return dict(self.outputs)


def test_evaluate_detector_matches_jax(eval_outputs):
    """Mask2Former at the odd size: box and segm mAP (each query's
    whole-image mask pasted over the image) and the FLOPs accounting,
    against JAX's `evaluate_detector` on JAX's outputs for the same
    input; every number within 1e-6 relative."""
    from laudnet_tpu.detection import runner as jrun
    from laudnet_tpu_torch.detection import runner as trun

    got_out, ref, model, _, x = eval_outputs("mask2former")
    boxes, labels, valid, masks = gt_batch(ODD, 6, masks=True)
    batches = [(x, boxes, labels, valid, masks)]
    want = jrun.evaluate_detector(_Canned(ref), {}, {}, batches,
                                  num_classes=3, kind="detr",
                                  score_threshold=0.2)
    got = trun.evaluate_detector(model, batches, num_classes=3, kind="detr",
                                 score_threshold=0.2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-6, err_msg=k)
    assert "segm_mAP" in got and got["n_images"] == 2


def test_converter_both_ways_holds_jax_s_tree():
    """DDQ with masks and denoising groups (every parameter family of the
    module): the port's tree has JAX's leaves and shapes (``init`` under
    ``eval_shape``, a training forward so that ``dn_label_embed`` exists),
    and a JAX-shaped tree of random leaves goes into the port and comes
    back unchanged."""
    kw = dict(TINY, query_init="ddq", dec_layers=2, dn_groups=2,
              with_masks=True, out_indices=(0, 1, 2, 3))
    jm = jd.DETRDetector(**kw)
    dn_gt = {"boxes_xyxy": jnp.zeros((2, 1, 4)),
             "labels": jnp.zeros((2, 1), jnp.int32),
             "valid": jnp.zeros((2, 1))}
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1),
         "gumbel": jax.random.PRNGKey(2)},
        jnp.zeros((2,) + ODD + (3,)), training=True, dn_gt=dn_gt))
    model = td.DETRDetector(**kw, image_size=ODD, device="cpu")
    mine = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
            jax.tree_util.tree_leaves_with_path(to_flax_variables(model))}
    ref = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
           jax.tree_util.tree_leaves_with_path(shapes)}
    assert mine == ref
    rng = np.random.default_rng(8)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    load_flax_variables(model, tree)
    back = to_flax_variables(model)
    for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for key in p:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf, str(p))
