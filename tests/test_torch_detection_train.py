"""The detection training step as a whole: one step of the port's
`detection.runner.make_detector_train_step` against one of
`laudnet_tpu.detection.runner.make_detector_train_step` per kind
(RetinaNet, Faster R-CNN, Mask R-CNN), f32 and under ``amp``, from the same
variables (gating biases zeroed, BatchNorms off
identity, in both layouts through `load_flax_variables` and
`to_flax_variables`), the same batch, and the same
Gumbel draws (JAX's step runs jitted while ``jax.random.gumbel`` records
each draw through an ordered ``jax.debug.callback``; the port replays
them). The backbones run in channel, layer and spatial mode.

Tolerances. f32: the loss and every metric rtol 1e-4 (convolutions and
the loss sums in another order than XLA's); each parameter after the
update within PARAM_ATOL + 1e-4 of the JAX one relative, and the update itself
(after - before) leaf by leaf as UPDATE_REL and UPDATE_ATOL say.
amp: both sides round to bf16 after every convolution and BatchNorm in
different orders, so the loss parts agree to 3e-2 relative and the update
as AMP_UPDATE_REL says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_detection_common import (LAYERS, MAX_GT, NUM_CLASSES, RECT,
                                     SQUARE, gt_batch, images,
                                     port_variables, recorded_gumbel)
from laudnet_tpu.detection import retinanet as jr
from laudnet_tpu.detection import runner as jrun
from laudnet_tpu.detection import two_stage as jts
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_tree)
from laudnet_tpu_torch.detection import retinanet as tr
from laudnet_tpu_torch.detection import runner as trun
from laudnet_tpu_torch.detection import two_stage as tts
from laudnet_tpu_torch.ops.gating import ReplayNoise
from laudnet_tpu_torch.train.trainer import TrainState

torch.set_num_threads(1)
# the RPN's best MAX_GT proposals and the MAX_GT ground-truth slots: the
# mask head's 3x3 convolutions over every RoI are most of a step's time
PROPOSALS = 2 * MAX_GT
KINDS = {
    "retinanet": (jr.RetinaNet, tr.RetinaNet, "retinanet",
                  dict(dyn_mode=("channel",) * 4), RECT),
    "faster_rcnn": (jts.FasterRCNN, tts.FasterRCNN, "faster_rcnn",
                    dict(dyn_mode=("layer",) * 4,
                         num_proposals=PROPOSALS), SQUARE),
    "mask_rcnn": (jts.FasterRCNN, tts.FasterRCNN, "faster_rcnn",
                  dict(dyn_mode=("spatial",) * 4, with_masks=True,
                       num_proposals=PROPOSALS), RECT),
}
# f32: each leaf's update (after - before) within UPDATE_REL of JAX's by
# norm, plus UPDATE_ATOL. Two kinds of leaf have small updates that the
# summation order moves by percents: a saturated Gumbel gate's (its soft
# sample is 1 - 1e-7 or so, and its gradient, through y (1 - y), takes the
# last bits of y: 6e-2 of a 5e-8 update measured) and a BatchNorm scale's
# (its gradient sums dy * x_hat over a feature map with cancellation, and
# oneDNN sums in another order with more threads: 5e-3 of a 5e-5..8e-5
# update at 4 threads, 4e-4 at most elsewhere). amp: the whole update
# within AMP_UPDATE_REL of JAX's by norm (0.05-0.07 measured); JAX's own
# bf16 step lies 0.056 from its f32 step by the same measure, so leaf by
# leaf the bf16 updates carry no finer information.
UPDATE_REL, UPDATE_ATOL, AMP_UPDATE_REL = 3e-3, 1e-6, 0.1
# A zero-initialised bias after one step is its own update, ~1e-4; one
# channel's gradient, a sum with cancellation, moved 4e-6 between oneDNN
# thread counts.
PARAM_ATOL = 1e-5
CFG = dict(num_classes=NUM_CLASSES, base_lr=0.02, lr_mult=0.3, epochs=1,
           steps_per_epoch=4, warmup_steps=2, sparsity_target=0.6)
_VARIABLES = {}


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_train_step_matches_jax(monkeypatch, name, amp):
    jcls, tcls, kind, kw, shape = KINDS[name]
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS, **kw)
    model = tcls(**kw, device="cpu",
                 compute_dtype=torch.bfloat16 if amp else None)
    if name not in _VARIABLES:
        _VARIABLES[name] = port_variables(model, 3)
    v = _VARIABLES[name]
    masks = name == "mask_rcnn"
    x = images(shape, 4)
    batch = gt_batch(shape, 5, masks=masks)

    # --- JAX: one jitted step, the Gumbel draws recorded ------------------
    jmodel = jcls(**kw, dtype=jnp.bfloat16 if amp else None)
    jcfg = jrun.DetTrainConfig(**CFG, with_masks=masks)
    jopt = jrun.make_detection_sgd(v["params"], lr_mult=CFG["lr_mult"])
    state = (jnp.zeros((), jnp.int32), v["params"], v["batch_stats"],
             jopt.init(v["params"]))
    with recorded_gumbel(monkeypatch) as recorded:
        jstep = jax.jit(jrun.make_detector_train_step(jmodel, jopt, jcfg,
                                                      kind, seed=1))
        state, jm = jstep(state, x, *batch)
        jm = {k: float(val) for k, val in jm.items()}

    # --- the port: the same step on the replayed draws --------------------
    load_flax_variables(model, v)
    opt = trun.make_detection_sgd(model, lr_mult=CFG["lr_mult"])
    noise = ReplayNoise(recorded)
    step = trun.make_detector_train_step(
        model, opt, trun.DetTrainConfig(**CFG, with_masks=masks), kind,
        noise=noise)
    tstate = TrainState(step=0, model=model, optimizer=opt)
    m = step(tstate, *trun.batch_to_device((x,) + batch, "cpu"))
    assert noise.used == len(recorded) > 0
    assert tstate.step == 1 == int(state[0])
    assert sorted(m) == sorted(jm)
    rtol = 3e-2 if amp else 1e-4
    for k in jm:
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)
    assert jm["flops_rate"] < 1.0  # the gates closed something
    if masks:
        assert jm["loss_mask"] > 0

    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_tree(model)))
    ref = jax.tree_util.tree_leaves_with_path(state[1])
    before = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    assert len(got) == len(ref)
    num = den = 0.0
    for path, leaf in ref:
        leaf = np.asarray(leaf)
        du, ju = got[path] - before[path], leaf - before[path]
        num, den = num + np.sum((du - ju) ** 2), den + np.sum(ju ** 2)
        if amp:
            continue
        np.testing.assert_allclose(got[path], leaf, rtol=1e-4,
                                   atol=PARAM_ATOL, err_msg=str(path))
        diff, size = np.linalg.norm(du - ju), np.linalg.norm(ju)
        assert diff <= UPDATE_REL * size + UPDATE_ATOL, (path, diff, size)
    assert np.sqrt(num / den) < (AMP_UPDATE_REL if amp else UPDATE_REL)
    assert den > 0


def test_param_groups_and_lr_schedule_match_jax():
    """The three optimizer groups by parameter (JAX's labels of the same
    tree), and the 1x schedule at every step of three runs."""
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS,
              dyn_mode=("channel", "layer", "spatial", "static"),
              with_masks=True, num_proposals=8)
    model = tts.FasterRCNN(**kw, device="cpu")
    jlabels = dict(jax.tree_util.tree_leaves_with_path(
        jrun.detection_param_labels(to_flax_tree(model))))
    labels = trun.detection_param_labels(model)
    # the label depends on the module path alone, which both layouts share
    by_module = {".".join(k.key for k in path[:-1]): label
                 for path, label in jlabels.items()}
    assert len(labels) == len(jlabels)
    for name, label in labels.items():
        assert label == by_module[name.rpartition(".")[0]], name
    assert set(jlabels.values()) == {"backbone", "masker", "head"}
    opt = trun.make_detection_sgd(model, lr_mult=0.25)
    groups = {g["name"]: g for g in opt.param_groups}
    assert {k: g["lr_mult"] for k, g in groups.items()} == {
        "backbone": 0.25, "masker": 1.0, "head": 1.0}
    assert all(g["weight_decay"] == 1e-4 and g["momentum"] == 0.9
               and not g["nesterov"] for g in groups.values())
    assert sum(len(g["params"]) for g in groups.values()) == len(labels)

    for epochs, spe, warm in ((12, 5, 7), (1, 40, 10), (2, 3, 1)):
        cfg = dict(base_lr=0.02, epochs=epochs, steps_per_epoch=spe,
                   warmup_steps=warm)
        jcfg, tcfg = jrun.DetTrainConfig(**cfg), trun.DetTrainConfig(**cfg)
        lrs = jax.jit(jax.vmap(lambda s: jrun.lr_at(s, jcfg)))(
            jnp.arange(epochs * spe))
        got = [trun.lr_at(s, tcfg) for s in range(epochs * spe)]
        # XLA compiles the warmup's division by a constant into a product
        # with its reciprocal: a last-bit difference at some steps
        np.testing.assert_allclose(np.float32(got), np.asarray(lrs),
                                   rtol=2 ** -23, atol=0)
