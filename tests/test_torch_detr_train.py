"""DETR training and evaluation through the port's runner and CLI against
the JAX package's: one train step per form, DDQ (denoising groups,
per-layer distinct queries, the full encoder) and the learned queries of
Mask2Former (the deformable encoder, the point-sampled mask loss and its
per-layer auxiliaries), from the same
variables, batch and draws (JAX's Gumbel, uniform and integer draws
recorded through ordered ``jax.debug.callback``s, replayed by the port);
the ImageNet ``init_from``; and the CLI's ``train`` then ``eval_info`` on
every DETR config of ``configs/detection/`` at a cut depth on ``--device
cpu``.

Tolerances (f32 throughout, as DETR runs): the loss and every metric
within 2e-5 relative (2e-6 measured); every parameter after the update
within 1e-5 relative plus 1e-6 (an update of 1e-4 moved 1.5e-7 by the
summation order measured); each leaf's update (after - before) within
UPDATE_REL of JAX's by norm plus UPDATE_ATOL (the key projections' biases
get no gradient, a softmax over keys being blind to a shift, so their
updates are weight decay alone, ~1e-9, and rounding decides their last
digits).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_detection_common import (LAYERS, gt_batch, images, jitter,
                                     recorded_draws, recorded_gumbel, shake)
from laudnet_tpu.detection import detr as jd
from laudnet_tpu.detection import runner as jrun
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_tree,
                                                to_flax_variables)
from laudnet_tpu_torch.detection import cli
from laudnet_tpu_torch.detection import detr as td
from laudnet_tpu_torch.detection import runner as trun
from laudnet_tpu_torch.ops.gating import ReplayNoise
from laudnet_tpu_torch.train.trainer import TrainState
from laudnet_tpu_torch.utils.config import Config

torch.set_num_threads(1)
# the backbones gate in their last stage only (the CNN detectors' train
# tests hold the gates' training to JAX), and the deformable encoder trains
# in the Mask2Former step only (`test_torch_detr.py` holds its gradient to
# JAX alone), which keeps XLA's compilation of each JAX step short; XLA's
# backend compiles the JAX steps at optimisation level 0 (the same HLO
# through fewer LLVM passes: a last-bit difference in the loss, ~1e-7)
TINY = dict(num_classes=3, num_queries=8, dim=32, enc_layers=1,
            dec_layers=1, backbone_layers=LAYERS,
            dyn_mode=("static",) * 3 + ("channel",), sparsity_target=0.5)
FORMS = {
    "ddq": (dict(query_init="ddq", dec_layers=2, dn_groups=2,
                 encoder="full"), (64, 64), {}),
    "mask2former": (dict(with_masks=True, out_indices=(0, 1, 2, 3),
                         dyn_mode=("static",) * 3 + ("layer",)), (48, 80),
                    dict(mask_points=64)),
}
CFG = dict(num_classes=3, base_lr=0.02, lr_mult=0.3, epochs=1,
           steps_per_epoch=4, warmup_steps=2, sparsity_target=0.6)
# a BatchNorm scale's gradient sums dy * x_hat over a feature map with
# cancellation, in another order than XLA's: 1.4e-4 of its update measured
UPDATE_REL, UPDATE_ATOL = 1e-3, 1e-8
CONFIGS = sorted(p for p in glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "configs", "detection", "*.py"))
    if Config.fromfile(p)["model"]["type"] in trun.DETR_TYPES)


def detr_variables(model, seed):
    model.init_weights(torch.Generator().manual_seed(seed))
    v = shake(to_flax_variables(model), seed)
    jitter(v["params"], seed)
    load_flax_variables(model, v)
    return v


@pytest.mark.parametrize("form", sorted(FORMS))
def test_train_step_matches_jax(monkeypatch, form):
    kw, shape, point_kw = FORMS[form]
    kw = dict(TINY, **kw)
    model = td.DETRDetector(**kw, image_size=shape, device="cpu")
    v = detr_variables(model, 3)
    masks = "with_masks" in kw
    x = images(shape, 4)
    batch = gt_batch(shape, 5, masks=masks)

    jcfg = jrun.DetTrainConfig(**CFG, with_masks=masks, **point_kw)
    jopt = jrun.make_detection_sgd(v["params"], lr_mult=CFG["lr_mult"])
    state = (jnp.zeros((), jnp.int32), v["params"], v["batch_stats"],
             jax.jit(jopt.init)(v["params"]))
    with recorded_gumbel(monkeypatch) as gumbel, \
            recorded_draws(monkeypatch) as draws:
        jstep = jax.jit(jrun.make_detector_train_step(
            jd.DETRDetector(**kw), jopt, jcfg, "detr", seed=1),
            compiler_options={"xla_backend_optimization_level": 0})
        state, jm = jstep(state, x, *batch)
        jm = {k: float(val) for k, val in jm.items()}

    opt = trun.make_detection_sgd(model, lr_mult=CFG["lr_mult"])
    noise, replay = ReplayNoise(gumbel), td.ReplayDraws(draws)
    step = trun.make_detector_train_step(
        model, opt, trun.DetTrainConfig(**CFG, with_masks=masks, **point_kw),
        "detr", noise=noise, dn_draws=replay, mask_draws=replay)
    tstate = TrainState(step=0, model=model, optimizer=opt)
    m = step(tstate, *trun.batch_to_device((x,) + batch, "cpu"))
    assert noise.used == len(gumbel) > 0
    assert replay.used == len(draws)
    assert len(draws) == {"ddq": 4, "mask2former": 5}[form]
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=2e-5,
                                   atol=1e-9, err_msg=k)
    if form == "ddq":
        assert "loss_dn" in jm and "loss_dec_aux" in jm
    if form == "mask2former":
        assert jm["loss_mask"] > 0 and jm["loss_mask_aux"] > 0

    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_tree(model)))
    before = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    ref = jax.tree_util.tree_leaves_with_path(state[1])
    assert len(got) == len(ref)
    for path, leaf in ref:
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(got[path], leaf, rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))
        du, ju = got[path] - before[path], leaf - before[path]
        diff, size = np.linalg.norm(du - ju), np.linalg.norm(ju)
        assert diff <= UPDATE_REL * size + UPDATE_ATOL, (path, diff, size)


def test_ddq_trains_end_to_end_and_loads_an_imagenet_backbone(tmp_path):
    """`train_detector` drives the DDQ decoder (distinct queries and
    denoising groups) for two steps with finite losses, ``loss_dn`` and
    ``loss_dec_aux`` among them, after loading an ImageNet LAUD-ResNet
    file into the backbone through the CNN detectors' converter."""
    from laudnet_tpu_torch.convert import (
        convert_detection_backbone_state_dict, load_pth_tar, save_pth_tar)
    from laudnet_tpu_torch.models.laud_resnet import LAUDResNet

    donor = LAUDResNet(layers=LAYERS, num_classes=10, input_size=64,
                       dyn_mode=("channel",) * 4,
                       channel_dyn_granularity=(2,) * 4,
                       channel_masker_layers=(2,) * 4, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "laud_r.pth.tar")
    save_pth_tar(to_flax_variables(donor), path)
    model = td.DETRDetector(**dict(TINY, query_init="ddq", dec_layers=2,
                                   dn_groups=2, dyn_mode=("channel",) * 4),
                            image_size=64,
                            device="cpu",
                            generator=torch.Generator().manual_seed(1))
    cfg = trun.DetTrainConfig(num_classes=3, epochs=0)
    logs = []
    trun.train_detector(model, cfg, kind="detr", image_size=64,
                        init_from=path, log=logs.append)
    assert logs == [f"initialized backbone from {path}"]
    want = convert_detection_backbone_state_dict(load_pth_tar(path))
    got = to_flax_variables(model.backbone)
    for tree, ref in ((got["params"], want["params"]["backbone"]),
                      (got["batch_stats"], want["batch_stats"]["backbone"])):
        for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
            node = ref
            for key in p:
                node = node[key.key]
            np.testing.assert_array_equal(leaf, node, str(p))

    cfg = trun.DetTrainConfig(num_classes=3, epochs=1, steps_per_epoch=2,
                              warmup_steps=1, lambda_sparse=0.1)
    _, hist = trun.train_detector(model, cfg, kind="detr", image_size=64,
                                  batch_size=2, log=lambda *a: None)
    assert np.isfinite(hist[-1]["loss"])
    assert "loss_dn" in hist[-1] and "loss_dec_aux" in hist[-1]


def cut_config(src, dst):
    """``src``'s config at backbone depth (1, 1, 1, 1), written to
    ``dst``; every other value as the config has it."""
    cfg = Config.fromfile(src)
    model = dict(cfg["model"], backbone_layers=LAYERS)
    dst.write_text(f"model = {model!r}\ntrain_cfg = "
                   f"{dict(cfg.get('train_cfg', {}))!r}\n")
    return str(dst)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_cli_train_then_eval_info_every_detr_config(tmp_path, capsys, path):
    """Each DETR config (its queries, dimension, layers, levels, denoising
    groups and mask points as they are; the backbone cut to 1-1-1-1) trains
    a step and evaluates from the checkpoint. DDQ's 300 queries need 300
    encoder tokens: 128 x 128 gives 336."""
    assert len(CONFIGS) == 4
    size = "128" if "ddq" in os.path.basename(path) else "64"
    work = str(tmp_path / "work")
    cfg = cut_config(path, tmp_path / "cfg.py")
    common = ["--device", "cpu", "--image_size", size, "--num_classes", "3",
              "--batch_size", "1"]
    hist = cli.main(["train", cfg, "--work_dir", work, "--epochs", "1",
                     "--steps_per_epoch", "1", "--no_init"] + common)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    masks = "mask2former" in os.path.basename(path)
    if masks:
        assert hist[0]["loss_mask"] > 0 and hist[0]["loss_mask_aux"] > 0
    else:
        assert hist[0]["loss_dn"] > 0 and hist[0]["loss_dec_aux"] > 0
    res = cli.main(["eval_info", cfg, "--work_dir", work, "--eval_steps",
                    "1"] + common)
    assert "restored checkpoint step 1" in capsys.readouterr().out
    assert 0 <= res["mAP"] <= 1 and 0 < res["mean_flops_rate"] <= 1
    assert ("segm_mAP" in res) == masks
    assert json.load(open(os.path.join(work, "eval_info.json")))[
        "n_images"] == 1


def test_cli_has_no_cpu_fallback(tmp_path):
    """Without ``--device`` a DETR config builds on the card; with none
    PyTorch refuses, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((AssertionError, RuntimeError),
                       match="(?i)cuda|nvidia"):
        cli.main(["train", cut_config(CONFIGS[0], tmp_path / "c.py"),
                  "--work_dir", str(tmp_path / "w"), "--image_size", "128"])
