"""The detection runner and CLI of the port (`detection/runner.py`,
`detection/eval_info.py`, `detection/cli.py`) against the JAX package's:
mAP and the mask paste on JAX's hand cases and bit for bit on random
detections, `evaluate_detector` on the same model and batches,
auto-resume, ``init_from`` from a ``.pth.tar`` written by JAX's
`save_pth_tar`, the CLI's ``train`` then ``eval_info`` on ``--device cpu``
(synthetic data and a COCO-format ``--data_dir``) at a cut depth, every
config of ``configs/detection/`` built, and the refusals (``amp`` for the
DETR types, unknown types, no silent CPU fallback)."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_detection_common import (LAYERS, NUM_CLASSES, SQUARE,
                                     port_variables, write_mini_coco)
from laudnet_tpu.convert.torch_export import save_pth_tar
from laudnet_tpu.detection import runner as jrun
from laudnet_tpu.detection import two_stage as jts
from laudnet_tpu.detection import retinanet as jr
from laudnet_tpu_torch.convert.from_jax import to_flax_variables
from laudnet_tpu_torch.detection import cli
from laudnet_tpu_torch.detection import eval_info as tei
from laudnet_tpu_torch.detection import retinanet as tr
from laudnet_tpu_torch.detection import runner as trun
from laudnet_tpu_torch.detection import two_stage as tts
from laudnet_tpu_torch.models.laud_resnet import LAUDResNet
from laudnet_tpu_torch.utils.config import Config

torch.set_num_threads(1)
CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "detection", "*.py")))


def test_map_and_paste_mask_match_jax():
    """JAX's hand cases (one hit and one miss at IoU 0.5; COCO's
    thresholds on a 2/3-IoU box), then random detections with masks: the
    port's numbers equal JAX's to the bit."""
    gts = [dict(boxes=np.array([[0, 0, 10, 10], [20, 20, 30, 30]]),
                labels=np.array([0, 1]))]
    dets = [dict(boxes=np.array([[0, 0, 10, 10], [40, 40, 50, 50]]),
                 scores=np.array([0.9, 0.8]), classes=np.array([0, 1]))]
    r = trun.mean_average_precision(dets, gts, num_classes=2)
    assert list(r["ap_per_class"]) == [1.0, 0.0] and r["mAP"] == 0.5
    pad = [dict(boxes=np.zeros((5, 4)), scores=np.zeros(5),
                classes=np.zeros(5, int))]
    assert trun.mean_average_precision(pad, gts, num_classes=2)["mAP"] == 0
    g1 = [dict(boxes=np.array([[0.0, 0, 10, 10]]), labels=np.array([0]))]
    d1 = [dict(boxes=np.array([[2.0, 0, 12, 10]]), scores=np.array([0.9]),
               classes=np.array([0]))]
    r = trun.mean_average_precision(d1, g1, 1, iou_thresholds="coco")
    assert r["mAP50"] == 1.0 and r["mAP"] == pytest.approx(0.4)
    assert trun.mean_average_precision(d1, g1, 1, iou_thresholds=[0.5, 0.7]
                                       )["mAP"] == 0.5

    rng = np.random.default_rng(0)
    dets, gts = [], []
    for _ in range(4):
        xy = rng.random((12, 2)) * 40
        boxes = np.concatenate([xy, xy + rng.random((12, 2)) * 20 + 4], 1)
        probs = rng.random((12, 14, 14))
        masks = [trun.paste_mask(p, b, 64, 64) for p, b in zip(probs, boxes)]
        for p, b, m in zip(probs, boxes, masks):
            np.testing.assert_array_equal(m, jrun.paste_mask(p, b, 64, 64))
        dets.append(dict(boxes=boxes, scores=rng.random(12) * (
            rng.random(12) > 0.2), classes=rng.integers(0, 3, 12),
            masks=masks))
        keep = rng.random(12) > 0.5
        gts.append(dict(boxes=boxes[keep] + rng.normal(0, 2, (keep.sum(), 4)),
                        labels=rng.integers(0, 3, keep.sum()),
                        masks=np.asarray(masks)[keep]))
    for kw in (dict(), dict(iou_thresholds="coco"),
               dict(use_masks=True, iou_thresholds="coco")):
        a = trun.mean_average_precision(dets, gts, 3, **kw)
        b = jrun.mean_average_precision(dets, gts, 3, **kw)
        assert a["mAP"] == b["mAP"] and a.get("mAP50") == b.get("mAP50")
        np.testing.assert_array_equal(a["ap_per_class"], b["ap_per_class"])
    assert 0 < a["mAP"] < 1


def test_evaluate_detector_and_eval_info_match_jax():
    """Mask R-CNN (box and segm mAP, the FLOPs spread) over the same
    synthetic batches; `evaluate_get_info` alike."""
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS,
              dyn_mode=("channel",) * 4, with_masks=True, num_proposals=16)
    model = tts.FasterRCNN(**kw, device="cpu")
    v = port_variables(model, 4)
    batches = list(trun.synthetic_coco_batches(2, 64, NUM_CLASSES, 3, seed=6,
                                               with_masks=True))
    jbatches = list(jrun.synthetic_coco_batches(2, 64, NUM_CLASSES, 3,
                                                seed=6, with_masks=True))
    for a, b in zip(batches, jbatches):  # the same draws
        assert len(a) == len(b) == 5
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    batches, jbatches = batches[-1:], jbatches[-1:]
    ref = jrun.evaluate_detector(jts.FasterRCNN(**kw), v["params"],
                                 v["batch_stats"], jbatches,
                                 num_classes=NUM_CLASSES)
    got = trun.evaluate_detector(model, batches, num_classes=NUM_CLASSES)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(ref[k], np.float64),
                                   rtol=1e-6, err_msg=k)
    assert "segm_mAP" in got and got["n_images"] == 2
    assert 0 < got["mean_flops_rate"] <= 1.0

    x = torch.from_numpy(batches[0][0])
    with torch.no_grad():
        info = tei.evaluate_get_info(lambda im: model(im), [x, x])
    assert info["n_images"] == 4
    for k in ("mean_flops", "mean_flops_rate"):
        np.testing.assert_allclose(info[k], got[k], rtol=1e-6)
    assert info["mean_channel_sparsity"].shape == (4,)


def test_train_detector_auto_resumes(tmp_path):
    """A second run over the same checkpoint directory restores the final
    step and takes none; an interrupted run resumes where it stopped and
    ends where the whole run ends."""
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS)
    cfg = trun.DetTrainConfig(num_classes=NUM_CLASSES, epochs=2,
                              steps_per_epoch=1, warmup_steps=1)
    gen = lambda: torch.Generator().manual_seed(0)
    whole = tr.RetinaNet(**kw, device="cpu", generator=gen())
    _, hist = trun.train_detector(whole, cfg, kind="retinanet",
                                  image_size=SQUARE, log=lambda *a: None)
    part = tr.RetinaNet(**kw, device="cpu", generator=gen())
    half = trun.DetTrainConfig(**dict(cfg.__dict__, epochs=1))
    trun.train_detector(part, half, kind="retinanet", image_size=SQUARE,
                        checkpoint_dir=str(tmp_path), log=lambda *a: None)
    logs = []
    again = tr.RetinaNet(**kw, device="cpu", generator=gen())
    _, h2 = trun.train_detector(again, cfg, kind="retinanet",
                                image_size=SQUARE,
                                checkpoint_dir=str(tmp_path),
                                log=logs.append)
    assert "auto-resumed detector from step 1" in logs
    assert h2[-1]["loss"] == hist[-1]["loss"]
    for a, b in zip(whole.parameters(), again.parameters()):
        assert torch.equal(a, b)
    logs = []
    _, h3 = trun.train_detector(again, cfg, kind="retinanet",
                                image_size=SQUARE,
                                checkpoint_dir=str(tmp_path),
                                log=logs.append)
    assert h3 == [] and "auto-resumed detector from step 2" in logs


def test_init_from_matches_jax_train_detector(tmp_path):
    """An ImageNet LAUD-ResNet file written by JAX's `save_pth_tar` loads
    into the port's backbone as JAX's ``train_detector(init_from=)`` loads
    it: every backbone leaf bit for bit."""
    donor = LAUDResNet(layers=LAYERS, num_classes=10, input_size=64,
                       dyn_mode=("channel",) * 4,
                       channel_dyn_granularity=(2,) * 4,
                       channel_masker_layers=(2,) * 4, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "laud_r.pth.tar")
    save_pth_tar(to_flax_variables(donor), path)
    kw = dict(num_classes=NUM_CLASSES, backbone_layers=LAYERS)
    jparams, jstats, _ = jrun.train_detector(
        jr.RetinaNet(**kw), jrun.DetTrainConfig(num_classes=3, epochs=0),
        kind="retinanet", image_size=64, init_from=path,
        log=lambda *a: None)
    model = tr.RetinaNet(**kw, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    logs = []
    trun.train_detector(model, trun.DetTrainConfig(num_classes=3, epochs=0),
                        kind="retinanet", init_from=path, log=logs.append)
    assert logs == [f"initialized backbone from {path}"]
    got = to_flax_variables(model.backbone)
    for tree, ref in ((got["params"], jparams["backbone"]),
                      (got["batch_stats"], jstats["backbone"])):
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        mine = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(mine) == len(ref_leaves)
        for p, leaf in ref_leaves:
            np.testing.assert_array_equal(mine[p], np.asarray(leaf), str(p))


def cut_config(src, dst):
    """``src``'s config at backbone depth (1, 1, 1, 1) and, for a
    two-stage type, 16 proposals, written to ``dst``."""
    cfg = Config.fromfile(src)
    model = dict(cfg["model"], backbone_layers=LAYERS)
    if model["type"] != "RetinaNet":
        model["num_proposals"] = 16
    dst.write_text(f"model = {model!r}\ntrain_cfg = "
                   f"{dict(cfg.get('train_cfg', {}))!r}\n")
    return str(dst)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_build_detector_every_config(path):
    """Every config builds (full depth, no memory on the meta device) as
    its type says; a DETR-family one for an image size, and it refuses
    ``amp`` as JAX's does."""
    model_cfg = dict(Config.fromfile(path)["model"])
    if model_cfg["type"] in trun.DETR_TYPES:
        with pytest.raises(ValueError, match="not supported for the DETR"):
            trun.build_detector(dict(model_cfg, amp=True), device="meta",
                                image_size=(800, 1344))
        model, kind = trun.build_detector(model_cfg, device="meta",
                                          image_size=(800, 1344))
        assert kind == "detr" and model.image_hw == (800, 1344)
        assert model.num_queries == model_cfg["num_queries"]
        assert model.out_indices == tuple(model_cfg["out_indices"])
        assert model.dn_groups == model_cfg.get("dn_groups", 0)
        assert model.with_masks == model_cfg.get("with_masks", False)
    else:
        model, kind = trun.build_detector(dict(model_cfg, amp=True),
                                          device="meta")
        assert kind == {"RetinaNet": "retinanet"}.get(model_cfg["type"],
                                                       "faster_rcnn")
        assert model.compute_dtype == torch.bfloat16
        if kind == "faster_rcnn":
            assert model.with_masks == model_cfg.get("with_masks", False)
    assert model.backbone.layers == (3, 4, 23, 3)
    assert model.backbone.dyn_mode == tuple(model_cfg["dyn_mode"])
    assert model.backbone.sparsity_target == model_cfg["sparsity_target"]


def test_build_detector_refusals_and_no_cpu_fallback(tmp_path):
    """An unknown type and a DETR type under ``amp`` raise; the DETR
    types build (``Mask2Former`` with masks); without ``--device`` the CLI
    builds on the card, and with none PyTorch refuses."""
    with pytest.raises(ValueError, match="unknown detector type"):
        trun.build_detector(dict(type="YOLO"), device="meta")
    with pytest.raises(ValueError, match="DETR"):
        trun.build_detector(dict(type="Mask2Former", amp=True),
                            device="meta", image_size=64)
    for name in trun.DETR_TYPES:
        model, kind = trun.build_detector(dict(type=name), device="meta",
                                          image_size=64)
        assert kind == "detr"
        assert model.with_masks == (name == "Mask2Former")
    retina = [p for p in CONFIGS if "retinanet_laud" in p][0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    # without --device the CLI builds on the card, and PyTorch refuses
    with pytest.raises((AssertionError, RuntimeError),
                       match="(?i)cuda|nvidia"):
        cli.main(["train", cut_config(retina, tmp_path / "c.py"),
                  "--work_dir", str(tmp_path / "w"), "--image_size", "64"])


def test_cli_train_then_eval_info_on_cpu(tmp_path, capsys):
    """RetinaNet (layer config) on synthetic data, then Mask R-CNN (channel
    config) on a COCO-format directory: train, auto-resume to nothing,
    eval_info from the checkpoint."""
    retina = [p for p in CONFIGS if "retinanet_laud_r101_layer" in p][0]
    work = str(tmp_path / "retina")
    common = ["--device", "cpu", "--image_size", "64,96", "--num_classes",
              "3", "--batch_size", "2"]
    cfg = cut_config(retina, tmp_path / "retina.py")
    hist = cli.main(["train", cfg, "--work_dir", work, "--epochs", "1",
                     "--steps_per_epoch", "2", "--no_init"] + common)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert json.load(open(os.path.join(work, "log.json"))) == hist
    assert cli.main(["train", cfg, "--work_dir", work, "--epochs", "1",
                     "--steps_per_epoch", "2", "--no_init"] + common) == []
    res = cli.main(["eval_info", cfg, "--work_dir", work, "--eval_steps",
                    "2"] + common)
    out = capsys.readouterr().out
    assert "restored checkpoint step 2" in out
    assert 0 <= res["mAP"] <= 1 and 0 < res["mean_flops_rate"] <= 1
    assert json.load(open(os.path.join(work, "eval_info.json")))[
        "n_images"] == 4

    mask = [p for p in CONFIGS if "mask_rcnn_laud_r101_channel" in p][0]
    data = write_mini_coco(tmp_path / "coco")
    work = str(tmp_path / "mask")
    cfg = cut_config(mask, tmp_path / "mask.py")
    common = ["--device", "cpu", "--image_size", "64", "--data_dir",
              str(data), "--max_gt", "4", "--batch_size", "2"]
    hist = cli.main(["train", cfg, "--work_dir", work, "--epochs", "1",
                     "--steps_per_epoch", "2", "--no_init"] + common)
    assert all(np.isfinite(h["loss"]) and h["loss_mask"] > 0 for h in hist)
    res = cli.main(["eval_info", cfg, "--work_dir", work, "--eval_steps",
                    "2"] + common)
    assert "COCO val: 6 images, 3 classes" in capsys.readouterr().out
    assert 0 <= res["segm_mAP"] <= 1 and 0 <= res["mAP"] <= 1
    assert 0 < res["mean_flops_rate"] <= 1
