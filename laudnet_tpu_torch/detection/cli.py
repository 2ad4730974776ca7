"""Detection train and eval CLI over the ``configs/detection/`` files
(counterpart of `laudnet_tpu/detection/cli.py`): the JAX CLI's flags plus
``--device`` (the card unless ``cpu`` is asked for; there is no fallback).

``--data_dir`` points at a COCO-format dataset (``annotations/
instances_*.json`` or a flat ``{split}.json`` + ``images/``,
`laudnet_tpu_torch/data/coco.py`); without it the synthetic-COCO smoke
generator feeds the run. A DETR-family model is built for ``--image_size``
(its position embeddings are sized from the input) and stays f32.

Usage::

    python -m laudnet_tpu_torch.detection.cli train \\
        configs/detection/retinanet_laud_r101_channel_2222_0x6.py \\
        --work_dir out/ --image_size 800,1344 --batch_size 2 --amp \\
        --init_from laud_r101_channel.pth.tar
    python -m laudnet_tpu_torch.detection.cli eval_info \\
        configs/detection/... --work_dir out/ --image_size 800,1344
    python -m laudnet_tpu_torch.detection.cli train \\
        configs/detection/mask2former_laud_r101_layer_0x5.py \\
        --work_dir m2f/ --image_size 1024 --batch_size 2
    # on the CPU at a cut depth:
    python -m laudnet_tpu_torch.detection.cli train CONFIG --device cpu \\
        --image_size 64 --num_classes 3 --epochs 1 --steps_per_epoch 2
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from laudnet_tpu_torch.detection.runner import (DetTrainConfig,
                                                build_detector,
                                                evaluate_detector,
                                                make_detection_sgd,
                                                synthetic_coco_batches,
                                                train_detector)
from laudnet_tpu_torch.device import resolve_device
from laudnet_tpu_torch.train.trainer import TrainState
from laudnet_tpu_torch.utils.config import Config


def _parser():
    p = argparse.ArgumentParser("laudnet_tpu_torch.detection.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("train", "eval_info"):
        q = sub.add_parser(name)
        q.add_argument("config", help="configs/detection/*.py")
        q.add_argument("--work_dir", default="./det_output")
        q.add_argument("--image_size", default="128",
                       help="square int or 'H,W' (rectangular COCO sizes)")
        q.add_argument("--batch_size", type=int, default=2)
        q.add_argument("--num_classes", type=int, default=None,
                       help="override the config (synthetic data uses <=3)")
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--data_dir", default=None,
                       help="COCO-format dataset root (annotations/*.json "
                            "or flat {split}.json + images/); default: "
                            "synthetic smoke data")
        q.add_argument("--split", default=None,
                       help="COCO split (default: train / val per command)")
        q.add_argument("--max_gt", type=int, default=32,
                       help="GT box slots per image (static shapes)")
        q.add_argument("--device", default=None,
                       help="'cpu' to run on the CPU; the card otherwise")
        if name == "train":
            q.add_argument("--epochs", type=int, default=None)
            q.add_argument("--steps_per_epoch", type=int, default=20)
            q.add_argument("--base_lr", type=float, default=0.01)
            q.add_argument("--init_from", default=None,
                           help="ImageNet LAUD .pth[.tar] for the backbone "
                                "(overrides the config's init_from)")
            q.add_argument("--no_init", action="store_true",
                           help="skip the config's init_from checkpoint")
            q.add_argument("--amp", action="store_true",
                           help="bf16 mixed-precision training (bf16 "
                                "towers, f32 masters, f32 gating heads "
                                "and predictors)")
        else:
            q.add_argument("--eval_steps", type=int, default=5)
            q.add_argument("--score_threshold", type=float, default=0.05)
    return p


def _build(args):
    """The config's detector for ``args`` (a DETR-family one at
    ``args.image_size``), its kind, model dict and train_cfg."""
    cfg = Config.fromfile(args.config)
    model_cfg = dict(cfg["model"])
    if args.num_classes is not None:
        model_cfg["num_classes"] = args.num_classes
    if getattr(args, "amp", False):
        model_cfg["amp"] = True
    device = resolve_device(args.device)
    model, kind = build_detector(
        model_cfg, device=device,
        generator=torch.Generator(device).manual_seed(args.seed),
        image_size=args.image_size)
    return model, kind, model_cfg, dict(cfg.get("train_cfg", {}))


def _parse_image_size(s):
    if "," in str(s):
        h, w = str(s).split(",")
        return (int(h), int(w))
    return int(s)


def main(argv=None):
    args = _parser().parse_args(argv)
    args.image_size = _parse_image_size(args.image_size)
    dataset = None
    if args.data_dir:
        from laudnet_tpu_torch.data.coco import open_coco

        split = args.split or ("train" if args.cmd == "train" else "val")
        dataset = open_coco(args.data_dir, split)
        if args.num_classes is None:
            args.num_classes = dataset.num_classes
        print(f"COCO {split}: {len(dataset)} images, "
              f"{dataset.num_classes} classes from {args.data_dir}")
    model, kind, model_cfg, train_cfg = _build(args)
    os.makedirs(args.work_dir, exist_ok=True)
    num_classes = model_cfg["num_classes"]
    # from the built model: the MaskRCNN and Mask2Former types imply
    # with_masks
    with_masks = bool(getattr(model, "with_masks", False))

    def coco_data_fn(steps, *, shuffle, seed):
        """Exactly ``steps`` batches, cycling epochs as needed."""
        from laudnet_tpu_torch.data.coco import coco_detection_batches

        per_epoch = max(1, -(-len(dataset) // args.batch_size))
        epochs = -(-steps // per_epoch)
        return itertools.islice(
            coco_detection_batches(
                dataset, batch_size=args.batch_size,
                image_size=args.image_size, max_gt=args.max_gt,
                with_masks=with_masks, shuffle=shuffle, seed=seed,
                epochs=epochs),
            steps)

    if args.cmd == "train":
        init_from = args.init_from
        if init_from is None and not args.no_init:
            init_from = train_cfg.get("init_from")
            if init_from and not os.path.exists(init_from):
                print(f"init_from {init_from!r} not found: training from "
                      "scratch (pass --init_from or --no_init to silence)")
                init_from = None
        if init_from is None:
            # norm_eval freezes BatchNorm on the checkpoint's running
            # statistics; random ones do not match the activations, and a
            # deep backbone diverges within a step or two
            print("warning: training a norm_eval backbone from random "
                  "init: expect divergence at full depth; pass "
                  "--init_from with an ImageNet LAUD checkpoint for a "
                  "real run")
        dcfg = DetTrainConfig(
            num_classes=num_classes, base_lr=args.base_lr,
            lr_mult=float(train_cfg.get("backbone_lr_mult", 0.2)),
            epochs=args.epochs or int(train_cfg.get("epochs", 12)),
            steps_per_epoch=args.steps_per_epoch,
            sparsity_target=float(model_cfg.get("sparsity_target", 0.5)),
            with_masks=with_masks,
            mask_points=(int(train_cfg["mask_points"])
                         if train_cfg.get("mask_points") else None),
            oversample_ratio=float(train_cfg.get("oversample_ratio", 3.0)),
            importance_ratio=float(train_cfg.get("importance_ratio", 0.75)))
        data_fn = None
        if dataset is not None:
            def data_fn(steps):
                return coco_data_fn(steps, shuffle=True, seed=args.seed)
        _, history = train_detector(
            model, dcfg, kind=kind, image_size=args.image_size,
            batch_size=args.batch_size, seed=args.seed, data_fn=data_fn,
            init_from=init_from,
            checkpoint_dir=os.path.join(args.work_dir, "checkpoint"))
        with open(os.path.join(args.work_dir, "log.json"), "w") as f:
            json.dump(history, f, indent=1)
        if history:
            print(f"done: final loss {history[-1]['loss']:.4f} "
                  f"flops_rate {history[-1].get('flops_rate', 1.0):.3f}")
        else:  # auto-resume found the run already complete
            print("done: checkpoint already at the final step; nothing to do")
        return history

    # eval_info: the latest checkpoint, mAP and the FLOPs accounting
    from laudnet_tpu_torch.train.checkpoint import CheckpointManager

    ih, iw = ((args.image_size, args.image_size)
              if isinstance(args.image_size, int) else args.image_size)
    ckpt_dir = os.path.join(args.work_dir, "checkpoint")
    if os.path.isdir(ckpt_dir):
        mgr = CheckpointManager(ckpt_dir)
        if mgr.latest_step() is not None:
            state = TrainState(step=0, model=model,
                               optimizer=make_detection_sgd(model))
            mgr.restore(state)
            print(f"restored checkpoint step {state.step}")
        mgr.close()

    def batches():
        if dataset is not None:
            yield from coco_data_fn(args.eval_steps, shuffle=False,
                                    seed=args.seed + 1)
            return
        yield from synthetic_coco_batches(
            args.batch_size, (ih, iw), num_classes, steps=args.eval_steps,
            seed=args.seed + 1, with_masks=with_masks)

    res = evaluate_detector(model, batches(), num_classes=num_classes,
                            kind=kind, score_threshold=args.score_threshold)
    printable = {k: (float(v) if np.isscalar(v) or getattr(v, "ndim", 1) == 0
                     else [float(x) for x in v])
                 for k, v in res.items()}
    print(json.dumps(printable, indent=1))
    with open(os.path.join(args.work_dir, "eval_info.json"), "w") as f:
        json.dump(printable, f, indent=1)
    return res


if __name__ == "__main__":
    main()
