"""Checkpoint-parity gate: the port against the PyTorch reference on a
reference LAUD checkpoint (counterpart of `tools/compare_with_torch.py`).

    python -m laudnet_tpu_torch.tools.compare_with_torch \\
        --checkpoint laud_r101_channel.pth.tar --arch uni_resnet101 \\
        --dyn_mode channel-channel-channel-channel \\
        --channel_dyn_granularity 2-2-2-2 [--images img_dir] [--device cuda]

Given a reference LAUD-ResNet checkpoint (``.pth``/``.pth.tar``), builds the
reference's own model from its code under `REF` (the oracle) and loads the
file into it, converts the same file through the port's
`convert/torch_loader.py` into `uni_resnet50`/`uni_resnet101`, runs both on
the same inputs and reports the largest logit difference (< 5e-3), top-1
agreement (100 %) and the largest ``flops_perc`` difference (< 1e-4), then
``PARITY: PASS`` or ``FAIL`` and exits 0 or 1: the acceptance gate
"converted checkpoints reproduce reference top-1 and per-image masks".

The reference runs on the CPU in f32; the port on ``--device`` (the card
unless the caller asks for the CPU) in f32 with TF32 off
(`device.full_f32_convolutions`), at ``--temperature``, in eval. Without
``--images`` the inputs are a seeded normal batch (mask parity does not
depend on the inputs: any disagreement is a conversion or numerics fault);
with it, the first ``--batch`` images of the folder through the port's
`data.eval_transform`. The reference gets the batch NCHW.

Without `REF` there is nothing to compare with: `main` exits non-zero and
names the path; it never compares the port with itself. `port_outputs`
runs the port half alone (the tests and `chip_smoke.py` call it).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import types

import numpy as np
import torch

REF = "/root/reference/imagenet_classification"
SIZE = 224
LOGIT_TOL, FLOPS_TOL = 5e-3, 1e-4
LAYERS = {"uni_resnet50": (3, 4, 6, 3), "uni_resnet101": (3, 4, 23, 3)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--arch", default="uni_resnet101", choices=sorted(LAYERS))
    ap.add_argument("--dyn_mode", default="channel-channel-channel-channel")
    ap.add_argument("--mask_spatial_granularity", default="1-1-1-1")
    ap.add_argument("--channel_dyn_granularity", default="2-2-2-2")
    ap.add_argument("--channel_masker", default="MLP-MLP-MLP-MLP")
    ap.add_argument("--channel_masker_layers", default="2-2-2-2")
    ap.add_argument("--temperature", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--images", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def split(s, c=str):
    return [c(v) for v in s.split("-")]


def model_options(args):
    """The gating options both models are built with."""
    return dict(dyn_mode=split(args.dyn_mode),
                mask_spatial_granularity=split(args.mask_spatial_granularity,
                                               int),
                channel_dyn_granularity=split(args.channel_dyn_granularity,
                                              int),
                channel_masker=split(args.channel_masker),
                channel_masker_layers=split(args.channel_masker_layers, int))


def inputs(args):
    """(batch, SIZE, SIZE, 3) f32 NHWC images."""
    if args.images:
        from laudnet_tpu_torch.data import ImageFolderDataset, eval_transform

        ds = ImageFolderDataset(args.images, eval_transform(SIZE))
        return np.stack([ds.load(i, 0)[0] for i in range(args.batch)])
    return np.random.default_rng(0).standard_normal(
        (args.batch, SIZE, SIZE, 3)).astype(np.float32)


def load_reference_module():
    """The reference's ``models/laud_resnet.py`` (after its
    ``models/utils.py``) from `REF`, as a package of its own."""
    pkg = types.ModuleType("refmodels")
    pkg.__path__ = [os.path.join(REF, "models")]
    sys.modules["refmodels"] = pkg

    def _load(name):
        spec = importlib.util.spec_from_file_location(
            f"refmodels.{name}", os.path.join(REF, "models", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"refmodels.{name}"] = mod
        spec.loader.exec_module(mod)
        return mod

    _load("utils")
    return _load("laud_resnet")


def reference_outputs(args, state, x):
    """The reference model on the CPU in f32: (logits, flops_perc)."""
    ref_laud = load_reference_module()
    ref = ref_laud.ResNet(ref_laud.Bottleneck, list(LAYERS[args.arch]),
                          num_classes=1000, input_size=SIZE, lr_mult=1.0,
                          **model_options(args))
    missing = ref.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()},
        strict=False)
    print(f"torch load: missing={len(missing.missing_keys)} "
          f"unexpected={len(missing.unexpected_keys)}")
    ref.eval()
    with torch.no_grad():
        out = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                  temperature=args.temperature)
    return out[0].numpy(), out[5].numpy()


def port_variables(args, state):
    """The checkpoint's state dict in the port's flax-named tree."""
    from laudnet_tpu_torch.convert import convert_resnet_state_dict

    return convert_resnet_state_dict(
        state, channel_masker_layers=split(args.channel_masker_layers,
                                           int)[0])


def port_outputs(args, state, x, device=None):
    """The port's model on ``device`` (default ``args.device``) in f32 with
    TF32 off, in eval: (logits, flops_perc) as numpy."""
    from laudnet_tpu_torch import models
    from laudnet_tpu_torch.convert import load_flax_variables
    from laudnet_tpu_torch.device import full_f32_convolutions

    dev = torch.device(args.device if device is None else device)
    opts = {k: tuple(v) for k, v in model_options(args).items()}
    model = getattr(models, args.arch)(input_size=SIZE, device=dev, **opts)
    load_flax_variables(model, port_variables(args, state)).eval()
    with torch.no_grad(), full_f32_convolutions():
        out = model(torch.from_numpy(x).to(dev), args.temperature,
                    training=False)
    return out.logits.cpu().numpy(), out.flops_perc.cpu().numpy()


def parity(port, ref):
    """(largest |logit diff|, top-1 agreement, largest |flops_perc diff|,
    pass) of the port's outputs against the reference's."""
    (logits, fp), (ref_logits, ref_fp) = port, ref
    logit_err = float(np.abs(logits - ref_logits).max())
    top1 = float((logits.argmax(-1) == ref_logits.argmax(-1)).mean())
    fp_err = float(np.abs(fp - ref_fp).max())
    ok = logit_err < LOGIT_TOL and top1 == 1.0 and fp_err < FLOPS_TOL
    return logit_err, top1, fp_err, ok


def main(argv=None):
    from laudnet_tpu_torch.convert import load_pth_tar

    args = parse_args(argv)
    if not os.path.isdir(os.path.join(REF, "models")):
        print(f"compare_with_torch: no reference model code at "
              f"{os.path.join(REF, 'models')}; the gate compares the port "
              f"with the reference and runs nothing without it",
              file=sys.stderr)
        return 2
    state = load_pth_tar(args.checkpoint)
    x = inputs(args)
    ref = reference_outputs(args, state, x)
    logit_err, top1, fp_err, ok = parity(port_outputs(args, state, x), ref)
    print(f"max |logit diff|: {logit_err:.2e}")
    print(f"top-1 agreement: {top1 * 100:.1f}%")
    print(f"max |flops_perc diff|: {fp_err:.2e}")
    print("PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
