"""Latency-prediction CLI (counterpart of `laudnet_tpu/sim/cli.py`; the
reference simulator's `DyNetSimulator/eval_example.py`).

Usage::

    python -m laudnet_tpu_torch.sim.cli resnet101 --hardware v100 \\
        --mode spatial --act-rate 0.5 --granularity 4-4-2-1

Prints per-mode predicted latency (seconds per batch and ms per image) on
the GPU roofline simulator. ``--hardware`` takes the five GPU presets of
`sim/hardware.py`. The TPU presets and the ``pallas`` and
``channel_gather`` modes model TPU engines, which the port does not have:
they are refused with the JAX CLI's own messages for GPU hardware.
``--plan`` ranks a ViT's serving paradigms on the port's planner
(`sim/plan.py`, priced by the H100 model of `sim/h100.py`), where the JAX
CLI prices the v5e.
"""

from __future__ import annotations

import argparse

from laudnet_tpu_torch.sim.dynamic import DynamicPredictor
from laudnet_tpu_torch.sim.hardware import GPU_PRESETS
from laudnet_tpu_torch.sim.models import MODEL_GEOMETRY, predict_network

# the JAX CLI's TPU presets: named so that a request for one is refused
# with a reason, not with argparse's list of choices
TPU_NAMES = ("v5e", "v5p")


def stage_list_to_blocks(model: str, per_stage):
    """Expand a per-stage list (e.g. granularity 4-4-2-1) to per-block."""
    blocks = MODEL_GEOMETRY[model]
    # stage boundaries via resolution drops
    out = []
    stage = -1
    last_h = None
    for g in blocks:
        if g.h != last_h:
            stage += 1
            last_h = g.h
        out.append(per_stage[min(stage, len(per_stage) - 1)])
    return out


VIT_GEOMETRY = {
    # depth, dim, heads, mlp_ratio
    "deit_small": dict(depth=12, dim=384, num_heads=6, mlp_ratio=4.0),
    "deit_tiny": dict(depth=12, dim=192, num_heads=3, mlp_ratio=4.0),
    "t2t_vit": dict(depth=14, dim=448, num_heads=7, mlp_ratio=3.0),
}


def _run_vit_gpu(args):
    """T2T-ViT three-paradigm sweep (reference `adavit/simulate_adavit.py`)."""
    from laudnet_tpu_torch.sim.adavit import simulate_laud_t2t_vit
    from laudnet_tpu_torch.sim.transformer import TransformerPredictor

    spec = GPU_PRESETS[args.hardware].with_batch(1)
    p = TransformerPredictor(spec)
    bs = args.batch_size or 128
    d = args.act_rate
    rows = [
        ("dense", dict(token_skip=False, head_skip=False, layer_skip=False)),
        ("layer", dict(token_skip=False, head_skip=False, layer_density=d)),
        ("token", dict(head_skip=False, layer_skip=False, token_density=d)),
        ("head", dict(token_skip=False, layer_skip=False, head_density=d)),
        ("s+c+l", dict(token_density=d, head_density=d, layer_density=d)),
    ]
    print(f"# {args.model} on {spec.name} (batch {bs}, density {d})")
    geo = VIT_GEOMETRY[args.model]
    for name, kw in rows:
        rep = simulate_laud_t2t_vit(
            p, B=bs, depth=geo["depth"], dim=geo["dim"],
            head_num=geo["num_heads"], mlp_ratio=geo["mlp_ratio"], **kw
        )
        print(f"{name:8s}: {rep.latency * 1e3:8.3f} ms/batch "
              f"({rep.latency / bs * 1e3:7.4f} ms/img)")


def _plan(args):
    """The serving plan of a ViT on the H100 model (the counterpart of the
    JAX CLI's v5e plan): the block engine where its geometry gate passes
    (heads of 64, as `infer/engine.py::ServingEngine._block_engine_ok`),
    the model's graph with the fused attention otherwise."""
    from laudnet_tpu_torch.sim.plan import plan_vit_serving

    if args.model not in VIT_GEOMETRY:
        raise SystemExit("--plan currently supports the ViT models")
    g = VIT_GEOMETRY[args.model]
    keeps = [float(v) for v in args.plan.split(",")]
    block_ok = g["dim"] % g["num_heads"] == 0 and (
        g["dim"] // g["num_heads"] == 64)
    plan = plan_vit_serving(
        keeps, depth=g["depth"], dim=g["dim"],
        num_heads=g["num_heads"], mlp_ratio=g["mlp_ratio"], spec="h100",
        batch_size=args.batch_size or 128,
        fused_block=block_ok, fused_attention=not block_ok,
        snap_capacities=args.snap, allow_int8=args.int8,
    )
    print(f"# {args.model} serving plan (h100)")
    print(f"mode     : {plan.mode}")
    if plan.token_capacity:
        print("caps     : "
              + ",".join(f"{c:.3f}" for c in plan.token_capacity))
    print(f"latency  : {plan.predicted_latency * 1e3:.3f} ms/batch "
          f"(dense {plan.dense_latency * 1e3:.3f})")
    print(f"speedup  : {plan.predicted_speedup:.3f}x")
    for m, v in sorted(plan.ranking.items(), key=lambda kv: kv[1]):
        print(f"  {m:8s} {v * 1e3:8.3f} ms")
    return plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model",
                    choices=sorted(MODEL_GEOMETRY) + sorted(VIT_GEOMETRY))
    ap.add_argument("--hardware", default="v100",
                    choices=sorted(GPU_PRESETS) + list(TPU_NAMES))
    ap.add_argument("--mode", default="all",
                    help="one of static/spatial/channel/layer/all (per-stage "
                         "lists and the TPU engines' pallas/channel_gather "
                         "are refused: they need a TPU hardware model)")
    ap.add_argument("--act-rate", type=float, default=1.0)
    ap.add_argument("--granularity", default="4-4-2-1",
                    help="per-stage spatial patch sizes, dash separated")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--plan", default=None, metavar="KEEPS",
                    help="comma-separated calibrated per-block token keeps "
                         "(ViT models): rank the paradigms on the H100 "
                         "model and print the chosen ExecutionPlan instead "
                         "of the latency table")
    ap.add_argument("--snap", action="store_true",
                    help="with --plan: allow the plan to CHOOSE the "
                         "tile-snapped budget variant (it is always "
                         "priced in the ranking)")
    ap.add_argument("--int8", action="store_true",
                    help="with --plan: allow the plan to CHOOSE the W8A8 "
                         "block-engine variants (always priced when the "
                         "block engine ranks; inexact — quantization)")
    args = ap.parse_args(argv)

    if args.plan is not None:
        return _plan(args)
    if args.hardware in TPU_NAMES:
        raise SystemExit(f"--hardware {args.hardware} models a TPU engine; "
                         f"use a GPU --hardware preset "
                         f"({', '.join(sorted(GPU_PRESETS))})")

    if args.model in VIT_GEOMETRY:
        return _run_vit_gpu(args)

    grans = [int(v) for v in args.granularity.split("-")]
    gran_blocks = stage_list_to_blocks(args.model, grans)
    n_blocks = len(MODEL_GEOMETRY[args.model])
    rates = [args.act_rate] * n_blocks

    _MODES = ("static", "spatial", "channel", "layer", "pallas",
              "channel_gather")
    if "-" in args.mode:
        bad = [m for m in args.mode.split("-") if m not in _MODES]
        if bad:
            raise SystemExit(f"unknown mode(s) in per-stage list: {bad}")
        raise SystemExit(
            "per-stage --mode lists are supported on the TPU hardware "
            "models only (the GPU predictor prices uniform paradigms)")
    if args.mode == "all":
        modes = ["static", "spatial", "channel", "layer"]
    elif args.mode in _MODES:
        if args.mode in ("pallas", "channel_gather"):
            raise SystemExit(
                f"--mode {args.mode} models a TPU engine; use a TPU "
                "--hardware preset")
        modes = [args.mode]
    else:
        raise SystemExit(f"unknown --mode {args.mode!r}")

    spec = GPU_PRESETS[args.hardware]
    if args.batch_size:
        spec = spec.with_batch(args.batch_size)
    pred = DynamicPredictor(spec)
    bs = spec.batch_size

    print(f"# {args.model} on {spec.name} (batch {bs}, "
          f"act_rate {args.act_rate}, granularity {args.granularity})")
    for m in modes:
        rep = predict_network(pred, args.model, m, rates, gran_blocks)
        print(f"{m:8s}: {rep.latency * 1e3:8.3f} ms/batch "
              f"({rep.latency / bs * 1e3:7.4f} ms/img) "
              f"[compute {rep.compute_latency * 1e3:.3f} ms, "
              f"memory {rep.memory_latency * 1e3:.3f} ms]")


if __name__ == "__main__":
    main()
