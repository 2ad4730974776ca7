"""B2 against B1 on the card: the serving engine with the layers between
gathers run as segments (`fused_vit_segment`, B2) against the same engine
one layer a call (`fused_vit_block`, B1) (counterpart of
`tools/probe_segments.py`).

    python -m laudnet_tpu_torch.tools.probe_segments [--sweep] [--device cuda]

The JAX probe's models, forms and JSON keys, at its geometry (batch 128,
224x224 images, bf16), built on the card from seeded random weights:
DeiT-S without gates (``dense``), LAUD-DeiT-S with its token gates at the
capacities ``(1.0,)*3 + (0.7,)*4 + (0.5,)*5`` (``select``; ``snap`` with
the capacities snapped to tiles) and DeiT-B without gates. Each form runs
once with ``segments`` on (``seg``) and off (``blk``). ``segments=True``
engages only where tokens are selected, so the dense ``seg`` forms pass
``segments=5``: with True they would run B1 twice and report a ratio of 1.

* default: ``deit_s_{dense,select,snap}_{seg,blk}``,
  ``deit_b_dense_{seg,blk}`` in img/s, and the ratios ``deit_s_dense_ratio``,
  ``deit_s_snap_ratio``, ``deit_b_dense_ratio`` (seg over blk); then B2
  against B1 layer by layer: one 5-layer segment against five B1 calls at
  L = 98 on the models' own layers, DeiT-S and DeiT-B width;
* ``--sweep``: the segment length, ``deit_s_dense_seg{2,3,4,6}``,
  ``deit_s_snap_seg{2,3,4,5}``, ``deit_b_dense_seg{2,3,4}`` (the engine
  caps a segment at 5 layers, so seg6 runs seg5's plan, as in JAX).

Beyond the JAX probe: every form first runs once and is checked. A ``seg``
form must launch B2 for each segment the engine planned and no B1, a
``blk`` form B1 for every layer and no B2, and a ``seg`` form's logits must
be within ULPS bf16 ulps of its ``blk`` form's largest logit for each
segment it ran (`seg_bound`; on the CPU's plain versions the two are equal
bit for bit). A ``seg`` form
that ran no segment cannot give a ratio (`ratio` raises). Then each
``seg`` form is timed in turns with its ``blk`` form (rounds of seg, blk,
blk, seg; each reading a chain of forwards between CUDA events,
`tools/timing.py`), so that a slow spell of the host falls on both; each
form prints its ms, µs per image and layer, its spread across readings
and its launches. The JSON line carries the card's name and power limit.

A probe of the card's kernels: it refuses the CPU. `build_forms` and
`check_forms` take any device and ``plain=True`` (the kernels' plain
versions), which is how the CPU tests run them.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

from laudnet_tpu_torch.infer.fused_vit import block_params, build_fused_vit
from laudnet_tpu_torch.models import laud_deit_base, laud_deit_small
from laudnet_tpu_torch.ops import vit_block
from laudnet_tpu_torch.tools.timing import in_turns

BATCH, SIZE, DTYPE = 128, 224, torch.bfloat16
CAPS = (1.0,) * 3 + (0.7,) * 4 + (0.5,) * 5
# family -> (model, engine options, the seg form's ``segments``)
FAMILIES = {
    "deit_s_dense": ("plain_s", {}, 5),
    "deit_s_select": ("laud_s", {"token_capacity": CAPS}, True),
    "deit_s_snap": ("laud_s", {"token_capacity": CAPS,
                               "snap_capacities": True}, True),
    "deit_b_dense": ("plain_b", {}, 5),
}
SWEEP = {"deit_s_dense": (2, 3, 4, 6), "deit_s_snap": (2, 3, 4, 5),
         "deit_b_dense": (2, 3, 4)}
RATIOS = ("deit_s_dense", "deit_s_snap", "deit_b_dense")
# seg against blk on the card: both round to bf16 at the same points, but
# B2 computes each interior layer's LayerNorm and token gate in the epilogue
# of the fc2 before it, summing rows in another order than B1's own LN1
# launch and the engine's gate. `chip_smoke.py` holds each B2 call to its
# plain version (the chain of its layers) within ULPS bf16 ulps of the
# largest output; a seg form swaps k such calls for chains of B1 calls, and
# a pre-norm residual stream carries each call's difference on, so its
# logits may sit ULPS ulps of the largest logit a segment from the blk
# form's (DeiT-S select: 5 ulps over 3 segments on the H100). A wrong mask,
# gate or layer moves logits by tens of ulps.
ULPS = 4
ROUNDS, CHAIN, REPEATS = 5, 3, 3
LAYER_L, LAYER_N = 98, 5  # the layer-by-layer comparison: B2's segment shape


def build_models(device, seed=0):
    """The JAX probe's three models, seeded, on ``device``, in bf16."""
    dev = torch.device(device)
    off = dict(token_skip=False, head_skip=False, layer_skip=False)
    builds = {"plain_s": lambda **kw: laud_deit_small(**off, **kw),
              "laud_s": laud_deit_small,
              "plain_b": lambda **kw: laud_deit_base(**off, **kw)}
    return {name: build(device=dev, generator=torch.Generator(dev).manual_seed(
        seed + i)).to(DTYPE).eval() for i, (name, build) in enumerate(
        builds.items())}


def build_forms(models, *, sweep=False, plain=False):
    """``key -> forward`` for the JAX probe's keys of one mode (``models``
    as `build_models` returns them; ``plain``: the plain versions)."""
    def form(family, segments):
        name, opts, _ = FAMILIES[family]
        return build_fused_vit(models[name], segments=segments, plain=plain,
                               **opts)

    if sweep:
        return {f"{family}_seg{n}": form(family, n)
                for family, lengths in SWEEP.items() for n in lengths}
    return {f"{family}_{tag}": form(family, seg if tag == "seg" else False)
            for tag in ("seg", "blk")
            for family, (_, _, seg) in FAMILIES.items()}


def blk_of(key):
    """The ``blk`` form a ``seg`` form is held and timed against."""
    return key[:key.rindex("_seg")] + "_blk"


def ulp(t):
    """One bf16 ulp (8 significant bits) of ``t``'s largest |entry|."""
    return 2.0 ** (math.floor(math.log2(t.float().abs().max().item())) - 7)


def seg_bound(blk_logits, segments=1):
    """ULPS bf16 ulps of the largest |logit| for each segment call."""
    return ULPS * segments * ulp(blk_logits)


COUNTED = {"segment": vit_block.fused_vit_segment,
           "block": vit_block.fused_vit_block}


def run_form(forward, images):
    """One forward: its logits, the segments the engine ran (layers each)
    and the B2 and B1 launches it made (always 0 on the CPU)."""
    before = {k: fn.launches for k, fn in COUNTED.items()}
    logits = forward(images)
    if images.is_cuda:
        torch.cuda.synchronize()
    launches = {k: fn.launches - before[k] for k, fn in COUNTED.items()}
    return {"logits": logits, "segments": list(forward.segment_layers),
            "launches": launches}


def check_forms(forms, images, blk_forms=None):
    """Runs every form once and checks it (the module docstring); returns
    ``key -> run_form(...)`` with ``max_diff`` and ``bound`` added to each
    ``seg`` form. ``blk_forms``: where the ``blk`` forms are, if not in
    ``forms`` (the sweep)."""
    blk_forms = forms if blk_forms is None else blk_forms
    on_card = images.is_cuda
    readings = {}
    for key in sorted({blk_of(k) for k in forms if "_seg" in k}):
        forward = blk_forms[key]
        r = readings[key] = run_form(forward, images)
        if r["segments"] or (on_card and r["launches"] != {
                "segment": 0, "block": len(forward.token_counts)}):
            raise AssertionError(f"{key}: a blk form ran a segment or not "
                                 f"one B1 a layer: {r['launches']}, "
                                 f"segments {r['segments']}")
    for key, forward in forms.items():
        if key.endswith("_blk"):
            continue
        r = readings[key] = run_form(forward, images)
        if not r["segments"]:
            raise AssertionError(f"{key}: a seg form ran no segment")
        if on_card and (r["launches"]["segment"] != len(r["segments"])
                        or r["launches"]["block"]):
            raise AssertionError(f"{key}: launches {r['launches']} for the "
                                 f"engine's segments {r['segments']}")
        blk = readings[blk_of(key)]["logits"]
        r["max_diff"] = (r["logits"].float() - blk.float()).abs().max().item()
        r["ulps"] = r["max_diff"] / ulp(blk)
        r["bound"] = seg_bound(blk, len(r["segments"])) if on_card else 0.0
        if not r["max_diff"] <= r["bound"]:
            raise AssertionError(f"{key}: seg logits {r['max_diff']} from "
                                 f"blk, bound {r['bound']}")
    return readings


def ratio(seg, blk):
    """img/s of a ``seg`` form over its ``blk`` form (readings with
    ``img_s``); refuses a ``seg`` form that ran no segment."""
    if not seg["segments"]:
        raise ValueError("a seg form that ran no segment (B2) gives no "
                         "ratio: it timed B1 against B1")
    if blk["segments"]:
        raise ValueError("a blk form ran a segment")
    return seg["img_s"] / blk["img_s"]


def _summary(readings_ms, depth):
    ms = statistics.median(readings_ms)
    return {"ms": ms, "img_s": BATCH / (ms / 1e3),
            "us_image_layer": ms * 1e3 / BATCH / depth,
            "spread": (max(readings_ms) - min(readings_ms)) / ms}


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0]


def measure(forms, readings, images, blk_forms, card=""):
    """Times every ``seg`` form in turns with its ``blk`` form; prints a
    line a form; adds ms, img/s, µs per image and layer and spread to
    ``readings``."""
    blk_timed = {}
    for key in (k for k in forms if "_seg" in k):
        bkey = blk_of(key)
        seg_ms, blk_ms = in_turns(lambda: forms[key](images),
                                  lambda: blk_forms[bkey](images), CHAIN,
                                  ROUNDS, REPEATS, 1)
        depth = len(blk_forms[bkey].token_counts)
        readings[key].update(_summary(seg_ms, depth))
        blk_timed.setdefault(bkey, []).extend(blk_ms)
        readings[bkey].update(_summary(blk_timed[bkey], depth))
        for k in (key, bkey):
            r = readings[k]
            print(f"{k}: {r['ms']:.4f} ms, {r['img_s']:.1f} img/s, "
                  f"{r['us_image_layer']:.4f} us per image and layer, "
                  f"spread {r['spread']:.4f}, launches B2 "
                  f"{r['launches']['segment']} B1 {r['launches']['block']}, "
                  f"segments {r['segments']}"
                  + (f", max |seg - blk| logit {r['max_diff']:.6g} = "
                     f"{r['ulps']:g} ulps of the largest (bound "
                     f"{r['bound']:.6g}: {ULPS} ulps x "
                     f"{len(r['segments'])} segments)" if "max_diff" in r
                     else "")
                  + f" [{card}]")


def layer_by_layer(model, device, card="", l=LAYER_L, n=LAYER_N, seed=0):
    """One n-layer segment (B2, no interior gates) against n B1 calls on
    ``model``'s last n layers at L = ``l``, bs BATCH, fast_math, in turns;
    both held to each other within ULPS. Returns ms a layer of each."""
    g = torch.Generator(device).manual_seed(seed)
    d = model.dim
    x = torch.randn(BATCH, l, d, device=device, generator=g).to(DTYPE)
    mask = torch.ones(BATCH, l, device=device)
    km, rm = mask.reshape(BATCH, 1, l), mask.reshape(BATCH, l, 1)
    plist = [block_params(b) for b in list(model.blocks)[-n:]]
    kw = dict(num_heads=model.num_heads, fast_math=True)

    def seg():
        return vit_block.fused_vit_segment(x, mask, plist, **kw)[0]

    def blk():
        y = x
        for p in plist:
            y = vit_block.fused_vit_block(y, km, rm, p, **kw)
        return y

    a, b = seg(), blk()
    torch.cuda.synchronize()
    err = (a.float() - b.float()).abs().max().item()
    tol = seg_bound(b)
    if not err <= tol:
        raise AssertionError(f"layer by layer D={d}: B2 {err} from B1, "
                             f"bound {tol}")
    seg_ms, blk_ms = in_turns(seg, blk, CHAIN, ROUNDS, REPEATS, 1)
    out = {"b2_ms_layer": statistics.median(seg_ms) / n,
           "b1_ms_layer": statistics.median(blk_ms) / n}
    print(f"layer by layer D={d} L={l}, {n} layers, bs{BATCH} fast_math: B2 "
          f"{out['b2_ms_layer']:.4f} ms a layer, B1 {out['b1_ms_layer']:.4f} "
          f"(B2 / B1 {out['b2_ms_layer'] / out['b1_ms_layer']:.4f}; max "
          f"|B2 - B1| {err:.6g}, bound {tol:.6g}) [{card}]")
    return out


def run(sweep=False, device="cuda", drive=None, seed=0):
    """The probe on the card; returns the JSON object it prints.
    ``drive``: the checked forward of every form runs as ``drive(fn)``
    (`chip_smoke.py` counts its launches there); the timed ones do not."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"probe_segments probes the card's kernels and "
                         f"does not run on {dev.type!r}")
    card = card_name()
    models = build_models(dev, seed)
    images = torch.randn(BATCH, SIZE, SIZE, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(
                             seed + 10)).to(DTYPE)
    blk_forms = build_forms(models)
    forms = build_forms(models, sweep=True) if sweep else blk_forms
    check = lambda: check_forms(forms, images, blk_forms)  # noqa: E731
    readings = (drive or (lambda fn: fn()))(check)
    measure(forms, readings, images, blk_forms, card)
    out = {key: round(readings[key]["img_s"], 1) for key in forms}
    if not sweep:
        for family in RATIOS:
            out[f"{family}_ratio"] = round(ratio(
                readings[f"{family}_seg"], readings[f"{family}_blk"]), 4)
        for name in ("plain_s", "plain_b"):
            layer_by_layer(models[name], dev, card)
    out["card"] = card
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise SystemExit(f"probe_segments: a probe of the card's kernels; "
                         f"it does not run on the CPU (--device "
                         f"{args.device})")
    if not torch.cuda.is_available():
        raise SystemExit("probe_segments: torch.cuda.is_available() is "
                         "false; the probe needs a CUDA card")
    print(json.dumps(run(sweep=args.sweep, device=args.device)))


if __name__ == "__main__":
    main()
