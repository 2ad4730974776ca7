"""Latency-aware execution planning — the paper's core loop as an API
(counterpart of `laudnet_tpu/sim/plan.py`).

LAUDNet's thesis is that dynamic-inference choices (paradigm, granularity,
activation rates) must be made against a *hardware latency model*, not
FLOPs (`DyNetSimulator/eval_example.py` drives exactly this loop for five
GPUs). This module closes that loop for the port on the H100: given a
model geometry and a calibrated policy, rank the execution paradigms by
predicted latency and turn calibrated per-block keeps into a concrete
serving plan.

The latency model is passed in (``predictor``); by default it is
`sim/h100.py::H100Predictor` for ``spec`` (``"h100"``). A predictor
offers ``predict_vit(**kw)`` (with ``attention_f32``: B4 runs in f32),
``predict_network(model, mode, rates,
grans)`` and ``static_block(geom)`` (each a `SimulationReport`), and the
terms ``launch_cost`` (seconds per extra launch of a static export),
``s8_conv_mult`` (int8 convolutions' rate over bf16's) and
``s8_export_derate`` (the int8 export's). The decisions are the JAX
planner's, made on whatever latencies the predictor gives.

Used by :class:`laudnet_tpu_torch.infer.engine.ServingEngine`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from laudnet_tpu_torch.infer.fused_vit import snap_capacity_to_tiles
from laudnet_tpu_torch.sim.h100 import H100Predictor
from laudnet_tpu_torch.sim.hardware import HOPPER_PRESETS, HopperSpec
from laudnet_tpu_torch.sim.models import MODEL_GEOMETRY
from laudnet_tpu_torch.sim.report import SimulationReport


def _predictor(predictor, spec, batch_size):
    """The given predictor, or the H100 model of ``spec`` at the batch."""
    if predictor is not None:
        return predictor
    if isinstance(spec, str):
        spec = HOPPER_PRESETS[spec]
    return H100Predictor(spec.with_batch(batch_size))


@dataclass
class ExecutionPlan:
    """A chosen serving configuration with its predicted economics.

    ``mode`` is the path chosen under the latency model and ``served`` the
    path ServingEngine actually built. Every CHOOSABLE mode is served
    in-process (dense-masked, token select/snapped, their int8 variants,
    layer-skip at batch 1, spatial-capacity, and — behind the opt-in +
    calibration-fidelity gate — the static channel export), so after
    ``ServingEngine.calibrate`` the invariant is ``served == mode``; the
    one exception is a static export whose measured fidelity fails the
    threshold, which DEMOTES ``mode`` back to the fastest exact choosable
    path and records why in ``notes`` (the rejected candidate stays in
    ``ranking``). ``ranking`` may carry rank-only entries that can never
    be chosen: ``pallas`` (the masked bottleneck tail B3 has no
    full-model serving integration) and ``dense`` (the ungated teacher — the
    ``predicted_speedup`` frame; a gated model's no-selection serving
    form is ``dense-masked``).

    ``exact`` means no POLICY approximation: nothing is dropped, frozen
    or quantized relative to the masked training graph (int8 and static
    export flip it False). The fused serving kernels themselves default
    to fast-math bodies (one-pass LayerNorm, tanh GELU, softmax
    normalised after P.V); that is recorded separately in ``fast_math``
    (build with ``ServingEngine(..., fast_math=False)`` for the
    bit-exact kernel bodies).
    """

    kind: str  # 'vit' | 'resnet' | ...
    mode: str  # winning paradigm / execution path
    token_capacity: Optional[Sequence[float]] = None
    predicted_latency: float = 0.0  # seconds / batch
    dense_latency: float = 0.0
    predicted_speedup: float = 1.0
    ranking: dict = field(default_factory=dict)  # mode -> predicted seconds
    exact: bool = True  # no policy/quantization approximation?
    served: Optional[str] = None  # path actually compiled (None = mode)
    fidelity: Optional[dict] = None  # static-export calibration fidelity
    fast_math: bool = False  # served kernels use fast-math bodies (~5e-4)
    notes: str = ""


def rank_vit_paradigms(p, *, depth: int = 12, dim: int = 384,
                       num_heads: int = 6, mlp_ratio: float = 4.0,
                       input_size: int = 224, patch_size: int = 16,
                       token_capacity: Optional[Sequence[float]] = None,
                       fused_attention: bool = False,
                       fused_block: bool = False,
                       attention_f32: bool = False) -> dict:
    """Predicted latency (s/batch) per ViT paradigm. ``token`` uses the
    given capacities (required for it to be ranked). ``fused_attention``
    prices the served ``attn_impl='fused'`` path (B4's f32 kernel with
    ``attention_f32``, for a graph that computes in f32); ``fused_block`` the
    fully fused block engine — each mode is priced at the implementation
    ServingEngine would actually serve it with: the block engine admits
    dense / token-selection / head-gated / token-gated-at-full-capacity
    models, while layer gating modulates the residual structure and keeps
    the attention-only fusion (`ServingEngine._block_engine_ok`)."""
    geom = dict(depth=depth, dim=dim, num_heads=num_heads,
                mlp_ratio=mlp_ratio, input_size=input_size,
                patch_size=patch_size)
    out = {}
    for m in ("dense", "head", "layer", "mask"):
        blk = fused_block and m != "layer"
        out[m] = p.predict_vit(
            mode=m, fused_attention=fused_attention or (fused_block
                                                        and not blk),
            fused_block=blk, attention_f32=attention_f32, **geom).latency
    if token_capacity is not None:
        out["token"] = p.predict_vit(
            mode="token", token_capacity=token_capacity,
            fused_attention=fused_attention, fused_block=fused_block,
            attention_f32=attention_f32, **geom).latency
    return out


def plan_vit_serving(keeps: Sequence[float], *, depth: int = 12,
                     dim: int = 384, num_heads: int = 6,
                     mlp_ratio: float = 4.0, input_size: int = 224,
                     patch_size: int = 16, spec: str | HopperSpec = "h100",
                     batch_size: int = 128,
                     fused_attention: bool = False,
                     fused_block: bool = False,
                     snap_capacities: bool = False,
                     allow_int8: bool = False,
                     dense_mode: str = "mask",
                     attention_f32: bool = False,
                     predictor=None) -> ExecutionPlan:
    """Build the serving plan from calibrated per-block keep fractions
    (`infer.calibrate.calibrate_token_capacity` output).

    Capacities are clamped monotone non-increasing (gates compose, so the
    realized keep can never grow with depth — a noisy calibration estimate
    that says otherwise only wastes budget). The fastest *exact* paradigm
    under the predictor is chosen: token selection when it beats the
    no-selection alternative the engine would actually serve —
    ``ranking[dense_mode]``, where ``dense_mode`` names the paradigm of the
    masked graph a "dense" decision falls back to (``"mask"`` for a
    token-gated model, ``"head"`` for head-only gating, ``"dense"`` for an
    ungated one). ``ranking["dense"]`` stays the pure ungated baseline and
    the ``predicted_speedup`` frame. The ranking always also prices
    ``token-snapped`` — the same budgets floored onto the tile grid
    (`infer.fused_vit.snap_capacity_to_tiles`; the predictor's tile-
    quantization term is what makes it faster) — but it is only CHOSEN
    when ``snap_capacities`` opts in, because it keeps slightly fewer
    tokens than calibration asked for.

    When the block engine is priced (``fused_block``), the W8A8 int8
    variants (``dense-int8`` / ``token-int8`` / ``token-snapped-int8``,
    `fused_vit_block_int8`) are always RANKED; they are only CHOSEN when
    ``allow_int8`` opts in, because quantization is inexact (the plan's
    ``exact`` flips False) — same contract as static export on the CNN
    side.
    """
    p = _predictor(predictor, spec, batch_size)

    caps, lo = [], 1.0
    for k in keeps:
        lo = min(lo, min(float(k), 1.0))
        caps.append(lo)
    caps = tuple(caps)

    ranking = rank_vit_paradigms(
        p, depth=depth, dim=dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
        input_size=input_size, patch_size=patch_size, token_capacity=caps,
        fused_attention=fused_attention, fused_block=fused_block,
        attention_f32=attention_f32,
    )
    # snapped variant: convert fractions -> token counts -> tile grid ->
    # fractions (mirrors build_fused_vit's per-layer k computation)
    n = (input_size // patch_size) ** 2 + 1
    snapped, cur = [], n
    for c in caps:
        k = min(max(2, int(c * n)), cur)
        if k < cur:
            k = min(max(2, snap_capacity_to_tiles(k)), cur)
        cur = min(cur, k)
        # effective monotone fraction; (cur + 0.5)/n so downstream
        # int(frac * n) lands exactly on cur
        snapped.append((cur + 0.5) / n if cur < n else 1.0)
    snapped = tuple(snapped)
    if snapped != caps:
        ranking["token-snapped"] = p.predict_vit(
            mode="token", token_capacity=snapped, depth=depth, dim=dim,
            num_heads=num_heads, mlp_ratio=mlp_ratio,
            input_size=input_size, patch_size=patch_size,
            fused_attention=fused_attention,
            fused_block=fused_block, attention_f32=attention_f32).latency

    if fused_block:
        geo = dict(depth=depth, dim=dim, num_heads=num_heads,
                   mlp_ratio=mlp_ratio, input_size=input_size,
                   patch_size=patch_size)
        # a "dense-int8" decision on a gated model serves the block
        # engine at full capacity WITH the policy heads still running —
        # price it at dense_mode's paradigm so the exact-vs-int8
        # comparison charges both sides the same gating heads
        eff_dense = dense_mode if dense_mode in ("mask", "head") else "dense"
        ranking["dense-int8"] = p.predict_vit(
            mode=eff_dense, fused_block=True, int8=True, **geo).latency
        ranking["token-int8"] = p.predict_vit(
            mode="token", token_capacity=caps, fused_block=True,
            int8=True, **geo).latency
        if snapped != caps:
            ranking["token-snapped-int8"] = p.predict_vit(
                mode="token", token_capacity=snapped, fused_block=True,
                int8=True, **geo).latency

    dense = ranking["dense"]
    served_dense = ranking.get(dense_mode, dense)
    token = ranking.get("token", served_dense)
    snap_lat = ranking.get("token-snapped", float("inf"))
    # the no-selection decision is named by what it SERVES: the masked
    # graph ('dense-masked') for a gated model, the truly ungated graph
    # ('dense') otherwise — so ServingEngine's served == mode holds on
    # the common no-win path too
    no_sel = "dense" if dense_mode == "dense" else "dense-masked"
    mode = "token" if token < served_dense else no_sel
    chosen = min(token, served_dense)
    chosen_caps = caps
    if snap_capacities and snap_lat < chosen:
        mode, chosen, chosen_caps = "token-snapped", snap_lat, snapped
    exact = True
    if allow_int8 and fused_block:
        int8_cands = [("dense-int8", None), ("token-int8", caps)]
        if snap_capacities and "token-snapped-int8" in ranking:
            int8_cands.append(("token-snapped-int8", snapped))
        for name, c in int8_cands:
            if ranking[name] < chosen:
                mode, chosen, chosen_caps, exact = (
                    name, ranking[name], c, False)
    return ExecutionPlan(
        kind="vit", mode=mode,
        token_capacity=(chosen_caps if mode not in (
            "dense", "dense-masked", "dense-int8") else None),
        predicted_latency=chosen, dense_latency=dense,
        predicted_speedup=dense / chosen, ranking=ranking, exact=exact,
    )


_RESNET_DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}

# serving a stage dense-masked: the paradigm's own masker heads on a
# static body (the 0/1 multiplies fuse for free)
_MASKED_BLOCK_MODE = {"channel": "channel", "spatial": "spatial_masked",
                      "layer": "layer", "both": "both_masked",
                      "static": "static"}


def plan_resnet_serving(model_name: str = "resnet101", *,
                        dyn_mode: str | Sequence[str] = "channel",
                        act_rate: float = 0.5,
                        granularity: int = 4,
                        spec: str | HopperSpec = "h100",
                        batch_size: int = 128,
                        allow_static_export: bool = False,
                        allow_int8: bool = False,
                        predictor=None) -> ExecutionPlan:
    """Pick the CNN serving path by predicted latency.

    Exact paths: ``dense-masked`` (masks fuse for free), ``layerskip``
    (batch-1 only), ``pallas``/``spatial`` capacity execution (exact at
    full capacity coverage). ``static-export`` is NOT exact (it freezes an
    input-dependent policy; see `infer/export_pruned.py`) and is only
    considered when ``allow_static_export``.

    ``dyn_mode`` may be a per-stage sequence (the reference's
    ``--dyn_mode channel-channel-layer-layer`` configs): mixed models are
    priced per stage at each stage's own paradigm and serve dense-masked
    (the only exact whole-network path when paradigms differ).
    """
    p = _predictor(predictor, spec, batch_size)
    geom = MODEL_GEOMETRY[model_name]
    n_blocks = len(geom)
    rates = [act_rate] * n_blocks
    grans = [granularity] * n_blocks

    def lat(mode, r=None):
        return p.predict_network(model_name, mode,
                                 r if r is not None else rates,
                                 grans).latency

    dense = lat("static", [1.0] * n_blocks)

    if not isinstance(dyn_mode, str):
        stage_modes = list(dyn_mode)
        if len(set(stage_modes)) == 1:
            dyn_mode = stage_modes[0]  # uniform: full per-paradigm ranking
        else:
            depths = _RESNET_DEPTHS[model_name]
            if len(stage_modes) != len(depths):
                raise ValueError(
                    f"dyn_mode has {len(stage_modes)} stages, "
                    f"{model_name} has {len(depths)}")
            per_block = [_MASKED_BLOCK_MODE[m]
                         for m, d in zip(stage_modes, depths)
                         for _ in range(d)]
            rep_m = p.predict_network(model_name, per_block, rates, grans)
            masked = rep_m.latency
            ranking = {"dense": dense, "dense-masked": masked}
            # int8 dense-masked serving is paradigm-independent (W8A8
            # convs, per-input gating fully dynamic), so the mixed-mode
            # plan ranks it exactly like the uniform branch below —
            # allow_int8 must not be dropped here (static export stays
            # channel-paradigm-only, matching the uniform gate)
            ov = masked - max(rep_m.compute_latency, rep_m.memory_latency)
            ranking["dense-masked-int8"] = (
                max(rep_m.compute_latency / p.s8_conv_mult,
                    rep_m.memory_latency) + ov
            )
            mode = "dense-masked"
            if allow_int8 and ranking["dense-masked-int8"] < masked:
                mode = "dense-masked-int8"
            chosen = ranking[mode]
            return ExecutionPlan(
                kind="resnet", mode=mode, predicted_latency=chosen,
                dense_latency=dense, predicted_speedup=dense / chosen,
                ranking=ranking, exact=mode == "dense-masked",
            )
    # dense-masked = static body + the paradigm's masker heads. The JAX
    # planner prices every uniform paradigm by 'channel' (on the TPU the
    # mask algebra fuses and the heads cost alike); on the H100 the eager
    # spatial masker (upsample, dilations, 52 launches a block) costs more
    # host time than the channel one (40), so spatial and both models are
    # priced by their own masked form. Layer maskers stay on 'channel', as
    # in JAX: 'layer' at batch 1 is the layer-skip price.
    masked_mode = {"spatial": "spatial_masked",
                   "both": "both_masked"}.get(dyn_mode, "channel")
    rep = p.predict_network(model_name, masked_mode, rates, grans)
    ranking = {"dense": dense, "dense-masked": rep.latency}
    # int8 dense-masked (`LAUDResNet(conv_impl='int8')`): W8A8 convs with
    # the per-input gating fully dynamic. The conv stack is priced at the
    # predictor's measured int8-convolution multiplier (`s8_conv_mult`:
    # `QuantConv` against cuDNN's bf16, `tools/probe_int8.py`), the rest
    # unchanged.
    ov = rep.latency - max(rep.compute_latency, rep.memory_latency)
    ranking["dense-masked-int8"] = (
        max(rep.compute_latency / p.s8_conv_mult, rep.memory_latency) + ov
    )
    if dyn_mode == "spatial":
        ranking["spatial-capacity"] = lat("spatial")  # gather engine
        ranking["pallas"] = lat("pallas")
    if dyn_mode == "layer" and batch_size == 1:
        ranking["layerskip"] = lat("layer")
    if allow_static_export and dyn_mode == "channel":
        # static export: a plain smaller network — each block's inner width
        # shrinks to the calibrated keep (`infer/export_pruned.py` slices
        # conv1-out / conv2 / conv3-in to the kept channel groups)
        total = sum(
            (p.static_block(replace(
                g, width=max(8, int(round(g.width * act_rate)))))
             for g in geom),
            start=SimulationReport(),
        )
        n_ops = len(total.cfg)
        ranking["static-export"] = (
            max(total.compute_latency, total.memory_latency)
            + n_ops * p.launch_cost
        )
        # W8A8 on the exported network, priced at the predictor's derate
        # (`s8_export_derate`: the convolution of codes against cuDNN's
        # bf16, `tools/probe_int8.py`)
        ranking["static-export-int8"] = (
            ranking["static-export"] / p.s8_export_derate
        )
    inexact = {"static-export", "static-export-int8", "dense-masked-int8"}
    # rank-only: 'pallas' has no full-model serving integration (B3 is
    # not on the model's path), and 'dense' is the ungated TEACHER — the
    # speedup frame, not a servable path for a gated model (its masker
    # heads exist; dense-masked is the no-selection serving form)
    rank_only = {"pallas", "dense"}
    exact_modes = {k: v for k, v in ranking.items()
                   if k not in inexact and k not in rank_only}
    mode = min(exact_modes, key=exact_modes.get)
    if allow_static_export and "static-export" in ranking and (
            ranking["static-export"] < exact_modes[mode]):
        mode = "static-export"
    if allow_int8 and ranking["dense-masked-int8"] < ranking[mode]:
        mode = "dense-masked-int8"
    if (allow_static_export and allow_int8
            and "static-export-int8" in ranking
            and ranking["static-export-int8"] < ranking[mode]):
        mode = "static-export-int8"
    chosen = ranking[mode]
    return ExecutionPlan(
        kind="resnet", mode=mode, predicted_latency=chosen,
        dense_latency=dense, predicted_speedup=dense / chosen,
        ranking=ranking, exact=mode not in inexact,
    )
