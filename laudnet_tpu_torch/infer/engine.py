"""Latency-aware serving engine: calibrate -> predict -> build -> serve
(counterpart of `laudnet_tpu/infer/engine.py`).

This is the deployment-facing composition of the port — the LAUDNet loop
("let the hardware model pick the execution form") packaged as one object.
For a trained LAUD-ViT it measures the policy's realized per-block keeps on
calibration data, asks the latency model (`sim/h100.py` by default)
whether fixed-capacity token selection beats the dense-masked graph, and
builds the winner; for a LAUD-ResNet it ranks dense-masked vs layer-skip vs
spatial capacity vs (opt-in, inexact) static channel export and int8.
Every path served by default is policy-exact — nothing is dropped, frozen
or quantized relative to the masked training graph on inputs whose
realized keeps the calibrated budgets cover. The ViT block kernels default
to fast-math bodies (recorded on ``plan.fast_math``; pass
``fast_math=False`` for the exact bodies).

Typical use::

    engine = ServingEngine(model)                      # LAUDViT or LAUDResNet
    plan = engine.calibrate(calibration_batches)       # ExecutionPlan
    logits = engine(batch)                             # the planned winner

The engine takes the port's model, whose weights live in it; each form it
builds is a configured copy of the model that shares those weights
(`configured`).
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from laudnet_tpu_torch.ops.quant import QuantConv

_KEEP = object()


def configured(model, *, token_capacity=_KEEP, attn_impl=None,
               execution=None, patch_capacity=None, conv_impl=None):
    """A copy of ``model`` with serving options changed that shares every
    parameter and buffer with it (the JAX engine's ``model.clone``; no
    weight is re-initialised or copied). `LAUDViT`: ``token_capacity``,
    ``attn_impl``. `LAUDResNet`: ``execution``, ``patch_capacity`` (one
    per stage), ``conv_impl`` (the convolutions become `QuantConv` views
    of the same weights for ``'int8'``)."""
    new = copy.copy(model)
    new._modules = dict(model._modules)
    if token_capacity is not _KEEP:
        new.token_capacity = token_capacity
    if attn_impl is not None:
        new.attn_impl = attn_impl
        blocks = []
        for blk in model.blocks:
            b = copy.copy(blk)
            b.attn_impl = attn_impl
            blocks.append(b)
        new._modules["blocks"] = nn.ModuleList(blocks)
    if execution is None and patch_capacity is None and conv_impl is None:
        return new

    def quant_view(conv):
        q = copy.copy(conv)
        q.__class__ = QuantConv
        q.fake = False
        return q

    if execution is not None:
        new.execution = execution
    if conv_impl is not None:
        new.conv_impl = conv_impl
        if conv_impl != "dense":
            new._modules["conv1"] = quant_view(model.conv1)
    for s, names in enumerate(model.block_names):
        for name in names:
            blk = copy.copy(model._modules[name])
            blk._modules = dict(blk._modules)
            if execution is not None:
                blk.execution = execution
            if patch_capacity is not None:
                blk.patch_capacity = patch_capacity[s]
            if conv_impl is not None:
                blk.conv_impl = conv_impl
                if conv_impl != "dense":
                    for c in ("conv1", "conv2", "conv3", "downsample_conv"):
                        if blk._modules.get(c) is not None:
                            blk._modules[c] = quant_view(blk._modules[c])
            new._modules[name] = blk
    return new


def _images(model, x):
    """Images in the dtype of the model's parameters (a model converted to
    bf16 takes bf16 images; f32 masters under a compute dtype take f32)."""
    return x.to(next(model.parameters()).dtype)


class ServingEngine:
    """Serving wrapper around a trained LAUD model.

    ``model`` is a :class:`~laudnet_tpu_torch.models.laud_vit.LAUDViT`, a
    :class:`~laudnet_tpu_torch.models.laud_resnet.LAUDResNet` or a
    :class:`~laudnet_tpu_torch.models.laud_regnet.LAUDRegNet` (served
    dense-masked with a no-ranking plan) with its trained weights. ``temperature`` is the eval gate temperature
    (``t_last``). Before :meth:`calibrate` the engine serves the exact
    dense-masked graph; after it, the planned winner.
    """

    def __init__(self, model, *, temperature: float = 0.1,
                 spec: str = "h100", batch_size: int = 128, mesh=None,
                 snap_capacities: bool = False, fast_math: bool = True,
                 predictor=None):
        """``batch_size`` is the serving batch the latency model prices.
        ``snap_capacities`` floors token-selection capacities onto the tile
        grid (`fused_vit.snap_capacity_to_tiles`) — opt-in because it
        keeps slightly fewer tokens than the model's nominal budgets.
        ``fast_math`` (default ON) serves the block engine with the
        fast-math kernel bodies (one-pass LayerNorm, tanh GELU, softmax
        normalised after P.V), recorded on ``plan.fast_math``; it does NOT
        affect ``plan.exact``, which tracks policy approximations.
        ``predictor``: the latency model the plan asks (default: the H100
        model of ``spec`` at ``batch_size``, `sim/h100.py`). ``mesh``: a
        ``DeviceMesh`` (`parallel/mesh.py::make_mesh`) to serve
        data-parallel over, as JAX's engine does: the weights replicated
        from the first rank, each call's global batch split over the mesh's
        first dim, every rank running the planned path on its slice, and
        the logits gathered on every rank (every rank calls the engine with
        the same batch)."""
        self.mesh = mesh
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from laudnet_tpu_torch.parallel.mesh import replicate

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch DeviceMesh "
                                f"(parallel/mesh.py::make_mesh), got "
                                f"{type(mesh).__name__}")
            replicate(model, mesh)
        self.snap_capacities = snap_capacities
        self.fast_math = fast_math
        self.model = model
        self.temperature = temperature
        self.spec = spec
        self.batch_size = batch_size
        self.predictor = predictor
        self.plan = None
        self._kind = ("vit" if type(model).__name__ == "LAUDViT"
                      else "resnet")
        self._fwd = self._build(self.model)

    def _on_card(self, model) -> bool:
        return next(model.parameters()).is_cuda

    def _block_engine_ok(self, model) -> bool:
        """The block engine (`infer/fused_vit.py`) serves dense, token-
        selection and head-gated models on a card, with the parameters in
        bf16 (the kernels take bf16) and heads of 64 (what B1's attention
        takes, `ops/vit_block.py::_check_cuda`); layer gating modulates the
        residual structure, so those models keep the model's own graph. On
        the CPU neither package uses the block engine."""
        # a token-gating model without capacities keeps the model's graph:
        # the block engine only applies the eval token gate on the
        # selection path (token_capacity set)
        token_ok = (not getattr(model, "token_skip", False)
                    or getattr(model, "token_capacity", None) is not None)
        return (self._kind == "vit"
                and self._on_card(model)
                and next(model.parameters()).dtype == torch.bfloat16
                and token_ok
                and not getattr(model, "layer_skip", True)
                and getattr(model, "stem", "patch") in ("patch", "t2t")
                and model.dim % model.num_heads == 0
                and model.dim // model.num_heads == 64)

    def _build(self, model, int8: bool = False) -> Callable:
        if self._block_engine_ok(model):
            from laudnet_tpu_torch.infer.fused_vit import build_fused_vit

            return build_fused_vit(
                model, token_capacity=model.token_capacity,
                snap_capacities=self.snap_capacities,
                head_gating=getattr(model, "head_skip", False),
                int8=int8, fast_math=self.fast_math)
        assert not int8, "int8 serving requires the block engine"
        # otherwise ViTs serve the fused attention kernel (B4) on a card,
        # bf16 or f32, as the JAX engine serves them through its kernel
        if self._kind == "vit" and self._on_card(model):
            model = configured(model, attn_impl="fused")

        @torch.no_grad()
        def fwd(x):
            return model(_images(model, x), self.temperature,
                         training=False).logits

        return fwd

    def _plan_kw(self):
        return dict(spec=self.spec, batch_size=self.batch_size,
                    predictor=self.predictor)

    # --- planning -----------------------------------------------------------

    def calibrate(self, batches: Iterable, *, quantile: float = 0.99,
                  margin: float = 0.05,
                  allow_static_export: bool = False,
                  allow_int8: bool = False,
                  fidelity_threshold: float = 0.85):
        """Measure the policy on ``batches``, rank execution paths on the
        latency model, and BUILD the winner — after this returns,
        ``plan.served == plan.mode``. Returns the
        :class:`~laudnet_tpu_torch.sim.plan.ExecutionPlan`.

        ``allow_int8`` lets the plan CHOOSE the W8A8 variants (the block
        engine's int8 kernel B6 for ViTs, `QuantConv` for CNNs): inexact —
        ``plan.exact`` flips False — so it is opt-in like
        ``allow_static_export``.

        ``allow_static_export`` admits the static channel export
        (`infer/export_pruned.py`) for channel-paradigm CNNs. It freezes
        an input-dependent policy, so it is additionally gated on
        MEASURED calibration fidelity: the majority-vote static masks
        must agree with the dynamic per-image masks on at least
        ``fidelity_threshold`` of channel groups (mean over blocks,
        `infer/calibrate.calibration_fidelity` on the calibration
        batches). Below the threshold the plan DEMOTES to dense-masked and
        records the rejection in ``plan.notes``; the measured fidelity
        always lands in ``plan.fidelity``."""
        from laudnet_tpu_torch.sim.plan import (plan_resnet_serving,
                                                plan_vit_serving)

        batches = list(batches)  # consumed more than once below
        if self._kind == "vit":
            from laudnet_tpu_torch.infer.calibrate import (
                calibrate_token_capacity)

            m = self.model
            seen_size = [None]  # ranked geometry must match the real inputs

            @torch.no_grad()
            def apply_fn(x):
                seen_size[0] = x.shape[1]
                return m(_images(m, x), self.temperature, training=False)

            keeps = calibrate_token_capacity(apply_fn, batches,
                                             quantile=quantile, margin=margin)
            on_card = self._on_card(m)
            # price the implementation that will actually serve: the block
            # engine for eligible models, the model's graph with B4
            # otherwise
            block = self._block_engine_ok(
                configured(m, token_capacity=(1.0,) * m.depth))
            fused_attention = on_card and not block
            self.plan = plan_vit_serving(
                keeps, depth=m.depth, dim=m.dim, num_heads=m.num_heads,
                mlp_ratio=m.mlp_ratio, patch_size=m.patch_size,
                input_size=seen_size[0] or 224,
                fused_attention=fused_attention,
                fused_block=on_card and block,
                snap_capacities=self.snap_capacities,
                allow_int8=allow_int8 and on_card and block,
                # the no-selection alternative the engine would actually
                # serve: the token-gated masked graph for token_skip
                # models, the head-gated graph for head-only gating
                dense_mode=("mask" if getattr(m, "token_skip", False)
                            else "head" if getattr(m, "head_skip", False)
                            else "dense"),
                # B4 runs in the dtype the graph computes in
                attention_f32=(getattr(m, "compute_dtype", None)
                               or next(m.parameters()).dtype) == torch.float32,
                **self._plan_kw())
            int8 = self.plan.mode.endswith("-int8")
            eff_mode = (self.plan.mode[:-len("-int8")] if int8
                        else self.plan.mode)
            if eff_mode in ("token", "token-snapped"):
                # token-snapped capacities arrive pre-snapped from the
                # plan; snap_capacity_to_tiles is idempotent, so the
                # engine's snap flag composes harmlessly
                select = configured(m, token_capacity=self.plan.token_capacity)
                self._fwd = self._build(select, int8=int8)
            elif int8:
                # dense-int8: the block engine at full capacity with
                # quantized products (gates still multiply inside the
                # kernel for token-gated models)
                self._fwd = self._build(
                    configured(m, token_capacity=(1.0,) * m.depth)
                    if getattr(m, "token_skip", False) else m, int8=True)
            elif getattr(m, "token_skip", False) and block:
                # "dense-masked" for a token-gated model means NO
                # selection, not no gates: the block engine runs that at
                # full capacity (gates multiply inside the kernel)
                self._fwd = self._build(
                    configured(m, token_capacity=(1.0,) * m.depth))
            self.plan.served = self.plan.mode
            self.plan.fast_math = bool(self.fast_math and block and not int8)
            return self.plan

        # CNN paths: the engine builds WHATEVER the plan chooses —
        # dense-masked (always), layer-skip at batch 1
        # (`infer/layerskip.py`), spatial fixed-capacity gather execution
        # (`execution='sparse'`), W8A8 (`conv_impl='int8'`) and the static
        # channel export behind its fidelity gate (`infer/export_pruned.py`).
        # Only 'pallas' stays rank-only (B3 is not on the model's path).
        from laudnet_tpu_torch.sim.plan import ExecutionPlan

        modes = set(self.model.dyn_mode)
        dyn = next(iter(modes)) if len(modes) == 1 else None
        # measure the policy's realized activation rate on the
        # calibration batches (this is what the ranking is priced at)
        m = self.model
        rates, s3_img = [], []  # per-stage per-image conv3 densities
        with torch.no_grad():
            for x in batches:
                out = m(_images(m, x), self.temperature, training=False)
                rates.append(float(out.flops_perc.mean()))
                if out.spatial_s3_img is not None:
                    s3_img.append([s.cpu().numpy()
                                   for s in out.spatial_s3_img])
        act_rate = float(sum(rates) / len(rates)) if rates else 1.0

        layers = getattr(m, "layers", None)  # a LAUD-RegNet has none
        name = ({16: "resnet50", 33: "resnet101"}.get(sum(layers))
                if layers else None)
        if name is None:
            # no analytic geometry for this network (a RegNet, or another
            # depth): serve the model's own dense-masked graph and return
            # an honest no-ranking plan instead of pricing the wrong one
            self.plan = ExecutionPlan(kind="resnet", mode="dense-masked",
                                      served="dense-masked", exact=True,
                                      predicted_speedup=1.0, ranking={})
            return self.plan
        # mixed per-stage dyn_mode prices each stage at its own paradigm
        # (dense-masked serving); uniform models get the full ranking
        self.plan = plan_resnet_serving(
            name, dyn_mode=dyn if dyn is not None else tuple(m.dyn_mode),
            act_rate=act_rate, allow_static_export=allow_static_export,
            allow_int8=allow_int8, **self._plan_kw())
        mode = self.plan.mode
        if mode == "dense-masked-int8":
            # W8A8 convs, per-input gating fully dynamic — the only
            # approximation is quantization itself
            self._fwd = self._build(configured(m, conv_impl="int8"))
        elif mode == "layerskip" and self.batch_size == 1:
            from laudnet_tpu_torch.infer.layerskip import (
                build_layer_skip_resnet)

            ls = build_layer_skip_resnet(m)
            self._fwd = lambda x: ls(x)[0]
        elif mode in ("static-export", "static-export-int8"):
            self._static_export(batches, margin, fidelity_threshold)
        elif mode == "spatial-capacity" and s3_img:
            # fixed patch budgets covering the calibration quantile of the
            # PER-IMAGE worst-block density per stage (+margin) —
            # over-budget images fall back to dropping their least-active
            # patches
            caps = []
            for stage in range(len(s3_img[0])):
                worst = np.concatenate([b[stage].max(axis=0)
                                        for b in s3_img])
                caps.append(float(min(
                    1.0, np.quantile(worst, quantile) + margin)))
            self._fwd = self._build(configured(
                m, execution="sparse", patch_capacity=tuple(caps)))
            self.plan.token_capacity = tuple(caps)
        self.plan.served = self.plan.mode
        return self.plan

    def _static_export(self, batches, margin, fidelity_threshold):
        """Freeze the calibrated majority-vote channel masks into a real
        slim network — but only when the measured per-image fidelity
        clears the gate (freezing an input-dependent policy is the one
        approximation the engine must quantify, not hide)."""
        from laudnet_tpu_torch.infer.calibrate import (
            calibrate_channel_masks, calibration_fidelity,
            make_channel_mask_fn)
        from laudnet_tpu_torch.infer.export_pruned import (
            calibrate_export_act_scales, export_pruned_resnet)

        m, plan = self.model, self.plan
        mask_fn = make_channel_mask_fn(m, self.temperature)
        masks = calibrate_channel_masks(mask_fn, batches)
        fid = calibration_fidelity(mask_fn, masks, batches)
        plan.fidelity = fid
        if fid["mean_agreement"] >= fidelity_threshold:
            if plan.mode.endswith("-int8"):
                scales = calibrate_export_act_scales(
                    m, masks, batches, quantile=1.0, margin=margin)
                self._fwd = export_pruned_resnet(m, masks, int8=True,
                                                 act_scales=scales)
            else:
                self._fwd = export_pruned_resnet(m, masks)
            return
        # Demote to dense-masked, the graph built at construction. The JAX
        # engine takes the min over the exact choosable modes in the
        # ranking; static export exists only for the channel paradigm,
        # whose exact choosable set is {dense-masked} (layerskip and
        # spatial-capacity belong to the layer and spatial paradigms), so
        # that min is dense-masked in every reachable case.
        plan.notes = (f"static-export rejected: mean mask agreement "
                      f"{fid['mean_agreement']:.3f} < fidelity_threshold "
                      f"{fidelity_threshold}; demoted to dense-masked")
        plan.mode = "dense-masked"
        plan.exact = True
        plan.predicted_latency = plan.ranking["dense-masked"]
        plan.predicted_speedup = plan.dense_latency / plan.predicted_latency

    # --- serving --------------------------------------------------------------

    def __call__(self, batch) -> torch.Tensor:
        if not torch.is_tensor(batch):
            batch = torch.as_tensor(np.asarray(batch),
                                    device=next(self.model.parameters()).device)
        if self.mesh is None:
            return self._fwd(batch)
        import torch.distributed as dist

        from laudnet_tpu_torch.parallel.mesh import shard_batch

        axis = self.mesh.mesh_dim_names[0]
        logits = self._fwd(shard_batch(batch, self.mesh, axis))
        group = self.mesh.get_group(axis)
        parts = [torch.empty_like(logits)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, logits.contiguous(), group=group)
        return torch.cat(parts)
