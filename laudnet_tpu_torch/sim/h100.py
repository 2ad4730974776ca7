"""The latency model of the port's own execution forms on the H100.

Counterpart of `laudnet_tpu/sim/tpu.py` (`TPUPredictor`), which prices the
JAX package's forms on a TPU, where one XLA executable overlaps its ops and
pays a fusion overhead per region. Here every form is an eager PyTorch
program: a sequence of kernel launches, each issued by the host and run by
the card one after the other. So:

* an op's device time is ``max(flops / rate, bytes / bandwidth)`` plus the
  card's gap between two launches (``device_launch``), with the rate and
  bandwidth fractions the port's kernels were measured at
  (`sim/hardware.py::HopperSpec`);
* a forward's time is the larger of its device time and its host time,
  the host's cost of each launch (``host_launch`` for a launch of a block
  wrapper, ``eager_host_launch`` for an operation of the eager model
  graph), of each call of a block wrapper (``host_call``), plus one
  ``host_sync`` per value read to the host: a form with many small
  launches is host-bound (the CNN flagship dispatches 1,062 operations a
  forward and the card idles half of it);
* a report's ``compute_latency`` is the device time of all its ops (the
  card runs them one after the other, so the JAX planner's max(compute,
  memory) is the device time here), ``memory_latency`` the part of it in
  memory-bound ops, and ``cfg`` holds one entry per launch. The planner's
  int8 pricing divides ``compute_latency`` by ``s8_conv_mult``: the int8
  CNN's quantising passes slow with its convolutions.

ViT forms (`infer/fused_vit.py`): per layer B1's 6 launches (5 inside a
B2 segment, B6's 7: `block_layer`), with
the four products at the GEMM core's measured fraction of peak, their rows
and columns padded to its 128 x 192 (or 224) tile (`tiles.ceil_eff`: what
makes 128 tokens cheaper than 137) and their tiles spread in whole waves
over the SMs, the attention kernel at its measured rate on
64-query tiles and 16-key tiles, LayerNorm at its measured bandwidth; the
gate and gather (`gate_and_select`: a stable sort, a gather); the patch
convolution and the head. Forms outside the block engine run
`models/laud_vit.py` eagerly: cuBLAS products, the fused attention (B4) or
the reference attention, and the elementwise passes around them.

CNN forms (`models/laud_resnet.py`): the cuDNN convolutions at their
measured rate, and the eager passes (BatchNorm, ReLU, residual add); the
gating heads and mask algebra of the dense-masked graph at the launches
its spatial or channel maskers dispatch; sparse execution's gather and
scatter-add at their measured bandwidth; B3 (``pallas``, rank-only) at its
measured rows; layer skip at batch 1 as the blocks it runs plus one host
read per gate; the static export (`infer/export_pruned.py`, what
``static_block`` prices) as its slim convolutions and its own eager passes;
the int8 forms through the plan's ``s8_conv_mult`` and
``s8_export_derate`` (`QuantConv`'s and the convolution of codes' measured
rates against cuDNN's bf16).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional, Sequence

from laudnet_tpu_torch.sim.hardware import HOPPER_PRESETS, HopperSpec
from laudnet_tpu_torch.sim.models import MODEL_GEOMETRY, BlockGeom
from laudnet_tpu_torch.sim.report import SimulationReport
from laudnet_tpu_torch.sim.tiles import ceil_eff

# Bytes of a value of the compute dtype: every pinned rate is a bf16 rate.
_BF16 = 2
# Launches the port issues, counted from its code (eager ops that reach
# the card; casts of f32 master weights to the compute dtype included).
_CONV_LAUNCHES = 2        # weight cast + cuDNN convolution
_GATE_LAUNCHES = 6        # token / head policy: cast, product, compare...
_SELECT_LAUNCHES = 9      # gate_and_select's rank, sort and gathers
_EAGER_LAYER_LAUNCHES = 30  # one LAUDViTBlock eval forward outside B1
_LN_PASSES = 10           # plain f32 LayerNorm: casts, moments, affine
# The dense-masked graph's gating heads and mask algebra, per block, as
# its eval forward dispatches them (tests/test_torch_sim.py counts them):
# a spatial masker with the mask upsample, the two dilations and their
# bookkeeping 53 (the flagship: 1,079 operations a forward against the
# dense ResNet-50's 230), a channel masker with its two mask multiplies 41;
# each counts the fill that puts the block's masker FLOPs on the card.
_SPATIAL_MASK_LAUNCHES = 53
_CHANNEL_MASK_LAUNCHES = 41
_SPARSE_LAUNCHES = 16     # select_patches, gather, scatter-add per block
_B3_LAUNCHES = 2          # B3: the selection kernel and the tail
# the block engine's kernels, each one launch through its ctypes wrapper
_WRAPPER_OPS = frozenset({"gemm", "attention", "layernorm", "rowquant"})


class H100Predictor:
    """Analytic latency of the port's execution forms on one Hopper card."""

    def __init__(self, spec: HopperSpec | str = "h100"):
        if isinstance(spec, str):
            spec = HOPPER_PRESETS[spec]
        self.spec = spec

    # --- terms the planner reads ---------------------------------------------

    @property
    def launch_cost(self) -> float:
        """Device seconds per launch, the gap between two kernels: what
        each launch of a static export adds (the counterpart of the TPU's
        per-fusion overhead; an export at batch 128 is device-bound)."""
        return self.spec.device_launch

    @property
    def s8_conv_mult(self) -> float:
        """ResNet-50's device time at this batch with cuDNN's bf16
        convolutions over that with `QuantConv`'s (the rest unchanged): the
        factor the planner divides a masked forward's device time by to
        price ``conv_impl='int8'``."""
        return self._resnet50_device(self.spec.qconv_rate)

    @property
    def s8_export_derate(self) -> float:
        """The same with the static int8 export's convolution (codes
        through `int_conv2d`, static scales) in place of `QuantConv`."""
        return self._resnet50_device(self.spec.int_conv_rate)

    def _resnet50_device(self, int_rate: float) -> float:
        """Device time of the dense ResNet-50 with cuDNN's convolutions over
        that with convolutions at ``int_rate``."""
        slow = H100Predictor(replace(self.spec, conv_rate=int_rate))
        return (self.predict_network("resnet50", "static").compute_latency
                / slow.predict_network("resnet50", "static").compute_latency)

    # --- primitives ----------------------------------------------------------

    def _op(self, flops: float, bytes_moved: float, rate: float,
            launches: int = 1, op: str = "op") -> SimulationReport:
        """``launches`` kernels doing ``flops`` at ``rate`` and moving
        ``bytes_moved`` at the card's bandwidth."""
        s = self.spec
        compute = flops / rate if flops else 0.0
        memory = bytes_moved / s.mem_bandwidth
        t = max(compute, memory) + launches * s.device_launch
        return SimulationReport(
            latency=t, compute_latency=t,
            memory_latency=t if memory > compute else 0.0,
            cfg=[dict(op=op)] * launches)

    def eager(self, bytes_moved: float, launches: int,
              op: str = "eager") -> SimulationReport:
        """Memory-bound eager PyTorch passes at their measured bandwidth."""
        return self._op(0.0, bytes_moved / self.spec.eager_bw_frac,
                        1.0, launches, op)

    def finish(self, rep: SimulationReport, syncs: int = 0
               ) -> SimulationReport:
        """A whole forward: the larger of the device's time and the host's
        (its launches and ``syncs`` reads of device values). A block-engine
        kernel costs the host one ctypes launch (``host_launch``) and each
        call of a block wrapper its checks (``host_call``); any other launch
        is an operation of the eager model graph (``eager_host_launch``)."""
        s = self.spec
        host = sum(s.host_call if c.get("op") == "call" else
                   s.host_launch if c.get("op") in _WRAPPER_OPS
                   else s.eager_host_launch for c in rep.cfg)
        host += syncs * s.host_sync
        return SimulationReport(
            latency=max(rep.latency, host),
            compute_latency=rep.compute_latency,
            memory_latency=rep.memory_latency, cfg=rep.cfg)

    # --- ViT -----------------------------------------------------------------

    def block_gemm(self, rows: int, k: int, n: int, int8: bool = False,
                   out_bytes: int = 2) -> SimulationReport:
        """One product of B1 (B6 with ``int8``) on the GEMM core
        (`csrc/gemm_sm90.cuh`): rows and columns padded to its 128 x BN
        tile (BN 224 where 224 divides N and 192 does not, else 192), and
        the tiles spread over the SMs in whole waves of persistent
        blocks."""
        s = self.spec
        bn = 224 if n % 224 == 0 and n % 192 else 192
        tiles = -(-rows // 128) * -(-n // bn)
        eff = (ceil_eff(rows, 128) * ceil_eff(n, bn)
               * tiles / (-(-tiles // s.n_sms) * s.n_sms))
        rate = (s.peak_int8 * s.block_s8_gemm_frac if int8
                else s.peak_bf16 * s.block_gemm_frac) * eff
        ab = 1 if int8 else _BF16
        return self._op(2.0 * rows * k * n,
                        rows * k * ab + k * n * ab + rows * n * out_bytes,
                        rate, op="gemm")

    def attention(self, l: int, dim: int, heads: int) -> SimulationReport:
        """B1's attention kernel (L <= 256): one block per 64 queries of a
        head, all keys in 16-key tiles."""
        b = self.spec.batch_size
        lq, lk = -(-l // 64) * 64, -(-l // 16) * 16
        flops = 4.0 * b * heads * lq * lk * (dim // heads)
        return self._op(flops, _BF16 * b * l * 4 * dim + 4 * b * l,
                        self.spec.attention_rate, op="attention")

    def fused_attention(self, l: int, dim: int, heads: int,
                        f32: bool = False) -> SimulationReport:
        """B4 (`csrc/attention.cu`) as ``attn_impl='fused'`` serves it, at
        its own measured rate, bf16 or (``f32``) f32: qkv read once, the
        output written once."""
        b, s = self.spec.batch_size, self.spec
        size = 4 if f32 else _BF16
        rate = s.fused_attention_rate_f32 if f32 else s.fused_attention_rate
        return self._op(4.0 * b * heads * l * l * (dim // heads),
                        size * b * l * 4 * dim + 4 * b * l, rate,
                        op="fused_attention")

    def block_layer(self, l: int, dim: int, heads: int, mlp_ratio: float,
                    int8: bool = False, ln1: bool = True) -> SimulationReport:
        """One B1 layer on the GEMM core's row epilogues: 6 launches (LN1,
        qkv, attention, proj with LN2 in its epilogue, fc1, fc2); inside a
        B2 segment (``ln1`` off) 5, its LN1 and token gate written by the
        fc2 before it (priced here, as that fc2's extra output). B6: 7
        (LN1 + row quantise, qkv, attention, row quantise, proj with LN2's
        quantiser, fc1 with its row quantiser, fc2). The row passes in the
        epilogues add their outputs' bytes to the product's."""
        s = self.spec
        rows = s.batch_size * l
        hidden = int(dim * mlp_ratio)
        act = 1 if int8 else 2  # bytes of a value the next product reads
        rep = (self.block_gemm(rows, dim, 3 * dim, int8)
               + self.attention(l, dim, heads)
               + self.block_gemm(rows, dim, dim, int8, out_bytes=4 + act)
               + self.block_gemm(rows, dim, hidden, int8, out_bytes=act)
               + self.block_gemm(rows, hidden, dim, int8))
        if ln1:
            rep = rep + self._op(0.0, rows * dim * (2 + act) / s.block_ln_frac,
                                 1.0, op="layernorm")
        else:
            rep = rep + self._op(0.0, rows * dim * 2, 1.0, 0, op="epilogue")
        if int8:
            # the row quantiser of the attention output (bf16 in, s8 out)
            rep = rep + self._op(0.0, rows * dim * 3 / s.block_ln_frac, 1.0,
                                 op="rowquant")
        return rep

    def gate(self, l: int, dim: int, outputs: int = 2) -> SimulationReport:
        """An eval policy head in eager PyTorch on (B, l, D): cast, product,
        compare."""
        b = self.spec.batch_size
        return self.eager(b * l * dim * 6 + b * l * outputs * 8,
                          _GATE_LAUNCHES, op="gate")

    def select(self, l_from: int, l_to: int, dim: int) -> SimulationReport:
        """`gate_and_select`'s rank, stable sort and gathers."""
        b = self.spec.batch_size
        return self.eager(b * l_from * 32 + 2 * b * l_to * dim
                          * _BF16, _SELECT_LAUNCHES, op="select")

    def eager_layer(self, l: int, dim: int, heads: int, mlp_ratio: float,
                    fused_attention: bool,
                    attention_f32: bool = False) -> SimulationReport:
        """One `LAUDViTBlock` eval forward outside the block engine: cuBLAS
        products, the fused attention (B4, its f32 kernel with
        ``attention_f32``) or the reference attention (materialised f32
        scores), and its elementwise passes."""
        s = self.spec
        b = s.batch_size
        rows, hidden = b * l, int(dim * mlp_ratio)
        rep = SimulationReport()
        for k, n in ((dim, 3 * dim), (dim, dim), (dim, hidden),
                     (hidden, dim)):
            rep = rep + self._op(2.0 * rows * k * n, _BF16 * (
                rows * k + k * n + rows * n), s.matmul_rate, op="matmul")
        if fused_attention:
            rep = rep + self.fused_attention(l, dim, heads, attention_f32)
        else:
            scores = b * heads * l * l
            rep = rep + self._op(4.0 * scores * (dim // heads),
                                 scores * 4 * 6, s.matmul_rate, 6,
                                 op="reference_attention")
        # two LayerNorms, masks, gates, residuals, GELU
        passes = (2 * _LN_PASSES + 8) * rows * dim * 4 + 3 * rows * hidden * 2
        return rep + self.eager(passes, _EAGER_LAYER_LAUNCHES - 10,
                                op="eager_layer")

    def predict_vit(self, *, depth: int = 12, dim: int = 384,
                    num_heads: int = 6, mlp_ratio: float = 4.0,
                    input_size: int = 224, patch_size: int = 16,
                    num_classes: int = 1000, mode: str = "dense",
                    token_capacity: Optional[Sequence[float]] = None,
                    fused_attention: bool = False,
                    fused_block: bool = False, int8: bool = False,
                    attention_f32: bool = False) -> SimulationReport:
        """A LAUD-ViT forward as the port serves it; modes as
        `laudnet_tpu/sim/tpu.py::tpu_predict_vit` (``dense``, ``token``
        with ``token_capacity``, ``head``, ``layer``, ``mask``).
        ``fused_block`` prices `build_fused_vit` (B2 segments on selection
        paths, B1 per layer otherwise, B6 with ``int8``) at the fast-math
        kernels' measured rates (P1 puts the exact bodies within a few
        percent of them). ``attention_f32``: the model's graph computes in
        f32, so ``fused_attention`` runs B4's f32 kernel."""
        if int8 and not fused_block:
            raise ValueError("int8 pricing requires fused_block=True "
                             "(the W8A8 path is the block engine)")
        s = self.spec
        b = s.batch_size
        n = (input_size // patch_size) ** 2
        # prologue: cast, cuDNN patch conv, bias, class token, position
        total = self._op(2.0 * b * n * 3 * patch_size ** 2 * dim,
                         b * 3 * input_size ** 2 * 6 + b * n * dim * 2,
                         s.conv_rate, _CONV_LAUNCHES, op="patch_conv")
        total = total + self.eager(4 * b * (n + 1) * dim * _BF16,
                                   5, op="prologue")
        l = n + 1
        caps = list(token_capacity) if token_capacity is not None else None
        run = 0  # layers in the current B2 segment
        for i in range(depth):
            gathered = False
            if mode == "token" and caps is not None:
                k = min(max(2, int(caps[min(i, len(caps) - 1)] * (n + 1))), l)
                if k < l:
                    total = total + self.gate(l, dim) + self.select(l, k, dim)
                    l, gathered = k, True
            if fused_block:
                # B2 segments (`build_fused_vit`) on the bf16 selection
                # paths, one wrapper call each, up to 5 layers and cut at
                # gathers, the token gate in the first layer's LN1 launch
                # where no gather starts one and in the fc2 before it
                # inside; a wrapper call every layer otherwise, and on the
                # W8A8 engine (no segments) an eager gate too
                segmented = mode in ("token", "mask") and not int8
                start = not segmented or gathered or run == 5
                run = 1 if start else run + 1
                if start:
                    total = total + SimulationReport(cfg=[dict(op="call")])
                if mode in ("token", "mask") and not (gathered or segmented):
                    total = total + self.gate(l, dim)
                if mode == "head":
                    total = total + self.gate(1, dim, 2 * num_heads)
                total = total + self.block_layer(
                    l, dim, num_heads, mlp_ratio, int8=int8, ln1=start)
            else:
                if mode in ("token", "mask") and not gathered:
                    total = total + self.gate(l, dim)
                if mode in ("head", "layer"):
                    total = total + self.gate(1, dim, 2 * num_heads)
                total = total + self.eager_layer(l, dim, num_heads, mlp_ratio,
                                                 fused_attention,
                                                 attention_f32)
        # final LayerNorm (plain f32) and the class head
        total = total + self.eager(_LN_PASSES * b * l * dim * 4, _LN_PASSES,
                                   op="final_norm")
        total = total + self._op(2.0 * b * dim * num_classes,
                                 _BF16 * dim * num_classes,
                                 s.matmul_rate, 2, op="head")
        return self.finish(total)

    # --- CNN -----------------------------------------------------------------

    def conv(self, cin: int, cout: int, inh: int, ks: int, stride: int = 1,
             groups: int = 1, rows_frac: float = 1.0) -> SimulationReport:
        """A cuDNN convolution of a (B, inh, inh, cin) map (``rows_frac``
        of its output positions, for patch convolutions)."""
        b = self.spec.batch_size
        outh = inh // stride
        out = b * outh * outh * rows_frac
        flops = 2.0 * out * (cin // groups) * cout * ks * ks
        moved = _BF16 * (b * inh * inh * cin * rows_frac
                                    + out * cout) + 4 * cin * cout * ks * ks
        return self._op(flops, moved, self.spec.conv_rate, _CONV_LAUNCHES,
                        op="conv")

    def passes(self, elems: float, n: int, launches: int,
               op: str = "pass") -> SimulationReport:
        """``n`` read + write passes over ``elems`` values of the compute
        dtype (BatchNorm, ReLU, add, mask multiply)."""
        return self.eager(2.0 * n * elems * _BF16, launches, op)

    def dense_block(self, g: BlockGeom) -> SimulationReport:
        """A dense bottleneck of the model's graph, eager: three
        convolutions (a fourth for the downsample), their BatchNorms, ReLUs
        and the residual add."""
        b = self.spec.batch_size
        inh = g.h * g.stride
        rep = (self.conv(g.cin, g.width, inh, 1)
               + self.conv(g.width, g.width, inh, 3, g.stride, g.groups)
               + self.conv(g.width, g.cout, g.h, 1))
        mid = b * (inh * inh + g.h * g.h) * g.width
        out = b * g.h * g.h * g.cout
        rep = rep + self.passes(2 * mid + 3 * out, 1, 7, op="bn_relu_add")
        if g.has_downsample:
            rep = (rep + self.conv(g.cin, g.cout, inh, 1, g.stride)
                   + self.passes(out, 1, 1, op="bn"))
        return rep

    def static_block(self, g: BlockGeom) -> SimulationReport:
        """A block of the static channel export (`infer/export_pruned.py`),
        what the planner prices its static-export form with: the three
        convolutions at the export's width (a fourth for the downsample)
        and the export's own eager passes, each a launch: ``* a``, ``+ b``
        and the clamp after conv1; ``* a``, ``+ b``, ``+ bias_map`` and the
        clamp after conv2; ``* a``, ``+ b``, the residual add (two inputs)
        and the clamp after conv3; ``* a + b`` after the downsample."""
        b = self.spec.batch_size
        inh = g.h * g.stride
        rep = (self.conv(g.cin, g.width, inh, 1)
               + self.conv(g.width, g.width, inh, 3, g.stride, g.groups)
               + self.conv(g.width, g.cout, g.h, 1))
        mid1 = b * inh * inh * g.width
        mid2 = b * g.h * g.h * g.width
        out = b * g.h * g.h * g.cout
        rep = rep + self.passes(3 * mid1 + 4 * mid2 + 5 * out, 1, 11,
                                op="export_passes")
        if g.has_downsample:
            rep = (rep + self.conv(g.cin, g.cout, inh, 1, g.stride)
                   + self.passes(2 * out, 1, 2, op="export_passes"))
        return rep

    def spatial_masker(self, g: BlockGeom) -> SimulationReport:
        """A block's spatial (or layer) gating head and mask algebra in the
        dense-masked graph: the f32 copy and pool of the block input, the
        mask upsample and dilations, the mask multiply on the conv3 output
        and the FLOPs bookkeeping (`_SPATIAL_MASK_LAUNCHES` launches)."""
        b = self.spec.batch_size
        inh = g.h * g.stride
        in_elems = b * inh * inh * g.cin
        out = b * g.h * g.h * g.cout
        return self.eager(in_elems * 10 + out * 4, _SPATIAL_MASK_LAUNCHES,
                          op="masker")

    def channel_masker(self, g: BlockGeom) -> SimulationReport:
        """A block's channel gating head in the dense-masked graph: the f32
        copy and global pool of the block input, the MLP, the mask
        multiplies on the conv1 and conv2 outputs and the bookkeeping
        (`_CHANNEL_MASK_LAUNCHES` launches)."""
        b = self.spec.batch_size
        inh = g.h * g.stride
        in_elems = b * inh * inh * g.cin
        mid = b * (inh * inh + g.h * g.h) * g.width
        return self.eager(in_elems * 10 + mid * 4, _CHANNEL_MASK_LAUNCHES,
                          op="masker")

    def sparse_block(self, g: BlockGeom, granul: int,
                     capacity: float) -> SimulationReport:
        """`execution='sparse'` on a stride-1 block: the masker, dense conv1,
        select, gather of haloed patches, conv2 and conv3 on the patches,
        scatter-add onto the identity."""
        s = self.spec
        b = s.batch_size
        cells = (g.h // granul) ** 2
        k = max(1, min(cells, math.ceil(capacity * cells)))
        frac = k / cells
        halo = ((granul + 2) / granul) ** 2
        rep = self.spatial_masker(g) + self.conv(g.cin, g.width, g.h, 1)
        rep = rep + self.passes(b * g.h * g.h * g.width, 1, 2, op="bn_relu")
        x1 = b * g.h * g.h * g.width * _BF16
        out = b * g.h * g.h * g.cout * _BF16
        index = (x1 * (1 + 2 * halo * frac)        # gather
                 + 3 * out + out * frac)           # scatter-add, identity
        rep = rep + self._op(0.0, index / s.index_bw_frac, 1.0,
                             _SPARSE_LAUNCHES, op="gather_scatter")
        patch_in = frac * halo
        rep = (rep + self.conv(g.width, g.width, g.h, 3, rows_frac=patch_in)
               + self.conv(g.width, g.cout, g.h, 1, rows_frac=frac))
        return rep + self.passes(b * g.h * g.h * frac * (g.width + g.cout),
                                 1, 3, op="bn_relu")

    def b3_block(self, g: BlockGeom, granul: int,
                 capacity: float) -> SimulationReport:
        """B3 on a stride-1 block (rank-only): the masker, dense conv1, and
        the tail on the selected patches at B3's own measured rate
        (``b3_rate``) and bytes."""
        s = self.spec
        b = s.batch_size
        cells = (g.h // granul) ** 2
        rows = b * g.h * g.h * min(1.0, max(1, math.ceil(
            capacity * cells)) / cells)
        flops = 2.0 * rows * g.width * (9 * g.width + g.cout)
        moved = _BF16 * (b * g.h * g.h * (g.width + 2 * g.cout))
        rep = self.spatial_masker(g) + self.conv(g.cin, g.width, g.h, 1)
        return rep + self._op(flops, moved, s.b3_rate, _B3_LAUNCHES,
                              op="b3")

    def predict_network(self, model: str, mode: str | Sequence[str] = "static",
                        act_rates: Optional[Sequence[float]] = None,
                        granularity: Optional[Sequence[int]] = None
                        ) -> SimulationReport:
        """A LAUD-ResNet forward as the port runs it; modes as
        `laudnet_tpu/sim/tpu.py::tpu_predict_network`: ``static`` (the
        dense ResNet), ``channel``, ``spatial_masked`` and ``both_masked``
        (the dense-masked graph with the paradigm's maskers), ``spatial``
        (sparse execution at capacity ``act_rates``), ``pallas`` (B3),
        ``layer`` (dense-masked with a spatial masker of one cell; at
        batch 1 layer skip: the gate, one host read and ``act_rate`` of
        the body)."""
        s = self.spec
        b = s.batch_size
        blocks = MODEL_GEOMETRY[model]
        n = len(blocks)
        act_rates = list(act_rates) if act_rates is not None else [1.0] * n
        granularity = (list(granularity) if granularity is not None
                       else [4] * n)
        modes = [mode] * n if isinstance(mode, str) else list(mode)
        if len(modes) != n:
            raise ValueError(
                f"per-block mode list has {len(modes)} entries, model has {n}")
        # stem: 7x7 conv, BatchNorm, ReLU, max-pool
        total = self.conv(3, 64, 224, 7, 2) + self.passes(
            b * 112 * 112 * 64, 2, 3, op="stem")
        syncs = 0
        for g, rate, gran, m in zip(blocks, act_rates, granularity, modes):
            gran = min(gran, g.h)
            if m == "static":
                total = total + self.dense_block(g)
            elif m == "channel":
                total = total + self.dense_block(g) + self.channel_masker(g)
            elif m == "spatial_masked":
                total = total + self.dense_block(g) + self.spatial_masker(g)
            elif m == "both_masked":
                total = (total + self.dense_block(g) + self.spatial_masker(g)
                         + self.channel_masker(g))
            elif m == "spatial":
                if g.stride == 1:
                    total = total + self.sparse_block(g, gran, rate)
                else:
                    total = (total + self.dense_block(g)
                             + self.spatial_masker(g))
            elif m == "pallas":
                if g.stride == 1:
                    total = total + self.b3_block(g, gran, rate)
                else:
                    total = (total + self.dense_block(g)
                             + self.spatial_masker(g))
            elif m == "layer":
                if b == 1:
                    syncs += 1
                    body = self.dense_block(g)
                    runs = body.scaled(rate)
                    runs.cfg = body.cfg[:round(len(body.cfg) * rate)]
                    total = total + self.eager(
                        b * (g.h * g.stride) ** 2 * g.cin * 6, 8,
                        op="layer_gate") + runs
                else:
                    total = (total + self.dense_block(g)
                             + self.spatial_masker(g))
            else:
                raise ValueError(m)
        total = total + self.eager(b * 7 * 7 * 2048 * 2, 2, op="pool")
        total = total + self._op(2.0 * b * 2048 * 1000, 2 * 2048 * 1000 * 2,
                                 s.matmul_rate, 2, op="fc")
        return self.finish(total, syncs)
