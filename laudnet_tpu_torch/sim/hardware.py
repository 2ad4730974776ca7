"""Hardware specifications for the latency models.

`HopperSpec` is the H100 for the serving planner's model (`sim/h100.py`):
the card's published peaks (NVIDIA's H100 SXM data sheet, dense rates at
the 700 W limit) and the rates the port's own execution forms reach on it,
each pinned from a run of a committed probe on an H100.

`DeviceSpec` and its five `GPU_PRESETS` (V100, RTX3090, RTX3060, Jetson TX2,
Jetson Nano: the reference simulator's published targets) are the GPU
roofline simulator's (`sim/roofline.py`, `sim/dynamic.py`, `sim/cli.py`),
copied from `laudnet_tpu/sim/hardware.py:15-71`, which the port does not
import. The JAX package's `TPUSpec` and `TPU_PRESETS` model TPU engines
and are not copied.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DeviceSpec:
    """A multi-core SIMT-style device (GPU) for the roofline model."""

    name: str
    n_cores: int  # streaming multiprocessors
    lanes: int  # fp32 lanes per core
    frequency: float  # Hz
    mem_bandwidth: float  # bytes/s
    cache_speed_frac: float = 4.0  # L2 bandwidth as multiple of HBM
    issue_cycles: float = 4.0  # pipeline slots per lane (fp32_cycles)
    mem_concurrent: float = 8.0  # fp32 words per coalesced sector
    memory_efficiency: float = 0.9
    launch_time: float = 8e-6  # per-kernel launch overhead, seconds
    latency_mode: str = "add"  # 'add' | 'max' of compute/memory
    batch_size: int = 1

    @property
    def mem_fp32_bandwidth(self) -> float:
        return self.mem_bandwidth / 4.0

    @property
    def cache_fp32_bandwidth(self) -> float:
        return self.mem_fp32_bandwidth * self.cache_speed_frac

    @property
    def peak_parallelism(self) -> float:
        return self.lanes * self.issue_cycles

    def with_batch(self, batch_size: int) -> "DeviceSpec":
        return replace(self, batch_size=batch_size)


# The reference simulator's GPU targets (`eval_example.py:135-156`).
GPU_PRESETS = {
    "v100": DeviceSpec(
        "v100", n_cores=80, lanes=64, frequency=1.5e9,
        mem_bandwidth=700e9, batch_size=128,
    ),
    "rtx3090": DeviceSpec(
        "rtx3090", n_cores=82, lanes=128, frequency=1.25e9,
        mem_bandwidth=936e9, cache_speed_frac=1.0, batch_size=128,
    ),
    "rtx3060": DeviceSpec(
        "rtx3060", n_cores=28, lanes=128, frequency=1.777e9,
        mem_bandwidth=360e9, batch_size=128,
    ),
    "tx2": DeviceSpec(
        "tx2", n_cores=2, lanes=128, frequency=1.3e9,
        mem_bandwidth=59.7e9, batch_size=1,
    ),
    "nano": DeviceSpec(
        "nano", n_cores=1, lanes=128, frequency=921e6,
        mem_bandwidth=25.6e9, batch_size=1,
    ),
}


@dataclass(frozen=True)
class HopperSpec:
    """An NVIDIA Hopper card and the port's measured rates on it.

    Published: ``n_sms``, ``peak_bf16`` / ``peak_int8`` (tensor cores,
    dense), ``mem_bandwidth`` (HBM3), ``l2_bytes``, ``smem_per_block``.
    Measured (rates in FLOP/s or bytes/s of the logical work):

    * ``block_gemm_frac``: B1's bf16 GEMMs (the wgmma + TMA core,
      ``csrc/gemm_sm90.cuh``) as a fraction of ``peak_bf16``; ``attention_rate``: B1's attention kernel;
      ``fused_attention_rate`` / ``fused_attention_rate_f32``: B4, the
      attention forward of ``attn_impl='fused'`` (`csrc/attention.cu`), in
      bf16 / f32, at DeiT-S L = 197, batch 128, with the head mask
      (`chip_smoke.py`, the kernel checks); ``b3_rate``: B3, the masked
      bottleneck tail (`csrc/masked_block.cu`), over its two products'
      operations at the JAX bench's shape (`chip_smoke.py`, the device time
      of its kernels);
      ``block_ln_frac``: B1's LayerNorm kernel as a fraction of
      ``mem_bandwidth`` (`tools/probe_block_budget.py --stages`, P1);
    * ``block_s8_gemm_frac``: B6's s8 GEMMs at the block's K (same probe),
      ``s8_gemm_frac``: P2's s8 GEMM at n = 4096 (the same core's s8
      form), both of ``peak_int8`` (`tools/probe_int8.py`);
    * ``matmul_rate``: cuBLAS's bf16 product (``torch.matmul``, 8192^3);
      ``conv_rate``: cuDNN's bf16 convolutions, channels-last, over
      ResNet-50's 53 at batch 128; ``qconv_rate``: `QuantConv` over the
      same (weight and activation quantisation, unfold, ``torch._int_mm``,
      dequantisation: what ``conv_impl='int8'`` runs); ``int_conv_rate``:
      the static int8 export's convolution over the same
      (`tools/probe_int8.py`);
    * ``eager_bw_frac``: an eager elementwise PyTorch pass, and
      ``index_bw_frac``: the gather and scatter-add of patches
      (`ops/sparse.py`), as fractions of ``mem_bandwidth``;
      ``host_launch`` / ``host_call``: host seconds per kernel launch of
      the block engine's wrappers (allocation, ctypes) and per call of one
      (input checks, masks); ``eager_host_launch``: host
      seconds per operation of the eager model graph (the flagship's eval
      forward at batch 128, over the operations it dispatches);
      ``device_launch``: the device's time between two
      back-to-back launches; ``host_sync``: one read of a device scalar to
      the host (`tools/probe_host.py`).
    """

    name: str
    block_gemm_frac: float
    attention_rate: float
    fused_attention_rate: float
    fused_attention_rate_f32: float
    b3_rate: float
    block_ln_frac: float
    block_s8_gemm_frac: float
    s8_gemm_frac: float
    matmul_rate: float
    conv_rate: float
    qconv_rate: float
    int_conv_rate: float
    eager_bw_frac: float
    index_bw_frac: float
    host_launch: float
    host_call: float
    eager_host_launch: float
    device_launch: float
    host_sync: float
    n_sms: int = 132
    peak_bf16: float = 989e12
    peak_int8: float = 1979e12
    mem_bandwidth: float = 3.35e12
    l2_bytes: float = 50e6
    smem_per_block: int = 227 * 1024
    batch_size: int = 128

    def with_batch(self, batch_size: int) -> "HopperSpec":
        return replace(self, batch_size=batch_size)


HOPPER_PRESETS = {
    # Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
    # (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader) after
    # the row epilogues moved LN2, a segment's next LN1 and token gate and
    # B6's row quantisers into the GEMM core's epilogues. One run of
    # `python3 chip_smoke.py probes`: probe_block_budget --stages, B1's
    # four bf16 products 310.04 TFLOP/s (proj with LN2 in its epilogue),
    # B6's four s8 products 219.02 TOP/s (proj with LN2's quantiser, fc1
    # with its row quantiser: the f32 GELU output is no longer stored), B1's
    # attention launch 95.22 TFLOP/s on its padded 64 x 16 tiles
    # (attention.cu's forward at L = 197 since the split of lt_attention),
    # its one LayerNorm launch 1,590.82 GB/s; probe_int8, P2 1,250.66 TOP/s
    # at n = 4096, torch.matmul 792.40 TFLOP/s, over ResNet-50's
    # convolutions at bs128 cuDNN bf16 273.75 TFLOP/s, QuantConv 11.86, the
    # export's 13.45. Two runs of `python -m
    # laudnet_tpu_torch.tools.probe_host` in one later call, their mean:
    # 18.47 / 16.25 us per launch of the block wrappers and 30.56 / 89.42
    # per call (each the least of five tries: one try gave a negative cost
    # per call), the eager graph 18.96 / 25.67 us of host an operation,
    # device gap 1.955 / 1.963 us, host read 14.81 / 13.84 us, eager pass
    # 0.8866 / 0.8810 and gather/scatter 0.1184 / 0.1200 of 3.35 TB/s.
    "h100": HopperSpec(
        "h100",
        block_gemm_frac=310.04 / 989,
        attention_rate=95.22e12,
        # B4 at DeiT-S L = 197, batch 128, head mask: 4 * 128 * 6 * 197^2 *
        # 64 FLOP in 0.1228 ms (bf16) and 0.8384 ms (f32), both from one
        # run of `python3 chip_smoke.py kernels` on the same card (chains
        # of ten calls, in turns with PyTorch's attention)
        fused_attention_rate=7.630159872e9 / 0.1228e-3,
        fused_attention_rate_f32=7.630159872e9 / 0.8384e-3,
        # B3 at the JAX bench's shape (B = 16, 28^2, 1024 -> 2048, patch 7,
        # capacity 8: 5,096 rows, 117.56 GFLOP) in 0.4262 ms of device time
        # (its two kernels, torch.profiler), one run of `python3
        # chip_smoke.py` on the same card
        b3_rate=117.558652928e9 / 0.4262e-3,
        block_ln_frac=1590.82 / 3350,
        block_s8_gemm_frac=219.02 / 1979,
        s8_gemm_frac=1250.66 / 1979,
        matmul_rate=792.40e12,
        conv_rate=273.75e12,
        qconv_rate=11.86e12,
        int_conv_rate=13.45e12,
        eager_bw_frac=(0.8866 + 0.8810) / 2,
        index_bw_frac=(0.1184 + 0.1200) / 2,
        host_launch=(18.47 + 16.25) / 2 * 1e-6,
        host_call=(30.56 + 89.42) / 2 * 1e-6,
        eager_host_launch=(18.96 + 25.67) / 2 * 1e-6,
        device_launch=(1.955 + 1.963) / 2 * 1e-6,
        host_sync=(14.81 + 13.84) / 2 * 1e-6,
    ),
}
