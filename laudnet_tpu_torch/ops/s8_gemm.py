"""s8 x s8 -> s32 GEMM (P2): exact integer products of int8 codes.

Counterpart of the TPU probe kernel `tools/probe_int8.py::rate_pallas_s8`,
hand-written for the H100 in ``csrc/probe_int8.cu``: the s8 form of the
port's GEMM core (``csrc/gemm_sm90.cuh``, TMA and wgmma, the core of the
W8A8 block's products) with a raw int32 store. The probe
(`laudnet_tpu_torch/tools/probe_int8.py`) rates it beside the library's
s8 product; the latency model (`sim/h100.py`) reads that rate.

`s8_gemm` takes the plain PyTorch version only for tensors on the CPU;
CUDA tensors launch the kernel or raise. ``s8_gemm.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch


def s8_gemm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 codes as int32, on any device. Exact: f64 holds
    every partial sum (|sum| <= 127^2 * K < 2^53)."""
    return (a.double() @ b.double()).to(torch.int32)


def s8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (M, K) and ``b`` (K, N) int8 -> (M, N) int32, the exact
    product. On CUDA ``a`` must be row-major and ``b`` column-major (the
    transpose of a contiguous (N, K) tensor, the layout the tensor cores
    and `torch._int_mm` take), with K % 16 == 0."""
    if a.device.type == "cpu":
        return s8_gemm_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    from laudnet_tpu_torch.ops._build import check, library

    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"s8_gemm takes int8, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not a.is_contiguous() or not b.t().is_contiguous():
        raise ValueError("a must be row-major and b column-major "
                         "(b = w.t() of a contiguous (N, K) w)")
    m, k = a.shape
    n = b.shape[1]
    if k % 16:
        raise ValueError(f"the kernel needs K % 16 == 0, got K={k}")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    lib = library()
    check(lib, lib.lt_s8_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                              k, torch.cuda.current_stream(a.device).cuda_stream),
          "s8 gemm kernel")
    s8_gemm.launches += 1
    return out


s8_gemm.launches = 0
