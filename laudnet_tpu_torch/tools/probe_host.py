"""The host's and the card's cost per launch, and the bandwidth of the
eager passes the port's CNN and gate paths are made of.

    python -m laudnet_tpu_torch.tools.probe_host

Prints, from one run on the card (the `sim/hardware.py::HopperSpec` terms
of the same names):

* ``host_launch_us`` and ``host_call_us``: host microseconds per kernel
  launch of the block engine's wrappers (allocation, ctypes) and per call
  of one (input checks, masks): a `fused_vit_block` call (6 launches) and
  a five-layer `fused_vit_segment` call (26) at DeiT-S bs128 on the host
  clock, issued while the card works through a spinning kernel queued
  first (so the host never waits on it), the line through the two;
* ``op_dispatch_us``: host microseconds the registered op
  (``laudnet::vit_block``, `torch.library`) adds to a `fused_vit_block`
  call: the wrapper against the op's CUDA implementation called
  directly, on the same layer, the same way;
* ``device_launch_us``: the card's microseconds per kernel in a chain of
  back-to-back tiny kernels (CUDA events), queued behind a spinning kernel
  (``torch.cuda._sleep``) so that the host is ahead: the gap a launch adds
  on the device, not the host's issue rate;
* ``eager_host_launch_us``: host microseconds per operation of the
  port's eager model graph: the flagship LAUD-ResNet-50's dense-masked
  eval forward (bf16) at batch 128, the host clock from the call to its
  return (the forward is host-bound: the card finishes right behind it)
  over the operations it dispatches that are not views (what
  `sim/h100.py` counts as its launches; `tests/test_torch_sim.py` holds
  the count to the model's), median of 10 forwards;
* ``host_sync_us``: one read of a device scalar to the host (``.item()``)
  after a tiny kernel;
* ``tma_encode_us``: host microseconds to encode one TMA descriptor
  (``cuTensorMapEncodeTiled`` through ``lt_tma_encode``, a DeiT-S bs128
  activation): each launch of the GEMM core (``csrc/gemm_sm90.cuh``)
  encodes two, 48 launches a DeiT-S forward;
* ``eager_bw_frac``: an eager bf16 elementwise pass (``torch.relu`` of
  128 x 56 x 56 x 256, the flagship's stage-1 output) as a fraction of
  the card's 3.35 TB/s;
* ``index_bw_frac``: sparse execution's gather of haloed patches and
  scatter-add (`ops/sparse.py`, stage-1 shapes, capacity 1.0), bytes
  moved over the time, as a fraction of the same.
"""

from __future__ import annotations

import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from laudnet_tpu_torch.ops import sparse
from laudnet_tpu_torch.tools.timing import chain_ms

HBM = 3.35e12


def _queued_gap_s(tiny, n):
    """Device seconds per launch of ``n`` tiny kernels queued while the
    card spins, so it runs them back to back."""
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~30 ms: longer than issuing n
        start.record()
        for _ in range(n):
            tiny.add_(1.0)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3 / n)
    return best


class Dispatched(TorchDispatchMode):
    """Counts the operations that reach a kernel: not views, not empty
    allocations."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.overloadpacket.__name__ not in (
                "empty", "empty_strided", "lift_fresh"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _eager_host_launch_s(dev, batch=128, forwards=10):
    """Host seconds per operation of the flagship's eval forward at
    ``batch``: the call's own time on the host clock, the card drained
    before it."""
    from laudnet_tpu_torch.entry import flagship

    model = flagship(dev, compute_dtype=torch.bfloat16).eval()
    x = torch.randn(batch, 224, 224, 3, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        for _ in range(3):
            model(x, 0.1)
        with Dispatched() as counted:
            model(x, 0.1)
        times = []
        for _ in range(forwards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x, 0.1)
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2] / counted.n


def wrapper_host_s(dev, calls=10):
    """Host seconds of the block engine's wrappers at DeiT-S bs128 (L =
    197), issued behind ``torch.cuda._sleep`` so the host never waits on
    the card: a call of `fused_vit_block` (one layer, 6 launches) and of
    `fused_vit_segment` (five layers, 26 launches), fitted as a cost per
    call (checks, masks) plus a cost per launch (allocation, ctypes); and
    the same `fused_vit_block` call made on the op's CUDA implementation
    directly, without the dispatcher. Returns (per call, per launch, the
    op's dispatch per call)."""
    from laudnet_tpu_torch.ops import vit_block

    g = torch.Generator(dev).manual_seed(2)
    b, l, d, hidden = 128, 197, 384, 1536

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.05).to(
            torch.bfloat16)

    p = {"ln1": {"weight": w(d), "bias": w(d)},
         "ln2": {"weight": w(d), "bias": w(d)},
         "qkv": {"weight": w(3 * d, d), "bias": w(3 * d)},
         "proj": {"weight": w(d, d), "bias": w(d)},
         "fc1": {"weight": w(hidden, d), "bias": w(hidden)},
         "fc2": {"weight": w(d, hidden), "bias": w(d)}}
    x = w(b, l, d)
    ones = torch.ones(b, l, device=dev)
    km, rm = ones.reshape(b, 1, l), ones.reshape(b, l, 1)

    def host(call, repeats=5):
        # the least of a few tries: the host is shared, and a slow spell
        # in one of the two readings would skew the fit (it gave a
        # negative cost per call)
        call()
        best = float("inf")
        for _ in range(repeats):
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)  # ~120 ms: outlasts the enqueueing
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
        return best

    one = host(lambda: vit_block.fused_vit_block(x, km, rm, p, num_heads=6,
                                                 fast_math=True))
    five = host(lambda: vit_block.fused_vit_segment(x, ones, [p] * 5,
                                                    num_heads=6,
                                                    fast_math=True))
    flat = vit_block.flatten_layer(p)
    direct = host(lambda: vit_block._vit_block_cuda(x, km, rm, flat, 6, None,
                                                    1e-6, True))
    per_launch = (five - one) / (26 - 6)
    return one - 6 * per_launch, per_launch, one - direct


def run(device="cuda") -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the probe measures a CUDA card")
    g = torch.Generator(dev).manual_seed(0)
    tiny = torch.zeros(16, device=dev)
    call, host, dispatch = wrapper_host_s(dev)
    device_gap = _queued_gap_s(tiny, 500)
    syncs = []
    for _ in range(50):
        tiny.add_(1.0)
        t0 = time.perf_counter()
        tiny[0].item()
        syncs.append(time.perf_counter() - t0)
    syncs.sort()

    from laudnet_tpu_torch.ops._build import check, library

    lib = library()
    act = torch.empty(128 * 197, 384, dtype=torch.bfloat16, device=dev)
    reps = 10000
    check(lib, lib.lt_tma_encode(act.data_ptr(), act.shape[0], 384, 100),
          "descriptor encode")
    t0 = time.perf_counter()
    check(lib, lib.lt_tma_encode(act.data_ptr(), act.shape[0], 384, reps),
          "descriptor encode")
    encode = (time.perf_counter() - t0) / reps

    x = torch.randn(128, 56, 56, 256, device=dev, generator=g).to(
        torch.bfloat16)
    relu_ms = chain_ms(lambda: torch.relu(x), chain=20)
    eager = 2 * x.numel() * 2 / (relu_ms * 1e-3) / HBM

    b, hw, c, co, patch = 128, 56, 64, 256, 4
    x1 = torch.randn(b, hw, hw, c, device=dev, generator=g).to(torch.bfloat16)
    ident = torch.randn(b, hw, hw, co, device=dev, generator=g).to(
        torch.bfloat16)
    cells = torch.ones(b, hw // patch, hw // patch, device=dev)
    k = cells[0].numel()
    idx, valid = sparse.select_patches(cells, k)
    patches = torch.randn(b, k, patch, patch, co, device=dev,
                          generator=g).to(torch.bfloat16)

    def gather_scatter():
        sparse.gather_patches(x1, idx, patch, halo=1)
        sparse.scatter_patches_add(ident, patches, idx, valid, patch)

    gs_ms = chain_ms(gather_scatter, chain=10)
    halo = ((patch + 2) / patch) ** 2
    moved = (x1.numel() * (1 + halo) + ident.numel() * 2
             + patches.numel()) * 2
    out = {"host_launch_us": host * 1e6, "host_call_us": call * 1e6,
           "op_dispatch_us": dispatch * 1e6,
           "device_launch_us": device_gap * 1e6,
           "eager_host_launch_us": _eager_host_launch_s(dev) * 1e6,
           "host_sync_us": syncs[len(syncs) // 2] * 1e6,
           "tma_encode_us": encode * 1e6,
           "eager_bw_frac": eager,
           "index_bw_frac": moved / (gs_ms * 1e-3) / HBM}
    for key, v in out.items():
        print(f"{key:>18}: {v:.4f}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
