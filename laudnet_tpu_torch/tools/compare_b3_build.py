"""B3, the masked bottleneck tail, of this checkout against another build
of ``csrc/masked_block.cu`` (an earlier commit's), in one process on one
card.

    mkdir -p _smoke_checkout/parent
    git archive <commit> laudnet_tpu_torch/csrc | tar -x -C _smoke_checkout/parent
    python -m laudnet_tpu_torch.tools.compare_b3_build \\
        _smoke_checkout/parent/laudnet_tpu_torch/csrc

(``_smoke_checkout/`` is git-ignored.) Builds DIR's ``masked_block.cu``
alone into a library of its own (under ``csrc/_build/``, cached by the hash
of DIR's sources) and calls its ``lt_masked_tail`` through the interface of
the three-launch form: the selection as PyTorch operations (compare,
cumsum, a stable sort of the flags), the weights repacked K-major on every
call, then the kernel's three launches. This build runs
`ops/masked_block.py::masked_bottleneck_tail` (two launches).

At the five shapes of ``chip_smoke.py``'s B3 phase (the JAX bench's and
the flagship's four stride-1 blocks at batch 128), each at two capacities:
both builds are held to the plain version within ULPS bf16 ulps of its
largest output, with the cells they do not select equal to relu(identity)
bit for bit, and the share of outputs where the two builds differ is
printed. Then both are timed in turns (other, this, this, other): single
calls (the host's work included, as a caller meets it) and chains of ten
calls between CUDA events (the host's work hidden under the previous
call's device time), and their kernels' device time and launches per call
(`torch.profiler`). Anything outside its bound raises. Card only.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import statistics
import sys
from pathlib import Path

import torch

from laudnet_tpu_torch.ops import _build, masked_block
from laudnet_tpu_torch.tools.timing import chain_times

ULPS = 4  # chip_smoke.py's bound of a kernel against its plain version
NAMES = ("x1", "identity", "mask_cells", "w2", "a2", "b2", "w3", "a3", "b3")
# name, B, H = W, C, Co, patch, mask density (None: capacity / cells),
# capacities: the JAX bench's shape and the flagship's four stride-1
# blocks at batch 128 (chip_smoke.py's B3 phase runs these too)
SHAPES = (
    ("bench", 16, 28, 1024, 2048, 7, None, (8, 4)),
    ("stage1", 128, 56, 64, 256, 4, 0.5, (196, 98)),
    ("stage2", 128, 28, 128, 512, 4, 0.5, (49, 25)),
    ("stage3", 128, 14, 256, 1024, 2, 0.5, (49, 25)),
    ("stage4", 128, 7, 512, 2048, 1, 0.5, (49, 25)),
)
# the three-launch form's C interface: x1, identity, slots, n_valid,
# selected, w2t, a2, b2, w3t, a3, b3, mid, out, b, h, w, c, co, patch,
# max_slots, stream
_OTHER_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]


def other_library(src_dir: Path):
    """DIR's masked_block.cu (with DIR's headers) built alone and its
    ``lt_masked_tail`` bound."""
    src = src_dir / "masked_block.cu"
    if not src.exists():
        raise FileNotFoundError(f"no masked_block.cu in {src_dir}")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for s in [src] + sorted(src_dir.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _build.BUILD_DIR / f"other_tail_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.compile_library([src], out)
    lib = ctypes.CDLL(str(out))
    lib.lt_masked_tail.argtypes = _OTHER_ARGTYPES
    lib.lt_masked_tail.restype = ctypes.c_int
    return lib


def other_tail(lib, t, patch, capacity):
    """The three-launch form, as its wrapper called it."""
    x1, identity, mask_cells, w2, a2, b2, w3, a3, b3 = (t[k] for k in NAMES)
    b, hh, ww, c = x1.shape
    co = identity.shape[-1]
    n_cells = mask_cells.shape[1] * mask_cells.shape[2]
    active = mask_cells.reshape(b, n_cells) > 0.5
    selected = active & (active.cumsum(dim=1) <= capacity)
    flags = selected.reshape(-1).to(torch.uint8)
    n_valid = flags.sum(dtype=torch.int32).reshape(1)
    max_slots = b * capacity
    slots = torch.sort(flags, descending=True, stable=True).indices[
        :max_slots].to(torch.int32)
    w2t = w2.permute(3, 0, 1, 2).reshape(c, 9 * c).contiguous()
    w3t = w3.t().contiguous()
    f32 = lambda v: v.float().contiguous()
    a2, b2, a3, b3 = f32(a2), f32(b2), f32(a3), f32(b3)
    mid = torch.empty((max_slots * patch * patch, c), dtype=torch.bfloat16,
                      device=x1.device)
    out = torch.empty_like(identity)
    _build.check(_build.library(), lib.lt_masked_tail(
        x1.data_ptr(), identity.data_ptr(), slots.data_ptr(),
        n_valid.data_ptr(), flags.data_ptr(), w2t.data_ptr(), a2.data_ptr(),
        b2.data_ptr(), w3t.data_ptr(), a3.data_ptr(), b3.data_ptr(),
        mid.data_ptr(), out.data_ptr(), b, hh, ww, c, co, patch, max_slots,
        torch.cuda.current_stream(x1.device).cuda_stream),
        "the other build's bottleneck-tail kernel")
    return out


def inputs(g, dev, b, hw, c, co, patch, density):
    """Random bf16 tensors of one bottleneck tail: post-ReLU x1, He-scaled
    weights, BatchNorm affines near identity, a 0/1 cell mask."""
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    bf = lambda v: v.to(dev, torch.bfloat16)
    hm = hw // patch
    return dict(
        x1=bf(rn(b, hw, hw, c).relu()), identity=bf(rn(b, hw, hw, co)),
        mask_cells=(torch.rand(b, hm, hm, generator=g) < density).float().to(
            dev),
        w2=bf(rn(3, 3, c, c, scale=math.sqrt(2.0 / (9 * c)))),
        a2=(1.0 + rn(c, scale=0.1)).to(dev), b2=rn(c, scale=0.1).to(dev),
        w3=bf(rn(c, co, scale=math.sqrt(2.0 / c))),
        a3=(1.0 + rn(co, scale=0.1)).to(dev), b3=rn(co, scale=0.1).to(dev))


def ulp_tol(ref):
    top = ref.float().abs().max().item()
    return ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def in_turns(this, other, chain, rounds=3, reps=10):
    """Medians of each side's readings over rounds of other, this, this,
    other; a reading is the median of ``reps`` chains of ``chain`` calls."""
    mine, theirs = [], []
    for _ in range(rounds):
        for side, f in ((theirs, other), (mine, this), (mine, this),
                        (theirs, other)):
            side.append(statistics.median(chain_times(f, chain, reps, 2)))
    return statistics.median(mine), statistics.median(theirs)


def device(fn, calls=3):
    """Device ms per call of ``fn``, summed over its kernels, kernels per
    call, and ms per call of each kernel by name (`torch.profiler`). The
    profiler can drop events (no device activity, or a count that is not a
    multiple of the calls): such a trace is taken again after a pause, and
    if none comes back whole, all three are None (not measured)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        count = sum(e.count for e in events)
        if count and count % calls == 0:
            by_name = {}
            for e in events:
                key = e.key.replace("(anonymous namespace)::", "")[:48]
                by_name[key] = (by_name.get(key, 0.0)
                                + e.device_time_total / calls / 1e3)
            return sum(by_name.values()), count // calls, by_name
        time.sleep(0.1 * (attempt + 1))
    return None, None, None


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def run(src_dir, device_name="cuda"):
    dev = torch.device(device_name)
    if dev.type != "cuda":
        raise ValueError("the comparison runs B3's kernels on a card")
    lib = other_library(Path(src_dir))
    g = torch.Generator().manual_seed(3)
    results, bad = [], []
    for name, b, hw, c, co, patch, density, caps in SHAPES:
        n_cells = (hw // patch) ** 2
        for capacity in caps:
            dens = density if density else capacity / n_cells
            t = inputs(g, dev, b, hw, c, co, patch, dens)
            this = lambda: masked_block.masked_bottleneck_tail(
                **t, patch=patch, capacity=capacity)
            other = lambda: other_tail(lib, t, patch, capacity)
            mine, theirs = this(), other()
            ref = masked_block.reference_masked_bottleneck_tail(
                **t, patch=patch, capacity=capacity)
            torch.cuda.synchronize()
            tol = ulp_tol(ref)
            err = [(o.float() - ref.float()).abs().max().item()
                   for o in (mine, theirs)]
            active = t["mask_cells"].reshape(b, -1) > 0.5
            chosen = (active & (active.cumsum(1) <= capacity)).reshape(
                t["mask_cells"].shape)
            pix = chosen.repeat_interleave(patch, 1).repeat_interleave(
                patch, 2)
            rest = torch.relu(t["identity"])[~pix]
            rest_equal = [torch.equal(o[~pix], rest) for o in (mine, theirs)]
            differ = (mine != theirs).float().mean().item()
            single = in_turns(this, other, 1)
            chained = in_turns(this, other, 10)
            dev_this, dev_other = device(this), device(other)
            kernels = ", ".join(f"{k} {v:.4f}"
                                for k, v in (dev_this[2] or {}).items())
            tag = (f"{name} B={b} {hw}x{hw} {c}->{co} patch {patch} "
                   f"capacity {capacity}")
            row = dict(case=tag, err_this=err[0], err_other=err[1], tol=tol,
                       share_differing=differ,
                       single_ms_this_other=single,
                       chain_ms_this_other=chained,
                       device_ms_this_other=(dev_this[0], dev_other[0]),
                       launches_this_other=(dev_this[1], dev_other[1]))
            results.append(row)
            print(f"{tag}: max_abs_err this {err[0]:.6g}, other "
                  f"{err[1]:.6g} (tol {tol:.6g}), unselected equal "
                  f"{rest_equal}, outputs differing {differ:.6g}; single "
                  f"calls this {single[0]:.4f} ms, other {single[1]:.4f} "
                  f"({single[1] / single[0]:.3f}x); chains this "
                  f"{chained[0]:.4f}, other {chained[1]:.4f} "
                  f"({chained[1] / chained[0]:.3f}x); device this "
                  f"{_ms(dev_this[0])} in {dev_this[1]} kernels, other "
                  f"{_ms(dev_other[0])} in {dev_other[1]} (this: "
                  f"{kernels})", flush=True)
            if not (max(err) <= tol and all(rest_equal)):
                bad.append(tag)
            del t, mine, theirs, ref
    print(json.dumps({"b3_this_other": results}))
    if bad:
        raise AssertionError(f"outside the bound: {bad}")
    return results


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m laudnet_tpu_torch.tools."
                         "compare_b3_build DIR_WITH_masked_block.cu")
    run(sys.argv[1])
