"""B1's production launches through this checkout's kernels against the
same launches through another build of ``csrc/vit_block.cu``, bit for bit.

    mkdir -p csrc_other
    git show <commit>:laudnet_tpu_torch/csrc/vit_block.cu > csrc_other/vit_block.cu
    git show <commit>:laudnet_tpu_torch/csrc/mma_common.cuh > csrc_other/mma_common.cuh
    python -m laudnet_tpu_torch.tools.compare_b1_build csrc_other

Builds ``DIR/vit_block.cu`` alone into a library of its own (under
``csrc/_build/``), then runs B1's seven launches
(`ops/vit_block.py::_layer_cuda`) with the exact and the fast-math body
through both libraries on the same inputs: DeiT-S at L = 197 with a ragged
key mask and a head gate, a segment layer at L = 98 with its token gate
fused into LN1 (B2's launch), and T2T-ViT-19's widths (D = 448, hidden
1344). Each output, and the token mask the gated layer writes, must be
equal bit for bit; anything else raises. The other source must take the
C arguments this one takes, with 0 / 1 in the body argument of
``lt_layernorm``, ``lt_gemm`` and ``lt_attention`` for the exact /
fast-math body, as every version of the file has.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import torch

from laudnet_tpu_torch.ops import _build, vit_block

_ENTRY_POINTS = ("lt_layernorm", "lt_gemm", "lt_attention")


def other_library(src_dir: Path):
    """``src_dir/vit_block.cu`` built alone (cached by the hash of the
    directory's sources) and bound."""
    srcs = sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _build.BUILD_DIR / f"other_vit_block_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.compile_library([src_dir / "vit_block.cu"], out)
    return _build.load(out, _ENTRY_POINTS)


def _layer(g, d, hidden, dev, policy=False):
    def w(*shape, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to(
            dev, torch.bfloat16)

    p = {"ln1": {"weight": 1 + w(d), "bias": w(d)},
         "ln2": {"weight": 1 + w(d), "bias": w(d)},
         "qkv": {"weight": w(3 * d, d), "bias": w(3 * d)},
         "proj": {"weight": w(d, d), "bias": w(d)},
         "fc1": {"weight": w(hidden, d), "bias": w(hidden)},
         "fc2": {"weight": w(d, hidden), "bias": w(d)}}
    if policy:
        p["token_policy"] = {"weight": w(2, d, scale=1.0), "bias": w(2)}
    return p


def cases(dev):
    """(name, x, key mask, row mask, params, heads, head gate, policy)."""
    g = torch.Generator().manual_seed(0)
    out = []
    for name, b, l, d, heads, hidden, gated, policy in (
            ("deit_s L=197 ragged, head gate", 128, 197, 384, 6, 1536,
             True, False),
            ("deit_s L=98 segment layer, token gate", 128, 98, 384, 6, 1536,
             False, True),
            ("t2t_vit_19 L=197", 64, 197, 448, 7, 1344, False, False)):
        x = torch.randn(b, l, d, generator=g).to(dev, torch.bfloat16)
        kmask = (torch.rand(b, l, generator=g) > 0.25).float().to(dev)
        kmask[:, 0] = 1.0
        gate = ((torch.rand(b, heads, generator=g) > 0.3).float().to(dev)
                if gated else None)
        p = _layer(g, d, hidden, dev, policy)
        out.append((name, x, kmask, p, heads, gate, p.get("token_policy")))
    return out


def run(src_dir, device="cuda"):
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the comparison runs B1's kernels on a CUDA card")
    ours, other = _build.library(), other_library(Path(src_dir))
    results = {}
    for name, x, kmask, p, heads, gate, policy in cases(dev):
        for fast in (False, True):
            outs = []
            for lib in (ours, other):
                km = kmask.clone()
                # a token-gated layer updates one buffer as both masks (B2)
                rm = km if policy is not None else kmask.clone()
                y = vit_block._layer_cuda(lib, x, km, rm, p, heads, 1e-6,
                                          fast, policy=policy,
                                          head_gate=gate)
                outs.append((y, km))
            torch.cuda.synchronize()
            same = (torch.equal(outs[0][0], outs[1][0])
                    and torch.equal(outs[0][1], outs[1][1]))
            key = f"{name}, {'fast_math' if fast else 'exact'}"
            results[key] = same
            print(f"{key}: {'bit-equal' if same else 'DIFFERENT'} "
                  f"(largest difference "
                  f"{(outs[0][0].float() - outs[1][0].float()).abs().max().item():.6g})",
                  flush=True)
    print(json.dumps(results))
    if not all(results.values()):
        raise AssertionError("B1's production launches differ from the other "
                             "build's")
    return results


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m laudnet_tpu_torch.tools."
                         "compare_b1_build DIR_WITH_vit_block.cu")
    run(sys.argv[1])
