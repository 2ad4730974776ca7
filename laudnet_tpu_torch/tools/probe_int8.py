"""s8 rate probe of the card for the W8A8 serving paths (counterpart of
`tools/probe_int8.py`).

    python -m laudnet_tpu_torch.tools.probe_int8 [--quick]

Answers, on the card, what the int8 design rests on, each as a rate in
T(FL)OP/s of the logical product (2 * M * N * K, or 2 * B * H * W * Cin *
Cout * 9 for the convolutions), timed with CUDA events over a chain of
calls after warm-up (`tools/timing.py`):

* ``bf16_matmul_tflops``: ``torch.matmul``, 8192^3 bf16 (cuBLAS);
* ``s8_matmul_tops``: ``torch._int_mm``, 8192^3 s8 -> s32 (cuBLAS);
* ``cuda_s8_matmul_tops``: the port's own s8 GEMM (kernel P2,
  ``csrc/probe_int8.cu``, the s8 form of the GEMM core that B6's products
  run on, ``csrc/gemm_sm90.cuh``), n = 4096: does a hand-written wgmma s8
  product reach the s8 rate at a large K (B6 runs the same core at K =
  384-1536)?
* ``bf16_conv_tflops``: ``F.conv2d``, channels-last bf16, 128 x 14 x 14 x
  1024 -> 512, 3x3 (the JAX probe's shape, cuDNN);
* ``s8_conv_tops``: `ops/quant.py::int_conv2d` on codes (unfold +
  ``torch._int_mm``: the port's int8 convolution);
* ``qconv_pipeline_tflops``: the whole W8A8 convolution as `QuantConv`
  runs it, minus the weight quantisation: per-image abs-max, quantise,
  `int_conv2d`, dequantise by the activation and weight scales, from and
  to bf16 NHWC (the JAX probe's `rate_qconv_pipeline`).

Three convolutions over the 53 of ResNet-50 at batch 128 (every
distinct shape timed, weighted by how often the network runs it; the
rates the latency model prices the CNN forms at, `sim/hardware.py`):

* ``resnet50_conv_tflops``: cuDNN, channels-last bf16;
* ``resnet50_quantconv_tflops``: `QuantConv.forward` from and to bf16
  NHWC (``conv_impl='int8'``);
* ``resnet50_export_qconv_tflops``: the static int8 export's convolution
  (`infer/export_pruned.py::_qconv` with a calibrated scale).

The JAX probe reports a failed measurement and goes on; here every
failure raises. ``--quick`` runs each at a short chain (the smoke's main
path). Prints one line per rate and a JSON object.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from laudnet_tpu_torch.infer.export_pruned import _qconv, _quant_kernel
from laudnet_tpu_torch.ops.quant import QuantConv, int_conv2d, quantize_weight
from laudnet_tpu_torch.ops.s8_gemm import s8_gemm
from laudnet_tpu_torch.sim.models import MODEL_GEOMETRY
from laudnet_tpu_torch.tools.timing import chain_ms

CONV = dict(b=128, h=14, cin=1024, cout=512)


def _codes(g, *shape, device):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                         device="cpu").to(device)


def rate_matmul_bf16(dev, g, n=8192, chain=10):
    a = torch.randn(n, n, generator=g).to(dev, torch.bfloat16)
    b = torch.randn(n, n, generator=g).to(dev, torch.bfloat16)
    return 2 * n ** 3 / (chain_ms(lambda: a @ b, chain) * 1e-3) / 1e12


def rate_int_mm(dev, g, n=8192, chain=10):
    a = _codes(g, n, n, device=dev)
    w = _codes(g, n, n, device=dev)
    return 2 * n ** 3 / (chain_ms(lambda: torch._int_mm(a, w.t()), chain)
                         * 1e-3) / 1e12


def rate_cuda_s8(dev, g, n=4096, chain=20):
    a = _codes(g, n, n, device=dev)
    w = _codes(g, n, n, device=dev)
    return 2 * n ** 3 / (chain_ms(lambda: s8_gemm(a, w.t()), chain)
                         * 1e-3) / 1e12


def _conv_flops(c=CONV):
    return 2 * c["b"] * c["h"] * c["h"] * c["cin"] * c["cout"] * 9


def rate_conv_bf16(dev, g, chain=10):
    c = CONV
    x = torch.randn(c["b"], c["h"], c["h"], c["cin"], generator=g).to(
        dev, torch.bfloat16).permute(0, 3, 1, 2)  # channels-last NCHW view
    w = torch.randn(c["cout"], c["cin"], 3, 3, generator=g).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ms = chain_ms(lambda: F.conv2d(x, w, padding=1), chain)
    return _conv_flops() / (ms * 1e-3) / 1e12


def rate_int_conv(dev, g, chain=10):
    c = CONV
    xq = _codes(g, c["b"], c["h"], c["h"], c["cin"], device=dev).float(
        ).permute(0, 3, 1, 2)
    wq = _codes(g, c["cout"], c["cin"], 3, 3, device=dev)
    ms = chain_ms(lambda: int_conv2d(xq, wq, (1, 1), (1, 1), (1, 1), 1),
                  chain)
    return _conv_flops() / (ms * 1e-3) / 1e12


def rate_qconv_pipeline(dev, g, chain=10):
    c = CONV
    x = torch.randn(c["b"], c["h"], c["h"], c["cin"], generator=g).to(
        dev, torch.bfloat16)
    w = torch.randn(c["cout"], c["cin"], 3, 3, generator=g).to(dev)
    wq, ws = quantize_weight(w.flatten(1))
    wq = wq.reshape(w.shape)

    def step():
        xf = x.permute(0, 3, 1, 2).float()
        xs = xf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6) * (
            1.0 / 127.0)
        xq = torch.round(xf / xs).clamp(-127, 127)
        acc = int_conv2d(xq, wq, (1, 1), (1, 1), (1, 1), 1)
        return (acc * xs * ws[None, :, None, None]).to(x.dtype).permute(
            0, 2, 3, 1)

    return _conv_flops() / (chain_ms(step, chain) * 1e-3) / 1e12


def resnet50_convs():
    """``{(cin, cout, in_hw, k, stride): count}`` over ResNet-50's
    convolutions at 224² (the stem and each bottleneck's three, plus the
    downsample), the geometry of `sim/models.py`."""
    shapes = {(3, 64, 224, 7, 2): 1}
    for g in MODEL_GEOMETRY["resnet50"]:
        inh = g.h * g.stride
        convs = [(g.cin, g.width, inh, 1, 1), (g.width, g.width, inh, 3,
                                               g.stride),
                 (g.width, g.cout, g.h, 1, 1)]
        if g.has_downsample:
            convs.append((g.cin, g.cout, inh, 1, g.stride))
        for c in convs:
            shapes[c] = shapes.get(c, 0) + 1
    return shapes


def rate_resnet50_convs(dev, impl, batch=128, chain=5, repeats=2):
    """T(FL)OP/s of ``impl`` ('cudnn', 'quantconv', 'export') over the
    network's convolutions: total work over total time."""
    g = torch.Generator(dev).manual_seed(1)
    flops = ms = 0.0
    for (cin, cout, inh, k, stride), count in resnet50_convs().items():
        pad = k // 2
        x = torch.randn(batch, inh, inh, cin, device=dev, generator=g).to(
            torch.bfloat16)
        w = torch.randn(cout, cin, k, k, device=dev, generator=g)
        if impl == "cudnn":
            xc = x.permute(0, 3, 1, 2)
            wc = w.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            fn = (lambda xc=xc, wc=wc, s=stride, p=pad:
                  F.conv2d(xc, wc, stride=s, padding=p))
        elif impl == "quantconv":
            conv = QuantConv(cin, cout, k, stride, pad, device=dev)
            conv.weight.data.copy_(w)
            fn = lambda conv=conv, x=x: conv(x)
        else:
            kq = _quant_kernel(w)[0]
            fn = (lambda x=x, kq=kq, s=stride, p=pad:
                  _qconv(x, kq, s, p, absmax=4.0))
        with torch.no_grad():
            t = chain_ms(fn, chain, repeats, warmup=1)
        out_hw = inh // stride
        flops += count * 2.0 * batch * out_hw * out_hw * cin * cout * k * k
        ms += count * t
        del x, w, fn
    return flops / (ms * 1e-3) / 1e12


def run(quick: bool = False, device="cuda") -> dict:
    """All rates, as the JSON object the probe prints. ``quick`` chains 2
    calls instead of 10-20 (rates read from it are rough)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the probe measures a CUDA card")
    g = torch.Generator().manual_seed(0)
    ch = (lambda n: 2) if quick else (lambda n: n)
    out = {
        "bf16_matmul_tflops": rate_matmul_bf16(dev, g, chain=ch(10)),
        "s8_matmul_tops": rate_int_mm(dev, g, chain=ch(10)),
        "cuda_s8_matmul_tops": rate_cuda_s8(dev, g, chain=ch(20)),
        "bf16_conv_tflops": rate_conv_bf16(dev, g, chain=ch(10)),
        "s8_conv_tops": rate_int_conv(dev, g, chain=ch(10)),
        "qconv_pipeline_tflops": rate_qconv_pipeline(dev, g, chain=ch(10)),
    }
    for key, impl in (("conv", "cudnn"), ("quantconv", "quantconv"),
                      ("export_qconv", "export")):
        out[f"resnet50_{key}_tflops"] = rate_resnet50_convs(
            dev, impl, chain=ch(5), repeats=1 if quick else 2)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = run(quick="--quick" in argv)
    for k, v in out.items():
        print(f"{k:>26}: {v:.4f}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
