"""Network geometry tables and the GPU roofline simulator's network
predictions (a copy of `laudnet_tpu/sim/models.py`, which the port does
not import): the bottleneck blocks of ResNet-50/101 and
RegNetY-400MF/800MF, and their static, spatial, channel and layer block
latencies on a `sim/dynamic.py::DynamicPredictor` (`predict_network`).
`sim/h100.py` prices the port's own execution forms on the same geometry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from laudnet_tpu_torch.sim.dynamic import DynamicPredictor
from laudnet_tpu_torch.sim.report import SimulationReport


@dataclass
class BlockGeom:
    """One bottleneck block: 1x1 (cin->width) / kxk (width) / 1x1 (->cout)."""

    cin: int
    width: int
    cout: int
    h: int  # output resolution
    stride: int = 1
    groups: int = 1
    has_downsample: bool = False
    se_ratio: float = 0.0  # >0: SE with mid = width * se_ratio (RegNetY)


def resnet_geometry(depths: Sequence[int], width_mult: float = 1.0,
                    input_size: int = 224) -> List[BlockGeom]:
    """Bottleneck geometry of a torchvision-style ResNet."""
    blocks: List[BlockGeom] = []
    cin = int(64 * width_mult)
    sizes = [input_size // 4, input_size // 8, input_size // 16, input_size // 32]
    for s, planes in enumerate(int(p * width_mult) for p in (64, 128, 256, 512)):
        for b in range(depths[s]):
            stride = (2 if s > 0 else 1) if b == 0 else 1
            cout = planes * 4
            blocks.append(
                BlockGeom(cin=cin, width=planes, cout=cout, h=sizes[s],
                          stride=stride,
                          has_downsample=(b == 0 and (stride != 1 or cin != cout)))
            )
            cin = cout
    return blocks


RESNET50 = resnet_geometry((3, 4, 6, 3))
RESNET101 = resnet_geometry((3, 4, 23, 3))

# RegNetY geometry (widths/depths/groups from the published model cards).
def _regnet_geometry(widths, depths, group_w, input_size=224) -> List[BlockGeom]:
    blocks: List[BlockGeom] = []
    cin = 32
    size = input_size // 2
    for stage, (w, d) in enumerate(zip(widths, depths)):
        size //= 2
        for b in range(d):
            stride = 2 if b == 0 else 1
            blocks.append(
                BlockGeom(cin=cin, width=w, cout=w, h=size, stride=stride,
                          groups=max(w // group_w, 1),
                          has_downsample=(b == 0), se_ratio=0.25)
            )
            cin = w
    return blocks


REGNETY_400MF = _regnet_geometry((48, 104, 208, 440), (1, 3, 6, 6), 8)
REGNETY_800MF = _regnet_geometry((64, 144, 320, 784), (1, 2, 8, 2), 16)

MODEL_GEOMETRY = {
    "resnet50": RESNET50,
    "resnet101": RESNET101,
    "regnety_400mf": REGNETY_400MF,
    "regnety_800mf": REGNETY_800MF,
}


def static_block_latency(p: DynamicPredictor, g: BlockGeom) -> SimulationReport:
    """Dense bottleneck: conv1 + conv2 + conv3 [+SE] [+downsample] + add."""
    inh = g.h * g.stride
    rep = p.conv(g.cin, g.width, inh, inh, 1)
    rep = rep + p.conv(g.width, g.width, inh, inh, 3,
                       groups=g.groups, stride=g.stride)
    if g.se_ratio:
        rep = rep + p.se(g.width, g.h, g.h,
                         reduction=int(1 / g.se_ratio))
    rep = rep + p.conv(g.width, g.cout, g.h, g.h, 1)
    if g.has_downsample:
        rep = rep + p.conv(g.cin, g.cout, inh, inh, 1, stride=g.stride)
    rep = rep + p.add(g.cout, g.h, g.h)
    return rep


def spatial_block_latency(p: DynamicPredictor, g: BlockGeom, granul: int,
                          act_rate: float) -> SimulationReport:
    """Spatial-wise dynamic block (reference `eval_example.py:31-60`)."""
    inh = g.h * g.stride
    rep = p.masker_conv1(g.cin, g.width, inh, inh, granul, act_rate,
                         channel_masker=False, spatial_masker=True)
    rep = rep + p.gather(g.width, inh, inh, granul * g.stride, act_rate, pad=1)
    rep = rep + p.dynamic_conv(g.width, g.width, g.h, g.h, 3, granul,
                               act_rate, groups=g.groups, stride=g.stride)
    if g.se_ratio:
        rep = rep + p.dynamic_se(g.width, g.h, g.h, granul, act_rate,
                                 reduction=int(1 / g.se_ratio))
    rep = rep + p.dynamic_conv(g.width, g.cout, g.h, g.h, 1, granul, act_rate)
    if g.has_downsample:
        rep = rep + p.conv(g.cin, g.cout, inh, inh, 1, stride=g.stride)
    rep = rep + p.scatter_add(g.cout, g.h, g.h, granul, act_rate)
    return rep


def channel_block_latency(p: DynamicPredictor, g: BlockGeom, c_group: int,
                          act_rate: float) -> SimulationReport:
    """Channel-skipping block: density-scaled convs + gating head
    (reference `eval_example.py:63-94`)."""
    inh = g.h * g.stride
    hid = max((g.width // c_group) // 16, 16)
    rep = p.channel_masker_predictor(g.cin, hid, g.width // c_group, inh, inh)
    rep = rep + p.conv(g.cin, g.width, inh, inh, 1,
                       oc_density=act_rate, c_group=c_group)
    rep = rep + p.conv(g.width, g.width, inh, inh, 3, groups=g.groups,
                       stride=g.stride, ic_density=act_rate,
                       oc_density=act_rate, c_group=c_group)
    if g.se_ratio:
        rep = rep + p.se(g.width, g.h, g.h, reduction=int(1 / g.se_ratio))
    rep = rep + p.conv(g.width, g.cout, g.h, g.h, 1,
                       ic_density=act_rate, c_group=c_group)
    if g.has_downsample:
        rep = rep + p.conv(g.cin, g.cout, inh, inh, 1, stride=g.stride)
    rep = rep + p.add(g.cout, g.h, g.h)
    return rep


def layer_block_latency(p: DynamicPredictor, g: BlockGeom,
                        act_rate: float) -> SimulationReport:
    """Layer skipping: masker always runs; the block body runs with
    probability = act_rate (reference `eval_example.py:97-122`)."""
    inh = g.h * g.stride
    masker = p.global_avg_pool(g.cin, inh, inh) + p.fc(g.cin, 2)
    body = static_block_latency(p, g)
    return SimulationReport(
        latency=masker.latency + act_rate * body.latency,
        compute_latency=masker.compute_latency + act_rate * body.compute_latency,
        memory_latency=masker.memory_latency + act_rate * body.memory_latency,
        cfg=[dict(op="layer_skip", act_rate=act_rate)],
    )


def predict_network(p: DynamicPredictor, model: str, mode: str = "static",
                    act_rates: Optional[Sequence[float]] = None,
                    granularity: Optional[Sequence[int]] = None,
                    channel_group: int = 2) -> SimulationReport:
    """Sweep a whole backbone. ``act_rates``: per-block activation rates
    (defaults to 1.0); ``granularity``: per-block spatial patch sizes."""
    blocks = MODEL_GEOMETRY[model]
    n = len(blocks)
    act_rates = list(act_rates) if act_rates is not None else [1.0] * n
    granularity = list(granularity) if granularity is not None else [4] * n
    total = SimulationReport()
    for g, rate, gran in zip(blocks, act_rates, granularity):
        if mode == "static":
            total = total + static_block_latency(p, g)
        elif mode == "spatial":
            total = total + spatial_block_latency(p, g, gran, rate)
        elif mode == "channel":
            total = total + channel_block_latency(p, g, channel_group, rate)
        elif mode == "layer":
            total = total + layer_block_latency(p, g, rate)
        else:
            raise ValueError(mode)
    return total
