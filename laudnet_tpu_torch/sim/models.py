"""Network geometry tables for the latency model (a copy of
`laudnet_tpu/sim/models.py:20-83`, which the port does not import): the
bottleneck blocks of ResNet-50/101 and RegNetY-400MF/800MF. The GPU
roofline predictor's block compositions (`predict_network`,
``*_block_latency``) are not copied; `sim/h100.py` prices the port's own
execution forms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


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
