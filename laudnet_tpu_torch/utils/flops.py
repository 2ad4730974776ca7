"""Closed-form FLOPs of the dense networks (counterpart of
`laudnet_tpu/utils/flops.py::resnet_full_flops`; the JAX module's
``measure_model`` asks XLA's cost analysis and has no job in the port)."""

from __future__ import annotations


def resnet_full_flops(layers, input_size: int = 224, width_mult: float = 1.0,
                      num_classes: int = 1000) -> float:
    """Dense multiply-adds of the ResNet family by the in-graph
    bookkeeping: ``full_flops`` of the sparsity target."""
    from laudnet_tpu_torch.models.resnet import resnet_dense_flops

    return resnet_dense_flops(layers, input_size=input_size,
                              width_mult=width_mult, num_classes=num_classes)
