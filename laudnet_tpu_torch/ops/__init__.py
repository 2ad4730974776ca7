"""The port's operators: gates, masking, norms, quantisation, sparse
execution, and the kernels' wrappers (B1, B2, B6 in `vit_block`, B4 and
B5 in `vit_attention`, B3 in `masked_block`).

Importing the package registers the kernels' ``laudnet::*`` ops with
`torch.library`, which is all a process needs to run a program that
`infer/aot.py` exported (no model code).
"""

from laudnet_tpu_torch.ops import masked_block, vit_attention, vit_block

__all__ = ["masked_block", "vit_attention", "vit_block"]
