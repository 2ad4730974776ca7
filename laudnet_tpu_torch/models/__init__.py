"""Port models."""

from laudnet_tpu_torch.models.laud_vit import (LAUDViT, LAUDViTBlock,
                                               LAUDViTOutput,
                                               laud_deit_base,
                                               laud_deit_small,
                                               laud_deit_tiny,
                                               vit_block_bookkeeping,
                                               vit_dense_flops,
                                               vit_policy_flops)

__all__ = ["LAUDViT", "LAUDViTBlock", "LAUDViTOutput", "laud_deit_base",
           "laud_deit_small", "laud_deit_tiny", "vit_block_bookkeeping",
           "vit_dense_flops", "vit_policy_flops"]
