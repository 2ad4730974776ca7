"""Port models."""

from laudnet_tpu_torch.models.laud_vit import (LAUDViT, LAUDViTBlock,
                                               LAUDViTOutput,
                                               laud_deit_base,
                                               laud_deit_small,
                                               laud_deit_tiny,
                                               laud_t2t_vit_19,
                                               laud_t2t_vit_19_backbone,
                                               vit_block_bookkeeping,
                                               vit_dense_flops,
                                               vit_policy_flops)
from laudnet_tpu_torch.models.t2t import (T2TStem, TokenPerformer,
                                          t2t_stem_conv_apply,
                                          t2t_stem_flops)

__all__ = ["LAUDViT", "LAUDViTBlock", "LAUDViTOutput", "T2TStem",
           "TokenPerformer", "laud_deit_base", "laud_deit_small",
           "laud_deit_tiny", "laud_t2t_vit_19", "laud_t2t_vit_19_backbone",
           "t2t_stem_conv_apply", "t2t_stem_flops", "vit_block_bookkeeping",
           "vit_dense_flops", "vit_policy_flops"]
