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
from laudnet_tpu_torch.models.laud_resnet import (BlockStats, LAUDBottleneck,
                                                  LAUDOutput, LAUDResNet,
                                                  uni_resnet50,
                                                  uni_resnet101)
from laudnet_tpu_torch.models.maskers import (ChannelMaskerConvLinear,
                                              ChannelMaskerMLP,
                                              SpatialMasker)
from laudnet_tpu_torch.models.resnet import (BasicBlock, Bottleneck, ResNet,
                                             resnet18, resnet34, resnet50,
                                             resnet101, resnet152,
                                             resnet_dense_flops)
from laudnet_tpu_torch.models.t2t import (T2TStem, TokenPerformer,
                                          t2t_stem_conv_apply,
                                          t2t_stem_flops)

__all__ = ["BasicBlock", "BlockStats", "Bottleneck",
           "ChannelMaskerConvLinear", "ChannelMaskerMLP", "LAUDBottleneck",
           "LAUDOutput", "LAUDResNet", "ResNet", "SpatialMasker",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnet_dense_flops", "uni_resnet50", "uni_resnet101",
           "LAUDViT", "LAUDViTBlock", "LAUDViTOutput", "T2TStem",
           "TokenPerformer", "laud_deit_base", "laud_deit_small",
           "laud_deit_tiny", "laud_t2t_vit_19", "laud_t2t_vit_19_backbone",
           "t2t_stem_conv_apply", "t2t_stem_flops", "vit_block_bookkeeping",
           "vit_dense_flops", "vit_policy_flops"]
