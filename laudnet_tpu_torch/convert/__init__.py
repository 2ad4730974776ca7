"""Weight converters: the JAX package's parameter trees into port models
(`from_jax`), and reference PyTorch checkpoints to and from that flax-named
tree (`torch_loader`, `vit_loader`, `torch_export`)."""

from laudnet_tpu_torch.convert.from_jax import (
    load_flax_variables,
    to_flax_batch_stats,
    to_flax_tree,
    to_flax_variables,
)
from laudnet_tpu_torch.convert.torch_loader import (
    convert_detection_backbone_state_dict,
    convert_regnet_state_dict,
    convert_resnet_state_dict,
    load_pth_tar,
    merge_variables,
)
from laudnet_tpu_torch.convert.torch_export import (
    export_resnet_state_dict,
    save_pth_tar,
)
from laudnet_tpu_torch.convert.vit_loader import convert_vit_state_dict

__all__ = [
    "convert_vit_state_dict",
    "convert_resnet_state_dict",
    "convert_regnet_state_dict",
    "convert_detection_backbone_state_dict",
    "merge_variables",
    "load_pth_tar",
    "export_resnet_state_dict",
    "save_pth_tar",
    "load_flax_variables",
    "to_flax_tree",
    "to_flax_batch_stats",
    "to_flax_variables",
]
