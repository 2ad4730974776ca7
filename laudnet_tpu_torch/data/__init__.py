"""Input pipelines of the port (counterpart of `laudnet_tpu/data/`): the
ImageNet transforms and AutoAugment (PIL), the image-folder loader, the
native C++ loader and the COCO reader. Host-side numpy; the training CLI
moves the batches to the card."""

from laudnet_tpu_torch.data.transforms import (
    train_transform,
    eval_transform,
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from laudnet_tpu_torch.data.loader import (
    ImageFolderDataset,
    DataLoader,
    synthetic_batches,
)
from laudnet_tpu_torch.data.native_loader import (
    NativeBatchTransform,
    NativeDataLoader,
    native_available,
)

__all__ = [
    "NativeBatchTransform",
    "NativeDataLoader",
    "native_available",
    "train_transform",
    "eval_transform",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ImageFolderDataset",
    "DataLoader",
    "synthetic_batches",
]
