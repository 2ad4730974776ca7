"""The detectors of the PyTorch port (counterpart of
`laudnet_tpu/detection/`): LAUD-ResNet backbones under RetinaNet, Faster/
Mask R-CNN and the DETR family (DDQ-DETR, Mask2Former), their losses, the
runner and the CLI (``python -m laudnet_tpu_torch.detection.cli``)."""

from laudnet_tpu_torch.detection.backbone import LAUDDetBackbone
from laudnet_tpu_torch.detection.detr import (DETRDetector, detr_detect,
                                              detr_loss, hungarian_match,
                                              nms_keep_mask)
from laudnet_tpu_torch.detection.eval_info import evaluate_get_info
from laudnet_tpu_torch.detection.fpn import FPN
from laudnet_tpu_torch.detection.losses import loss_sparse
from laudnet_tpu_torch.detection.retinanet import RetinaNet, RetinaNetHead
from laudnet_tpu_torch.detection.runner import (
    DetTrainConfig,
    build_detector,
    evaluate_detector,
    make_detection_sgd,
    make_detector_train_step,
    mean_average_precision,
    synthetic_coco_batches,
    train_detector,
)
from laudnet_tpu_torch.detection.train import (assign_targets, box_iou,
                                               retinanet_loss)
from laudnet_tpu_torch.detection.two_stage import FasterRCNN, roi_align
from laudnet_tpu_torch.detection.two_stage_train import (faster_rcnn_loss,
                                                         roi_assign, rpn_loss)

__all__ = [
    "LAUDDetBackbone", "FPN", "RetinaNet", "RetinaNetHead", "loss_sparse",
    "FasterRCNN", "roi_align", "retinanet_loss", "assign_targets", "box_iou",
    "faster_rcnn_loss", "rpn_loss", "roi_assign", "DetTrainConfig",
    "make_detection_sgd", "make_detector_train_step",
    "mean_average_precision", "synthetic_coco_batches", "train_detector",
    "build_detector", "evaluate_detector", "evaluate_get_info",
    "DETRDetector", "detr_loss", "detr_detect", "hungarian_match",
    "nms_keep_mask",
]
