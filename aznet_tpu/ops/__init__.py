"""Core tensor ops: box codecs, IoU, NMS, ROI pooling, preprocessing, losses.

Device equivalents of the reference's native layer (SURVEY.md §2.3):
Cython ``bbox_overlaps``/``nms`` and CUDA ``ROIPooling``/``SmoothL1Loss``
become vectorized JAX (jit-fused by XLA) plus Pallas kernels for the hot
paths. Caffe's "+1" width/area conventions are preserved behind an ``offset``
parameter (1.0 = parity with the reference, 0.0 = modern convention).
"""

from aznet_tpu.ops.boxes import (
    bbox_transform,
    bbox_transform_inv,
    clip_boxes,
    box_area,
    flip_boxes,
)
from aznet_tpu.ops.iou import bbox_overlaps
from aznet_tpu.ops.nms import nms, nms_jax, nms_mask, nms_topk
from aznet_tpu.ops.losses import smooth_l1_loss, sigmoid_ce_loss, softmax_ce_loss
from aznet_tpu.ops.roi_pool import roi_pool, roi_align, roi_pool_caffe
from aznet_tpu.ops.preprocess import preprocess_image, prep_im_for_blob, im_list_to_blob
