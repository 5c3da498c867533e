"""IoU / overlap matrices.

Reference equivalent (SURVEY.md §2.3): the Cython ``bbox_overlaps`` in
``lib/utils/bbox.pyx`` (module ``cython_bbox``) — an O(N*K) nested host loop.
Here it is a broadcasted, jit-fusable jnp computation that XLA fuses into
one kernel.
"""

from __future__ import annotations

import jax.numpy as jnp


def bbox_overlaps(boxes, query_boxes, offset: float = 1.0):
    """IoU matrix between ``boxes [N, 4]`` and ``query_boxes [K, 4]`` -> [N, K].

    Caffe "+1" area convention by default (parity with cython_bbox): an
    intersection contributes only when both overlap extents are positive.
    """
    boxes = boxes.astype(jnp.float32)
    query_boxes = query_boxes.astype(jnp.float32)
    b = boxes[..., :, None, :]  # [N, 1, 4]
    q = query_boxes[..., None, :, :]  # [1, K, 4]
    iw = jnp.minimum(b[..., 2], q[..., 2]) - jnp.maximum(b[..., 0], q[..., 0]) + offset
    ih = jnp.minimum(b[..., 3], q[..., 3]) - jnp.maximum(b[..., 1], q[..., 1]) + offset
    inter = jnp.maximum(iw, 0.0) * jnp.maximum(ih, 0.0)
    area_b = (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)
    area_q = (q[..., 2] - q[..., 0] + offset) * (q[..., 3] - q[..., 1] + offset)
    union = area_b + area_q - inter
    return jnp.where(union > 0, inter / union, 0.0)


def intersection_over_area(boxes, query_boxes, offset: float = 1.0):
    """``inter(boxes, query) / area(boxes)`` -> [N, K].

    Used by AZ zoom-label generation ("gt mostly contained in region").
    """
    boxes = boxes.astype(jnp.float32)
    query_boxes = query_boxes.astype(jnp.float32)
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = jnp.minimum(b[..., 2], q[..., 2]) - jnp.maximum(b[..., 0], q[..., 0]) + offset
    ih = jnp.minimum(b[..., 3], q[..., 3]) - jnp.maximum(b[..., 1], q[..., 1]) + offset
    inter = jnp.maximum(iw, 0.0) * jnp.maximum(ih, 0.0)
    area_b = (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)
    return jnp.where(area_b > 0, inter / area_b, 0.0)
