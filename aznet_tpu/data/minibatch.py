"""Minibatch construction (host NumPy -> device-ready dict-of-arrays).

Reference equivalents (SURVEY.md §2.2): ``lib/roi_data_layer/minibatch.py``
(``get_minibatch``, ``_sample_rois``, ``_get_bbox_regression_labels``) and
the AZ data layer (SURVEY.md §2.1). Same sampling semantics (2 ims/batch,
128 rois, 25% fg, bg in [0.1, 0.5), class-indexed 4C target layout), but the
output is padded fixed-shape NHWC arrays for jit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from aznet_tpu.config import Config
from aznet_tpu.ops.preprocess import prep_im_for_blob, im_list_to_blob
from aznet_tpu.utils.np_boxes import iou_np as _iou_np
from aznet_tpu.search.templates import adjacency_templates_np
from aznet_tpu.train.labels import az_labels_for_regions, sample_az_regions


def fixed_canvas(imdb, cfg: Config):
    """Static training canvas: max scaled image size over the roidb, rounded
    up to SIZE_MULTIPLE — so every minibatch compiles to ONE program."""
    from aznet_tpu.ops.preprocess import compute_scale

    mh = mw = 1
    target = max(cfg.TRAIN.SCALES)
    for e in imdb.roidb:
        s = compute_scale(e["height"], e["width"], target, cfg.TRAIN.MAX_SIZE)
        mh = max(mh, int(round(e["height"] * s)))
        mw = max(mw, int(round(e["width"] * s)))
    mult = cfg.TEST.SIZE_MULTIPLE
    return int(-(-mh // mult) * mult), int(-(-mw // mult) * mult)


def _prep_images(imdb, entries: List[dict], cfg: Config, rng, canvas=None):
    """Scale + mean-subtract each image; returns
    (blob, scales, scaled gt boxes, gt classes).

    The gt boxes AND classes are filtered in lockstep to drop difficult
    objects (VOC protocol): a caller that indexes classes with argmax indices
    computed against the filtered boxes would otherwise read the wrong class
    whenever an image has a difficult object (the round-2 FRCNN label bug).

    Uses the C++ fused prep (csrc: multithreaded resize+mean-subtract+pad
    straight into the canvas) when built and a fixed canvas is given; NumPy
    otherwise.
    """
    from aznet_tpu.ops.preprocess import compute_scale
    from aznet_tpu.utils import native

    scales, gts, gt_cls, raws = [], [], [], []
    for entry in entries:
        im = imdb.image_array(entry)
        target = cfg.TRAIN.SCALES[rng.randint(len(cfg.TRAIN.SCALES))]
        scale = compute_scale(im.shape[0], im.shape[1], target, cfg.TRAIN.MAX_SIZE)
        raws.append(im)
        scales.append(scale)
        boxes = entry["boxes"]
        classes = entry["gt_classes"]
        diff = entry.get("difficult")
        if diff is not None and diff.any():
            # Difficult gt stay in the roidb for eval but are excluded from
            # training labels, per the VOC protocol / reference config.
            boxes = boxes[~diff]
            classes = classes[~diff]
        gts.append(boxes * scale)
        gt_cls.append(classes)

    if canvas is not None and native.available() and all(
        r.dtype == np.uint8 for r in raws
    ):
        blob = np.stack([
            native.prep_blob(r, canvas[0], canvas[1], s, cfg.PIXEL_MEANS)
            for r, s in zip(raws, scales)
        ])
        return blob, scales, gts, gt_cls

    from aznet_tpu.ops.preprocess import _resize_bilinear_np

    ims = []
    for r, s in zip(raws, scales):
        out_h = int(round(r.shape[0] * s))
        out_w = int(round(r.shape[1] * s))
        im = r.astype(np.float32) - np.asarray(cfg.PIXEL_MEANS, np.float32)
        try:  # pragma: no cover - cv2 optional
            import cv2

            im = cv2.resize(im, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
        except ImportError:
            im = _resize_bilinear_np(im, out_h, out_w)
        ims.append(im)
    blob = im_list_to_blob(ims)
    # Round spatial dims up for static shapes.
    mult = cfg.TEST.SIZE_MULTIPLE
    h = int(-(-blob.shape[1] // mult) * mult)
    w = int(-(-blob.shape[2] // mult) * mult)
    if canvas is not None:
        h, w = max(h, canvas[0]), max(w, canvas[1])
    if (h, w) != blob.shape[1:3]:
        padded = np.zeros((blob.shape[0], h, w, 3), np.float32)
        padded[:, : blob.shape[1], : blob.shape[2]] = blob
        blob = padded
    return blob, scales, gts, gt_cls


def get_az_minibatch(imdb, entries: List[dict], cfg: Config, rng, canvas=None,
                     mined_by_entry=None) -> Dict[str, np.ndarray]:
    """AZ training batch from roidb entries (the AZ data layer's forward).

    ``mined_by_entry``: optional per-entry [M, 4] arrays (ORIGINAL image
    coords) of search-visited regions to mix into the anchor pool
    (train/mining.py).
    """
    blob, scales, gts, _ = _prep_images(imdb, entries, cfg, rng, canvas)
    templates = adjacency_templates_np(cfg.MODEL.NUM_TEMPLATES)
    b = len(entries)
    r = cfg.TRAIN.REGIONS_PER_IMAGE
    k = cfg.MODEL.NUM_TEMPLATES
    batch = {
        "images": blob,
        "rois": np.zeros((b, r, 4), np.float32),
        "roi_valid": np.zeros((b, r), bool),
        "zoom_labels": np.zeros((b, r), np.float32),
        "adj_labels": np.zeros((b, r, k), np.float32),
        "adj_targets": np.zeros((b, r, k, 4), np.float32),
        "adj_inside": np.zeros((b, r, k, 4), np.float32),
    }
    for i, entry in enumerate(entries):
        hw = (entry["height"] * scales[i], entry["width"] * scales[i])
        mined = None
        if mined_by_entry is not None and mined_by_entry[i] is not None:
            mined = mined_by_entry[i] * scales[i]
        regions = sample_az_regions(gts[i], hw, cfg.TRAIN, rng, offset=cfg.BOX_OFFSET,
                                    div_overlap=cfg.SEAR.DIV_OVERLAP,
                                    extra=mined)
        labels = az_labels_for_regions(regions, gts[i], cfg.TRAIN, templates,
                                       offset=cfg.BOX_OFFSET)
        n = regions.shape[0]
        batch["rois"][i, :n] = regions
        batch["roi_valid"][i, :n] = True
        batch["zoom_labels"][i, :n] = labels["zoom_labels"]
        batch["adj_labels"][i, :n] = labels["adj_labels"]
        batch["adj_targets"][i, :n] = labels["adj_targets"]
        batch["adj_inside"][i, :n] = labels["adj_inside"]
    return batch


def _sample_rois(proposals, gt_boxes, gt_classes, cfg: Config, rng):
    """fg/bg ROI sampling (reference ``_sample_rois``).

    Returns (rois, labels, targets, inside) with ROIS_PER_IMAGE rows.
    """
    tcfg = cfg.TRAIN
    rois_per_image = tcfg.BATCH_SIZE // tcfg.IMS_PER_BATCH
    fg_per_image = int(round(tcfg.FG_FRACTION * rois_per_image))
    # Include gt boxes among candidates, as the reference roidb does.
    cand = np.concatenate([proposals[:, :4], gt_boxes], axis=0) if gt_boxes.size else proposals[:, :4]
    if gt_boxes.size:
        iou = _iou_np(cand, gt_boxes, cfg.BOX_OFFSET)
        max_iou = iou.max(axis=1)
        gt_assign = iou.argmax(axis=1)
        labels = gt_classes[gt_assign].copy()
    else:
        max_iou = np.zeros(cand.shape[0])
        gt_assign = np.zeros(cand.shape[0], np.int64)
        labels = np.zeros(cand.shape[0], np.int32)

    fg_idx = np.flatnonzero(max_iou >= tcfg.FG_THRESH)
    bg_idx = np.flatnonzero((max_iou < tcfg.BG_THRESH_HI) & (max_iou >= tcfg.BG_THRESH_LO))
    if bg_idx.size == 0:  # degenerate: fall back to lowest-overlap candidates
        bg_idx = np.argsort(max_iou)[: max(rois_per_image - fg_idx.size, 1)]
    n_fg = min(fg_per_image, fg_idx.size)
    if n_fg:
        fg_idx = rng.choice(fg_idx, n_fg, replace=False)
    n_bg = rois_per_image - n_fg
    bg_idx = rng.choice(bg_idx, n_bg, replace=bg_idx.size < n_bg)
    keep = np.concatenate([fg_idx[:n_fg], bg_idx])
    labels = labels[keep]
    labels[n_fg:] = 0  # background

    rois = cand[keep].astype(np.float32)
    nc = cfg.MODEL.NUM_CLASSES
    targets = np.zeros((rois.shape[0], 4 * nc), np.float32)
    inside = np.zeros((rois.shape[0], 4 * nc), np.float32)
    if gt_boxes.size and n_fg:
        from aznet_tpu.utils.np_boxes import bbox_transform_np

        t = bbox_transform_np(rois[:n_fg], gt_boxes[gt_assign[keep[:n_fg]]],
                               cfg.BOX_OFFSET)
        if tcfg.BBOX_NORMALIZE_TARGETS:
            means = np.asarray(tcfg.BBOX_NORMALIZE_MEANS, np.float32)
            stds = np.asarray(tcfg.BBOX_NORMALIZE_STDS, np.float32)
            t = (t - means) / stds
        for j in range(n_fg):
            s = 4 * labels[j]
            targets[j, s : s + 4] = t[j]
            inside[j, s : s + 4] = 1.0
    return rois, labels.astype(np.int32), targets, inside


def get_frcnn_minibatch(imdb, entries: List[dict], proposals_by_entry: List[np.ndarray],
                        cfg: Config, rng, canvas=None) -> Dict[str, np.ndarray]:
    """Fast R-CNN training batch (reference ``get_minibatch``)."""
    blob, scales, gts, gt_cls = _prep_images(imdb, entries, cfg, rng, canvas)
    b = len(entries)
    r = cfg.TRAIN.BATCH_SIZE // cfg.TRAIN.IMS_PER_BATCH
    nc = cfg.MODEL.NUM_CLASSES
    batch = {
        "images": blob,
        "rois": np.zeros((b, r, 4), np.float32),
        "roi_valid": np.zeros((b, r), bool),
        "labels": np.zeros((b, r), np.int32),
        "bbox_targets": np.zeros((b, r, 4 * nc), np.float32),
        "bbox_inside": np.zeros((b, r, 4 * nc), np.float32),
    }
    for i, entry in enumerate(entries):
        props = proposals_by_entry[i][:, :4] * scales[i]
        rois, labels, targets, inside = _sample_rois(
            props, gts[i], gt_cls[i], cfg, rng
        )
        n = rois.shape[0]
        batch["rois"][i, :n] = rois
        batch["roi_valid"][i, :n] = True
        batch["labels"][i, :n] = labels
        batch["bbox_targets"][i, :n] = targets
        batch["bbox_inside"][i, :n] = inside
    return batch
