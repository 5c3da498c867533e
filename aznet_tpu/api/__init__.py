"""Public inference API mirroring the reference.

Reference equivalents (SURVEY.md §3.1/§3.2):
  - ``im_propose(net, im)``          — lib/detect/test.py::im_propose
  - ``im_detect(net, im, boxes)``    — lib/fast_rcnn/test.py::im_detect

A ``Net`` bundles (model, params, config) — the role pycaffe's
``caffe.Net`` plays for the reference. The host functions take a raw HWC BGR
image (any size), do fused preprocessing onto a bucketed static canvas
(bounded recompiles), run the fully on-device pipeline, and return NumPy
results in ORIGINAL image coordinates, exactly like the reference:
``im_propose`` -> float32 ``(N, 5) [x1, y1, x2, y2, score]``;
``im_detect`` -> ``(scores (R, C), pred_boxes (R, 4C))``.

``propose_batch`` / ``detect_batch`` are the jit-native batched variants
(the throughput path; the reference has no equivalent — it is single-image
host-driven).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from aznet_tpu.config import Config
from aznet_tpu.models import AZNet, FRCNN
from aznet_tpu.ops.boxes import bbox_transform_inv, clip_boxes
from aznet_tpu.ops.preprocess import compute_scale, preprocess_image
from aznet_tpu.search import az_search


@dataclasses.dataclass
class Net:
    """Model + weights + config (the pycaffe ``caffe.Net`` role)."""

    model: Any
    params: Any
    cfg: Config
    # Compiled programs are keyed on (kind, canvas[, r_pad]); pyramid
    # canvases x r_pad buckets can multiply, so the cache is LRU-bounded
    # (each VGG-16 propose executable holds ~0.3 GB of device constants).
    jit_cache_size: int = 32

    def __post_init__(self):
        import collections

        self._jit_cache = collections.OrderedDict()

    def get_jit(self, key, build):
        """LRU-cached ``jax.jit`` program for ``key``; ``build()`` makes it."""
        cache = self._jit_cache
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        fn = build()
        cache[key] = fn
        while len(cache) > self.jit_cache_size:
            cache.popitem(last=False)
        return fn


def build_az_net(cfg: Config, params=None, rng=None) -> Net:
    """Construct an AZ-Net ``Net`` (random-init if no params given)."""
    model = AZNet(model_cfg=cfg.MODEL)
    if params is None:
        rng = rng if rng is not None else jax.random.PRNGKey(cfg.RNG_SEED)
        images = jnp.zeros((1, 64, 64, 3), jnp.float32)
        rois = jnp.array([[0.0, 0.0, 31.0, 31.0]])
        params = model.init(rng, images, rois)
    return Net(model, params, cfg)


def build_frcnn_net(cfg: Config, params=None, rng=None) -> Net:
    model = FRCNN(model_cfg=cfg.MODEL)
    if params is None:
        rng = rng if rng is not None else jax.random.PRNGKey(cfg.RNG_SEED)
        images = jnp.zeros((1, 64, 64, 3), jnp.float32)
        rois = jnp.array([[0.0, 0.0, 31.0, 31.0]])
        params = model.init(rng, images, rois)
    return Net(model, params, cfg)


# ---------------------------------------------------------------------------
# Canvas bucketing: bound the number of distinct compiled shapes.
# ---------------------------------------------------------------------------


def _canvas_for(h: int, w: int, cfg: Config, bucket: int = 64):
    scale = compute_scale(h, w, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
    sh, sw = int(round(h * scale)), int(round(w * scale))
    rup = lambda v: int(-(-v // bucket) * bucket)
    return rup(sh), rup(sw)


# ---------------------------------------------------------------------------
# im_propose
# ---------------------------------------------------------------------------


def _blob_dtype(cfg: Config):
    return (jnp.float32 if cfg.MODEL.COMPUTE_DTYPE == "float32"
            else jnp.bfloat16)


def _maybe_quantize_feat(cfg: Config, feat):
    """cfg.MODEL.INT8_ROI: quantize the trunk output once (conv5_3's
    calibrated scale) so ROI pooling + fc6 run as int8 GEMMs end to end
    (ops/roi_pool.py::roi_align_int8). One elementwise pass per image,
    hoisted out of the search's while_loop by construction."""
    mc = cfg.MODEL
    if (mc.INT8_ROI and mc.INT8_HEAD_SCALES and mc.POOLING_MODE == "align"
            and mc.COMPUTE_DTYPE != "float32"):
        from aznet_tpu.ops.conv_int8 import quantize_acts

        return quantize_acts(feat, mc.INT8_HEAD_SCALES[0])
    return feat


def _cast_inference_params(params, cfg: Config):
    """Pre-cast float32 params to the compute dtype ONCE per call.

    The layers cast weights at each application; inside the search's
    while_loop that means re-casting the ~100M fc parameters EVERY level
    (XLA does not hoist it).
    Head outputs stay float32 via the heads' explicit dtype.
    """
    cast = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if hasattr(x, "dtype") and x.dtype == jnp.float32 else x,
        tree,
    )
    if cfg.MODEL.COMPUTE_DTYPE == "bfloat16":
        return cast(params)
    if cfg.MODEL.COMPUTE_DTYPE == "int8":
        # Heads still compute in bf16; the trunk kernels stay f32 so
        # in-jit weight quantization sees full precision (read once).
        return {
            k: ({kk: (vv if kk == "trunk" else cast(vv))
                 for kk, vv in v.items()} if k == "params" else v)
            for k, v in params.items()
        }
    return params


def _propose_core(model, params, cfg: Config, image, canvas_hw,
                  src_hw=None, scale=None, roi_wrap=None):
    """image: raw [H, W, 3] BGR (device array) -> (boxes, scores, valid) in
    ORIGINAL image coordinates. ``src_hw``/``scale``: dynamic true extents +
    host-computed scale when ``image`` is zero-padded to a static raw shape
    (the canvas-bucketed batched path). ``roi_wrap``: optional decorator
    around the per-level head call — the region-parallel inference path
    (parallel/inference.py) injects a sharding constraint on the frontier
    here so XLA partitions ROI pool + fc over the mesh."""
    params = _cast_inference_params(params, cfg)
    blob, im_scale, (vh, vw) = preprocess_image(
        image, cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
        canvas_hw[0], canvas_hw[1], dtype=_blob_dtype(cfg),
        src_hw=src_hw, scale=scale,
    )
    feat = _maybe_quantize_feat(cfg, model.apply(
        params, blob[None], method="features")[0])

    def roi_fwd(f, r):
        return model.apply(params, f, r, method="roi_forward")

    if roi_wrap is not None:
        roi_fwd = roi_wrap(roi_fwd)

    boxes, scores, valid = az_search(
        roi_fwd, feat, (vh, vw), cfg.SEAR,
        num_templates=cfg.MODEL.NUM_TEMPLATES, offset=cfg.BOX_OFFSET,
    )
    return boxes / im_scale, scores, valid


def _propose_core_pyramid(model, params, cfg: Config, image, canvases):
    """Multi-scale zoom search (BASELINE config 5): run the full search per
    TEST.SCALES entry and merge candidates with one cross-scale NMS."""
    from aznet_tpu.ops.nms import nms_topk

    all_boxes, all_scores, all_valid = [], [], []
    for s_idx, target in enumerate(cfg.TEST.SCALES):
        sub = dataclasses.replace(
            cfg, TEST=dataclasses.replace(cfg.TEST, SCALES=(target,)))
        b, s, v = _propose_core(model, params, sub, image, canvases[s_idx])
        all_boxes.append(b)
        all_scores.append(s)
        all_valid.append(v)
    boxes = jnp.concatenate(all_boxes)
    scores = jnp.concatenate(all_scores)
    valid = jnp.concatenate(all_valid)
    return nms_topk(boxes, jnp.where(valid, scores, -jnp.inf),
                    cfg.SEAR.NMS_THRESH, cfg.SEAR.NUM_PROPOSALS,
                    valid=valid, offset=cfg.BOX_OFFSET)


def im_propose(net: Net, im: np.ndarray) -> np.ndarray:
    """Scored proposals for one raw BGR image -> float32 (N, 5).

    Reference-mirroring host entry point; the device work is one compiled
    program per canvas bucket. Multiple cfg.TEST.SCALES run the multi-scale
    zoom search with a cross-scale NMS merge.
    """
    cfg = net.cfg
    if len(cfg.TEST.SCALES) > 1:
        canvases = tuple(
            _canvas_for(im.shape[0], im.shape[1],
                        dataclasses.replace(
                            cfg, TEST=dataclasses.replace(cfg.TEST, SCALES=(t,))))
            for t in cfg.TEST.SCALES
        )
        fn = net.get_jit(("propose_pyr", canvases), lambda: jax.jit(
            partial(_propose_core_pyramid, net.model, canvases=canvases, cfg=cfg)))
    else:
        canvas = _canvas_for(im.shape[0], im.shape[1], cfg)
        fn = net.get_jit(("propose", canvas), lambda: jax.jit(
            partial(_propose_core, net.model, canvas_hw=canvas, cfg=cfg)))
    boxes, scores, valid = fn(net.params, image=jnp.asarray(im))
    n = int(np.asarray(valid).sum())
    out = np.concatenate(
        [np.asarray(boxes)[:n], np.asarray(scores)[:n, None]], axis=1
    ).astype(np.float32)
    return out


def share_trunk(dst_net: Net, src_net: Net) -> Net:
    """Copy the trunk parameters of ``src_net`` into ``dst_net`` in place.

    The paper's shared-trunk evaluation (SURVEY.md §2.1 "Shared-trunk /
    combined eval"): AZ-Net and Fast R-CNN share conv features; both modules
    name the backbone submodule 'trunk', so sharing is parameter surgery.
    Requires identical backbones. Returns ``dst_net``.
    """
    src = src_net.params["params"]["trunk"]
    dst = dict(dst_net.params)
    dst["params"] = {**dst_net.params["params"], "trunk": src}
    dst_net.params = dst
    dst_net._jit_cache.clear()
    return dst_net


# ---------------------------------------------------------------------------
# im_detect
# ---------------------------------------------------------------------------


def select_class_boxes(scores, pred):
    """Per-roi argmax-class decoded box: ``scores [R, C]``, ``pred
    [R, 4C]`` -> ``[R, 4]``.

    Background (class 0) is excluded — its regressor is never trained with
    box targets, so its deltas are noise; a background-dominated roi keeps
    its best FOREGROUND hypothesis for the next regression pass / proposal
    refinement."""
    cls = jnp.argmax(scores[:, 1:], axis=1) + 1  # [R]
    r = pred.shape[0]
    pred4 = pred.reshape(r, -1, 4)
    return jnp.take_along_axis(pred4, cls[:, None, None], axis=1)[:, 0]


def _detect_core(model, params, cfg: Config, image, boxes, canvas_hw,
                 src_hw=None, scale=None):
    """Raw image + proposal boxes (original coords) -> (scores, pred_boxes).

    ``src_hw``/``scale``: dynamic true extents + host-computed scale when
    ``image`` is zero-padded to a static raw shape (batched bucketed path).
    """
    params = _cast_inference_params(params, cfg)
    blob, im_scale, (vh, vw) = preprocess_image(
        image, cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
        canvas_hw[0], canvas_hw[1], dtype=_blob_dtype(cfg),
        src_hw=src_hw, scale=scale,
    )
    feat = _maybe_quantize_feat(cfg, model.apply(
        params, blob[None], method="features")[0])
    if src_hw is None:
        h0 = jnp.asarray(image.shape[0], jnp.float32)
        w0 = jnp.asarray(image.shape[1], jnp.float32)
    else:
        h0 = jnp.asarray(src_hw[0], jnp.float32)
        w0 = jnp.asarray(src_hw[1], jnp.float32)
    # Iterative bbox regression (TEST.BBOX_ITER; 1 = the reference's single
    # decode): re-pool each roi at its argmax-class decoded box and
    # re-regress. The loop is unrolled under jit (static trip count).
    cur = boxes
    for it in range(max(int(cfg.TEST.BBOX_ITER), 1)):
        # Project rois to the scaled image (reference _project_im_rois).
        out = model.apply(params, feat, cur * im_scale, method="roi_forward")
        scores = jax.nn.softmax(out["cls_score"], axis=-1)
        # Decode against ORIGINAL-coordinate boxes, as the reference does.
        pred = bbox_transform_inv(cur, out["bbox_pred"], cfg.BOX_OFFSET)
        pred = clip_boxes(pred, (h0, w0), cfg.BOX_OFFSET)
        if it + 1 < max(int(cfg.TEST.BBOX_ITER), 1):
            cur = select_class_boxes(scores, pred)
    return scores, pred


def _detect_core_pyramid(model, params, cfg: Config, image, boxes, canvases):
    """Multi-scale image-pyramid im_detect (reference cfg.TEST.SCALES path,
    SURVEY.md §5.7): run the trunk per scale; each roi reads the scale whose
    scaled area is closest to 224^2 (the fast-rcnn heuristic).

    The head runs ONCE: rois are pooled from every scale's feature map
    (cheap gathers), the pooled [R, P, P, C] tensors are selected per roi
    by the scale-assignment rule, and the fc6/fc7 head sees R rows — the
    reference pushes every roi through the head at every scale (R*S)."""
    params = _cast_inference_params(params, cfg)
    off = cfg.BOX_OFFSET
    w = boxes[:, 2] - boxes[:, 0] + off
    h = boxes[:, 3] - boxes[:, 1] + off
    areas = w * h  # [R]

    pooled_s, scale_errs = [], []
    for s_idx, target in enumerate(cfg.TEST.SCALES):
        blob, im_scale, _ = preprocess_image(
            image, cfg.PIXEL_MEANS, target, cfg.TEST.MAX_SIZE,
            canvases[s_idx][0], canvases[s_idx][1], dtype=_blob_dtype(cfg),
        )
        feat = _maybe_quantize_feat(cfg, model.apply(
            params, blob[None], method="features")[0])
        pooled_s.append(model.apply(params, feat, boxes * im_scale,
                                    method="roi_pool_only"))
        # fast-rcnn's rule: minimize |area * scale^2 - 224^2| (not the
        # sqrt'd variant — the two differ near crossover points).
        scale_errs.append(jnp.abs(areas * im_scale**2 - 224.0**2))
    errs = jnp.stack(scale_errs, axis=0)  # [S, R]
    assign = jnp.argmin(errs, axis=0)  # [R]

    stacked = jnp.stack(pooled_s, axis=0)  # [S, R, P, P, C]
    sel = assign.reshape((1, -1) + (1,) * (stacked.ndim - 2))
    pooled = jnp.take_along_axis(stacked, sel, axis=0)[0]  # [R, P, P, C]
    out = model.apply(params, pooled, method="head_forward")

    scores = jax.nn.softmax(out["cls_score"], axis=-1)
    pred = bbox_transform_inv(boxes, out["bbox_pred"], off)
    h0 = jnp.asarray(image.shape[0], jnp.float32)
    w0 = jnp.asarray(image.shape[1], jnp.float32)
    return scores, clip_boxes(pred, (h0, w0), off)


def im_detect(net: Net, im: np.ndarray, boxes: np.ndarray):
    """Detection head forward: ``(scores (R, C), pred_boxes (R, 4C))``.

    Boxes are padded to a multiple of 128 on device (static shapes); only
    the first R rows are returned. With multiple cfg.TEST.SCALES this runs
    the reference's image-pyramid path.
    """
    cfg = net.cfg
    r = boxes.shape[0]
    r_pad = max(128, int(-(-r // 128) * 128))
    padded = np.zeros((r_pad, 4), np.float32)
    padded[:r] = boxes[:, :4]
    if len(cfg.TEST.SCALES) > 1:
        canvases = tuple(
            _canvas_for(im.shape[0], im.shape[1],
                        dataclasses.replace(
                            cfg, TEST=dataclasses.replace(cfg.TEST, SCALES=(t,))))
            for t in cfg.TEST.SCALES
        )
        fn = net.get_jit(("detect_pyr", canvases, r_pad), lambda: jax.jit(
            partial(_detect_core_pyramid, net.model, canvases=canvases, cfg=cfg)))
    else:
        canvas = _canvas_for(im.shape[0], im.shape[1], cfg)
        fn = net.get_jit(("detect", canvas, r_pad), lambda: jax.jit(
            partial(_detect_core, net.model, canvas_hw=canvas, cfg=cfg)))
    scores, pred = fn(
        net.params, image=jnp.asarray(im), boxes=jnp.asarray(padded)
    )
    return np.asarray(scores)[:r], np.asarray(pred)[:r]


# ---------------------------------------------------------------------------
# Batched jit-native variants (the throughput path)
# ---------------------------------------------------------------------------


def make_propose_batch(model, cfg: Config, canvas_hw, roi_wrap=None):
    """Returns a jittable ``(params, images [B,H,W,3] raw BGR) -> (boxes,
    scores, valid)`` over a fixed canvas; boxes in original coordinates.
    ``roi_wrap`` threads to :func:`_propose_core` (region-parallel path)."""

    def fn(params, images):
        def one(image):
            return _propose_core(model, params, cfg, image, canvas_hw,
                                 roi_wrap=roi_wrap)

        return jax.vmap(one)(images)

    return fn


def make_propose_batch_padded(model, cfg: Config, canvas_hw):
    """Batched propose over ZERO-PADDED raw images: ``(params,
    images [B,Hp,Wp,3], src_hw [B,2] float32, scales [B] float32) ->
    (boxes, scores, valid)``.

    The batched eval path pads raw images to a per-canvas-bucket static
    shape on host, so XLA compiles ONE program per canvas bucket instead of
    one per distinct raw image size (dozens on real VOC)."""

    def fn(params, images, src_hw, scales):
        def one(image, hw, s):
            return _propose_core(model, params, cfg, image, canvas_hw,
                                 src_hw=hw, scale=s)

        return jax.vmap(one)(images, src_hw, scales)

    return fn


def trunks_shared(az_net: Net, frcnn_net: Net) -> bool:
    """True iff the two nets share trunk parameters (``share_trunk``).

    Identity check on the param leaves — the fused propose+detect program
    is only numerically equivalent to the two-program path when the trunks
    are literally the same weights.
    """
    ta = az_net.params["params"]["trunk"]
    tb = frcnn_net.params["params"]["trunk"]
    if ta is tb:
        return True
    la = jax.tree_util.tree_leaves(ta)
    lb = jax.tree_util.tree_leaves(tb)
    return len(la) == len(lb) and all(a is b for a, b in zip(la, lb))


def make_fused_detect_batch_padded(az_model, frcnn_model, cfg_az: Config,
                                   cfg_fr: Config, canvas_hw):
    """ONE program for the shared-trunk end-to-end pipeline: trunk once ->
    AZ zoom search -> surviving boxes -> FRCNN head, all in the same jit.

    ``(az_params, fr_params, images [B,Hp,Wp,3], src_hw [B,2],
    scales [B]) -> (prop_boxes [B,N,4] original coords, prop_scores,
    prop_valid, det_scores [B,N,C], det_boxes [B,N,4C])``.

    The reference runs two separate Caffe nets and computes the conv trunk
    twice even when evaluating the paper's shared-trunk setting (SURVEY.md
    §2.1 "Shared-trunk / combined eval" [M]; mount empty, no file:line) —
    this cuts BASELINE config 3's cost by roughly a full trunk forward.
    Only valid when :func:`trunks_shared` holds.
    """

    def fn(az_params, fr_params, images, src_hw, scales):
        def one(image, hw, s):
            az_p = _cast_inference_params(az_params, cfg_az)
            blob, im_scale, (vh, vw) = preprocess_image(
                image, cfg_az.PIXEL_MEANS, cfg_az.TEST.SCALES[0],
                cfg_az.TEST.MAX_SIZE, canvas_hw[0], canvas_hw[1],
                dtype=_blob_dtype(cfg_az), src_hw=hw, scale=s,
            )
            feat = az_model.apply(az_p, blob[None], method="features")[0]
            # Each net quantizes at ITS calibrated conv5_3 scale (the int8
            # fc6 dequants with the same constant); XLA CSEs the two passes
            # when the scales agree.
            feat_az = _maybe_quantize_feat(cfg_az, feat)
            feat_fr = _maybe_quantize_feat(cfg_fr, feat)

            def roi_fwd(f, r):
                return az_model.apply(az_p, f, r, method="roi_forward")

            boxes, p_scores, valid = az_search(
                roi_fwd, feat_az, (vh, vw), cfg_az.SEAR,
                num_templates=cfg_az.MODEL.NUM_TEMPLATES,
                offset=cfg_az.BOX_OFFSET,
            )
            # boxes are scaled-image coords == the FRCNN rois directly.
            fr_p = _cast_inference_params(fr_params, cfg_fr)
            orig = boxes / im_scale
            n_iter = max(int(cfg_fr.TEST.BBOX_ITER), 1)
            cur = boxes  # scaled-image coords
            for it in range(n_iter):  # iterative regression, as _detect_core
                out = frcnn_model.apply(fr_p, feat_fr, cur,
                                        method="roi_forward")
                det_scores = jax.nn.softmax(out["cls_score"], axis=-1)
                pred = bbox_transform_inv(cur / im_scale, out["bbox_pred"],
                                          cfg_fr.BOX_OFFSET)
                pred = clip_boxes(pred, (hw[0], hw[1]), cfg_fr.BOX_OFFSET)
                if it + 1 < n_iter:
                    cur = select_class_boxes(det_scores, pred) * im_scale
            return orig, p_scores, valid, det_scores, pred

        return jax.vmap(one)(images, src_hw, scales)

    return fn


def make_detect_batch(model, cfg: Config, canvas_hw):
    """Returns a jittable ``(params, images, boxes [B,R,4]) -> (scores,
    pred_boxes)`` batched detection forward."""

    def fn(params, images, boxes):
        def one(image, b):
            return _detect_core(model, params, cfg, image, b, canvas_hw)

        return jax.vmap(one)(images, boxes)

    return fn


def make_detect_batch_padded(model, cfg: Config, canvas_hw):
    """Batched detect over ZERO-PADDED raw images: ``(params,
    images [B,Hp,Wp,3], src_hw [B,2], scales [B], boxes [B,R,4]) ->
    (scores, pred_boxes)`` — one compiled program per canvas bucket (the
    batched-eval analogue of make_propose_batch_padded)."""

    def fn(params, images, src_hw, scales, boxes):
        def one(image, hw, s, b):
            return _detect_core(model, params, cfg, image, b, canvas_hw,
                                src_hw=hw, scale=s)

        return jax.vmap(one)(images, src_hw, scales, boxes)

    return fn
