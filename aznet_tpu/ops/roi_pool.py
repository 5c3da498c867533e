"""ROI feature extraction: Caffe-exact max pooling + matmul-form ROI align.

Reference equivalent (SURVEY.md §2.3): the fork-added CUDA ROIPooling layer
``caffe-fast-rcnn/src/caffe/layers/roi_pooling_layer.{cpp,cu}`` — max-pool
each ROI into a fixed ``pool x pool`` grid from the conv feature map at
``spatial_scale = 1/16``, with integer floor/ceil rounding of sub-bin
boundaries.

Two implementations behind ``roi_pool(mode=...)``:

- :func:`roi_pool_caffe` ('caffe_max') — bit-parity semantics (round/
  floor/ceil via exact integer bin boundaries, empty bins produce 0) as
  vectorized gathers with a static per-bin window bound.
- :func:`roi_align` ('align', the default) — bilinear crop-and-resize with
  average pooling, expressed as separable bilinear-weight matmuls.
  This is what we train and search with.

Both are pure jnp (jit/vmap/grad-safe where applicable).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp


def _chunked_over_rois(fn, rois, chunk: int):
    """Apply ``fn(rois_chunk)`` over roi chunks via lax.map (bounds memory).

    chunk is clamped to the roi count (padding 64 rois to a 256 chunk would
    quadruple the pooling work), and the single-chunk case skips lax.map.
    """
    r = rois.shape[0]
    chunk = min(chunk, max(r, 1))
    if r <= chunk:
        return fn(rois)
    pad = (-r) % chunk
    padded = jnp.pad(rois, ((0, pad), (0, 0)))
    batches = padded.reshape(-1, chunk, rois.shape[1])
    out = jax.lax.map(fn, batches)
    return out.reshape((-1,) + out.shape[2:])[:r]


def roi_pool_caffe(feat, rois, spatial_scale: float, pool_size: int = 7,
                   chunk: int = 32):
    """Caffe ROIPooling forward parity.

    ``feat``: [H, W, C] conv features. ``rois``: [R, 4] boxes in IMAGE
    coordinates ``[x1, y1, x2, y2]``. Returns [R, pool, pool, C].

    Semantics (roi_pooling_layer.cpp): round roi coords to the feature grid;
    ``roi_w = max(x2 - x1 + 1, 1)``; bin boundaries ``floor(p * bin)`` /
    ``ceil((p+1) * bin)`` offset by roi start, clipped to the map; empty bins
    output 0; max over the bin.
    """
    h, w, c = feat.shape
    p = pool_size
    # Static per-bin window bound. Bin boundaries are floor/ceil of a bin of
    # size roi_h/p, so a bin spans at most roi_h/p + 2 rows; roi coords are
    # clipped to the image so roi_h <= H + 1 after rounding.
    mbh = -(-(h + 1) // p) + 2
    mbw = -(-(w + 1) // p) + 2

    def one_chunk(rchunk):
        # C round() = half away from zero (coords are non-negative here);
        # Caffe does all bin arithmetic in float32 — parity requires both.
        x1 = jnp.floor(rchunk[:, 0] * spatial_scale + 0.5).astype(jnp.int32)
        y1 = jnp.floor(rchunk[:, 1] * spatial_scale + 0.5).astype(jnp.int32)
        x2 = jnp.floor(rchunk[:, 2] * spatial_scale + 0.5).astype(jnp.int32)
        y2 = jnp.floor(rchunk[:, 3] * spatial_scale + 0.5).astype(jnp.int32)
        roi_h = jnp.maximum(y2 - y1 + 1, 1)  # int32
        roi_w = jnp.maximum(x2 - x1 + 1, 1)
        # Exact rational bin boundaries in INTEGER arithmetic:
        #   floor(ph * roi/p)   = (ph * roi) // p
        #   ceil((ph+1)*roi/p)  = -((-(ph+1) * roi) // p)
        # Caffe computes these in float32; XLA rewrites /p into *(1/p) and can
        # form fmas, so the float path is compiler-dependent (observed: an
        # off-by-one ceil under jit). Integer arithmetic is the mathematical
        # intent of the Caffe code and deterministic everywhere; it deviates
        # from Caffe's float realization only where float rounding error
        # crosses an integer boundary.
        ps = jnp.arange(p, dtype=jnp.int32)
        ps1 = jnp.arange(1, p + 1, dtype=jnp.int32)
        hstart = (ps[None, :] * roi_h[:, None]) // p + y1[:, None]
        hend = -((-ps1[None, :] * roi_h[:, None]) // p) + y1[:, None]
        wstart = (ps[None, :] * roi_w[:, None]) // p + x1[:, None]
        wend = -((-ps1[None, :] * roi_w[:, None]) // p) + x1[:, None]
        hstart = jnp.clip(hstart, 0, h)
        hend = jnp.clip(hend, 0, h)
        wstart = jnp.clip(wstart, 0, w)
        wend = jnp.clip(wend, 0, w)

        offs_h = jnp.arange(mbh, dtype=jnp.int32)
        offs_w = jnp.arange(mbw, dtype=jnp.int32)
        hidx = hstart[..., None] + offs_h  # [R, p, mbh]
        widx = wstart[..., None] + offs_w  # [R, p, mbw]
        hvalid = hidx < hend[..., None]
        wvalid = widx < wend[..., None]
        hidx = jnp.clip(hidx, 0, h - 1)
        widx = jnp.clip(widx, 0, w - 1)

        # Gather [R, ph, pw, mbh, mbw, C] and masked-max the window.
        yy = hidx[:, :, None, :, None]
        xx = widx[:, None, :, None, :]
        vals = feat[yy, xx]
        mask = (hvalid[:, :, None, :, None] & wvalid[:, None, :, None, :])[..., None]
        neg = jnp.asarray(-jnp.inf, feat.dtype)
        pooled = jnp.max(jnp.where(mask, vals, neg), axis=(3, 4))
        # Empty bins (hend<=hstart or wend<=wstart) -> 0, as in Caffe.
        any_valid = jnp.any(mask, axis=(3, 4))
        return jnp.where(any_valid, pooled, 0.0)

    return _chunked_over_rois(one_chunk, rois, chunk)


def _bilinear_pool_weights(lo, size, extent: int, pool: int, sampling: int):
    """Per-roi separable interpolation-and-average weights.

    For each output bin p (of ``pool``), average ``sampling`` bilinear
    samples along one axis. Returns [R, pool, extent] weights such that
    ``out = W @ feat_axis`` — each row sums to 1.

    This is the matmul formulation of ROI align: a bilinear sample at position
    y has axis weights ``relu(1 - |y - h|)`` over the integer grid h, so
    sampling + averaging collapse into one small dense matrix per roi and
    the pooling becomes two matmuls instead of dynamic gathers. Whether a
    gather form wins on the GPU is open (ROADMAP S4).
    """
    n = pool * sampling
    grid = (jnp.arange(n, dtype=jnp.float32) + 0.5) / n  # (0,1) sample centers
    pos = lo[:, None] + grid[None, :] * size[:, None]  # [R, n]
    pos = jnp.clip(pos, 0.0, extent - 1.0)
    cells = jnp.arange(extent, dtype=jnp.float32)  # [extent]
    w = jnp.maximum(1.0 - jnp.abs(pos[:, :, None] - cells[None, None, :]), 0.0)
    # Clipped positions at the borders still sum to 1 (weight 1 on the edge
    # cell); average the `sampling` sample rows per bin.
    r = lo.shape[0]
    return w.reshape(r, pool, sampling, extent).mean(axis=2)


def _contract_w_first(h: int, w: int, c: int, itemsize: int,
                      override) -> bool:
    """Pick the separable-contraction order that minimizes the staged
    intermediate. Contracting H first stages [R, p, W, C]; W first stages
    [R, q, H, C] — on big feature maps that intermediate is pure HBM
    traffic between two matmuls XLA cannot fuse (at ResNet-50@1088x1920,
    stride 16, C=1024 it is 220 vs 124 MB per 128-roi level — DESIGN.md
    round-4). Only kicks in when the map is large (> 8 MB): small maps
    keep the historical H-first order."""
    if override is not None:
        return bool(override)
    env = os.environ.get("AZNET_ROI_WFIRST")  # pipeline A/B knob
    if env is not None:
        return env != "0"
    return w > h and h * w * c * itemsize > 8 * 1024 * 1024


def roi_align(feat, rois, spatial_scale: float, pool_size: int = 7,
              sampling: int = 2, chunk: int = 256, offset: float = 0.0,
              w_first=None):
    """ROI align: bilinear crop-and-resize + average pooling (matmul form).

    ``feat``: [H, W, C]; ``rois``: [R, 4] image coords. Returns
    [R, pool, pool, C]. No coordinate rounding (continuous), ``sampling^2``
    bilinear samples per bin, averaged. ``offset=0.5`` gives the half-pixel
    ("aligned=True") variant; 0.0 matches the original Mask-R-CNN op.

    Implementation: separable interpolation expressed as two einsum
    contractions against small per-roi weight matrices — the whole op runs
    as matmuls with zero gathers (see _bilinear_pool_weights). Contraction
    order picks the smaller staged intermediate (``w_first=None`` — see
    _contract_w_first; pass True/False to pin it).
    """
    h, w, c = feat.shape
    p = pool_size
    wf = _contract_w_first(h, w, c, jnp.dtype(feat.dtype).itemsize, w_first)

    def one_chunk(rchunk):
        x1 = rchunk[:, 0] * spatial_scale - offset
        y1 = rchunk[:, 1] * spatial_scale - offset
        x2 = rchunk[:, 2] * spatial_scale - offset
        y2 = rchunk[:, 3] * spatial_scale - offset
        roi_w = jnp.maximum(x2 - x1, 1.0)
        roi_h = jnp.maximum(y2 - y1, 1.0)
        wy = _bilinear_pool_weights(y1, roi_h, h, p, sampling)  # [R, p, H]
        wx = _bilinear_pool_weights(x1, roi_w, w, p, sampling)  # [R, p, W]
        wy = wy.astype(feat.dtype)
        wx = wx.astype(feat.dtype)
        if wf:
            cols = jnp.einsum("rqw,hwc->rqhc", wx, feat,
                              preferred_element_type=jnp.float32)
            pooled = jnp.einsum("rph,rqhc->rpqc", wy,
                                cols.astype(feat.dtype),
                                preferred_element_type=jnp.float32)
        else:
            rows = jnp.einsum("rph,hwc->rpwc", wy, feat,
                              preferred_element_type=jnp.float32)
            pooled = jnp.einsum("rqw,rpwc->rpqc", wx, rows.astype(feat.dtype),
                                preferred_element_type=jnp.float32)
        return pooled.astype(feat.dtype)

    return _chunked_over_rois(one_chunk, rois, chunk)


def roi_align_int8(feat8, rois, spatial_scale: float, pool_size: int = 7,
                   sampling: int = 2, chunk: int = 256, offset: float = 0.0,
                   w_first=None):
    """ROI align over ALREADY-QUANTIZED int8 features -> int8 pooled.

    ``feat8``: [H, W, C] int8 activations (symmetric, zero-point 0 — the
    ops/conv_int8 scheme; quantize with the calibrated conv5_3 scale,
    ``cfg.MODEL.INT8_HEAD_SCALES[0]``). Returns int8 [R, pool, pool, C] in
    the SAME units/scale as ``feat8``: roi align is a convex combination
    per output element (each weight row sums to 1), so |pooled| <= 127 and
    the scale is preserved — the int8 fc6 can consume the result directly
    with its calibrated ``s_in``, skipping the bf16 dequant->requant round
    trip of the default path.

    Compute shape: the row contraction ``[R*p, H] x [H, W*C]`` is the hot
    einsum of the search head's pooling; int8 GEMMs run at twice the bf16
    rate, so quantizing both operands can halve the dominant term (whether
    it pays on the H100 is ROADMAP S2). The
    interpolation weights are non-negative and <= 1, so ``round(w * 127)``
    keys them into 7 bits with <= 0.4% per-weight error — below the 1/254
    granularity the int8 fc6 input quantization imposes anyway. The second
    (7x smaller) contraction stays bf16.

    Reference equivalent: none — the reference's ROIPooling is f32 CUDA
    (SURVEY.md §2.3; mount empty). Not in the reference; inference-only.
    """
    h, w, c = feat8.shape
    p = pool_size
    assert feat8.dtype == jnp.int8, "roi_align_int8 wants int8 features"
    wf = _contract_w_first(h, w, c, 1, w_first)

    def one_chunk(rchunk):
        x1 = rchunk[:, 0] * spatial_scale - offset
        y1 = rchunk[:, 1] * spatial_scale - offset
        x2 = rchunk[:, 2] * spatial_scale - offset
        y2 = rchunk[:, 3] * spatial_scale - offset
        roi_w = jnp.maximum(x2 - x1, 1.0)
        roi_h = jnp.maximum(y2 - y1, 1.0)
        wy = _bilinear_pool_weights(y1, roi_h, h, p, sampling)  # [R, p, H]
        wx = _bilinear_pool_weights(x1, roi_w, w, p, sampling)  # [R, p, W]
        # Hot (feature-operand) contraction as an int8 GEMM: int32
        # accumulate, units of feat8/127 (the int8 weight carries the
        # x127). The axis-order heuristic applies as in roi_align.
        if wf:
            wx8 = jnp.round(wx * 127.0).astype(jnp.int8)
            cols = jnp.einsum("rqw,hwc->rqhc", wx8, feat8,
                              preferred_element_type=jnp.int32)
            cols = (cols.astype(jnp.float32)
                    * (1.0 / 127.0)).astype(jnp.bfloat16)
            pooled = jnp.einsum("rph,rqhc->rpqc", wy.astype(jnp.bfloat16),
                                cols, preferred_element_type=jnp.float32)
        else:
            wy8 = jnp.round(wy * 127.0).astype(jnp.int8)
            rows = jnp.einsum("rph,hwc->rpwc", wy8, feat8,
                              preferred_element_type=jnp.int32)
            rows = (rows.astype(jnp.float32)
                    * (1.0 / 127.0)).astype(jnp.bfloat16)
            pooled = jnp.einsum("rqw,rpwc->rpqc", wx.astype(jnp.bfloat16),
                                rows, preferred_element_type=jnp.float32)
        # Convexity bounds |pooled| by max|feat8| up to the ~0.4% weight
        # quantization slack; the clip covers that slack at the rails.
        pooled = jnp.clip(jnp.round(pooled), -127.0, 127.0)
        return pooled.astype(jnp.int8)

    return _chunked_over_rois(one_chunk, rois, chunk)


def roi_pool(feat, rois, spatial_scale: float, pool_size: int = 7,
             mode: str = "align", **kw):
    """Dispatch on cfg.MODEL.POOLING_MODE: 'align' (XLA separable matmuls,
    the default; on larger maps it switches to the w-first contraction
    order, _contract_w_first — pinned by tests/test_roi_pool.py::
    test_align_contraction_order_equivalence), 'caffe_max' (reference
    ROIPooling parity).

    int8 features select the int8 GEMM path (:func:`roi_align_int8`,
    'align' mode only) and return int8 pooled in the same scale."""
    if feat.dtype == jnp.int8:
        if mode != "align":
            raise ValueError(
                f"int8 features need POOLING_MODE 'align', got {mode!r}")
        return roi_align_int8(feat, rois, spatial_scale, pool_size, **kw)
    if mode == "align":
        return roi_align(feat, rois, spatial_scale, pool_size, **kw)
    if mode == "caffe_max":
        return roi_pool_caffe(feat, rois, spatial_scale, pool_size, **kw)
    raise ValueError(f"unknown pooling mode: {mode}")


def roi_pool_caffe_reference_np(feat, rois, spatial_scale, pool_size=7):
    """Direct NumPy transcription of roi_pooling_layer.cpp (test oracle)."""
    import numpy as np

    h, w, c = feat.shape
    f32 = np.float32
    out = np.zeros((rois.shape[0], pool_size, pool_size, c), np.float32)
    for r in range(rois.shape[0]):
        # C round() semantics + float32 bin arithmetic, as in the CUDA/CPP layer.
        x1 = int(np.floor(f32(rois[r, 0]) * f32(spatial_scale) + f32(0.5)))
        y1 = int(np.floor(f32(rois[r, 1]) * f32(spatial_scale) + f32(0.5)))
        x2 = int(np.floor(f32(rois[r, 2]) * f32(spatial_scale) + f32(0.5)))
        y2 = int(np.floor(f32(rois[r, 3]) * f32(spatial_scale) + f32(0.5)))
        roi_h = max(y2 - y1 + 1, 1)
        roi_w = max(x2 - x1 + 1, 1)
        p = pool_size
        for ph in range(pool_size):
            for pw in range(pool_size):
                # Exact rational boundaries (see roi_pool_caffe for rationale).
                hs = min(max((ph * roi_h) // p + y1, 0), h)
                he = min(max(-((-(ph + 1) * roi_h) // p) + y1, 0), h)
                ws = min(max((pw * roi_w) // p + x1, 0), w)
                we = min(max(-((-(pw + 1) * roi_w) // p) + x1, 0), w)
                if he <= hs or we <= ws:
                    continue
                out[r, ph, pw] = feat[hs:he, ws:we].reshape(-1, c).max(axis=0)
    return out
