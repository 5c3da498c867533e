"""Image preprocessing: fused resize + mean-subtract, static-shape batching.

Reference equivalents (SURVEY.md §2.2): ``lib/utils/blob.py`` —
``prep_im_for_blob`` (float32, subtract BGR pixel means, cv2 bilinear resize
so the shortest side hits ``target_size`` capped by ``max_size``) and
``im_list_to_blob`` (pad to the batch max). The reference does this per-image
on host with OpenCV; here the resize + mean-subtract is a single fused,
jit-able gather computation with a *static* output canvas and a *dynamic*
per-image scale — the static-shape answer to variable image sizes (XLA needs
static shapes; the scale is data, the canvas is shape).

Convention: images are HWC **BGR** float32 (matching Caffe's cv2.imread
layout and the exact pixel means ``(102.9801, 115.9465, 122.7717)``).
Bilinear sampling uses half-pixel centers, the same convention as
``cv2.resize(INTER_LINEAR)`` (modulo cv2's fixed-point rounding).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def compute_scale(h: int, w: int, target_size: int, max_size: int) -> float:
    """The reference's scale rule: shortest side -> target, capped by max_size."""
    im_size_min = min(h, w)
    im_size_max = max(h, w)
    scale = float(target_size) / float(im_size_min)
    if round(scale * im_size_max) > max_size:
        scale = float(max_size) / float(im_size_max)
    return scale


def resize_bilinear_scale(im, scale, out_h: int, out_w: int, pad_value=0.0,
                          compute_dtype=jnp.float32, src_hw=None):
    """Resize ``im [H, W, C]`` by dynamic ``scale`` onto a static canvas.

    Output pixel (y, x) samples input at ``(y + 0.5)/scale - 0.5`` (half-pixel
    centers, cv2/jax.image 'linear' convention); pixels beyond the scaled
    extent are ``pad_value``. Returns ``(canvas [out_h, out_w, C],
    valid_h, valid_w)`` where valid_* are the dynamic scaled extents.

    Fully jit-able: ``scale`` may be a traced scalar. ``src_hw``: optional
    dynamic true (h, w) when ``im`` itself is zero-padded to a static shape
    (batched path: one compiled program per canvas, not per raw size) —
    sample positions clip to the true extent, so pad rows/cols (whose
    triangle weight is then exactly 0) are never read.
    """
    hp, wp = im.shape[0], im.shape[1]
    if src_hw is None:
        h = jnp.float32(hp)
        w = jnp.float32(wp)
    else:
        h = jnp.asarray(src_hw[0], jnp.float32)
        w = jnp.asarray(src_hw[1], jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)
    valid_h = jnp.round(h * scale).astype(jnp.int32)
    valid_w = jnp.round(w * scale).astype(jnp.int32)

    # Separable bilinear interpolation as two dense matmuls instead of
    # gathers. Weight rows: triangle kernel
    # relu(1 - |src_pos - cell|); clipped positions keep row sums at 1.
    ys = jnp.clip((jnp.arange(out_h, dtype=jnp.float32) + 0.5) / scale - 0.5,
                  0.0, h - 1.0)
    xs = jnp.clip((jnp.arange(out_w, dtype=jnp.float32) + 0.5) / scale - 0.5,
                  0.0, w - 1.0)
    wy = jnp.maximum(1.0 - jnp.abs(ys[:, None] - jnp.arange(hp, dtype=jnp.float32)), 0.0)
    wx = jnp.maximum(1.0 - jnp.abs(xs[:, None] - jnp.arange(wp, dtype=jnp.float32)), 0.0)
    # Fold the validity mask into the weights (rows beyond the scaled extent
    # become all-zero -> output pad region is exactly pad_value).
    wy = (wy * (jnp.arange(out_h)[:, None] < valid_h)).astype(compute_dtype)
    wx = (wx * (jnp.arange(out_w)[:, None] < valid_w)).astype(compute_dtype)

    # compute_dtype=bfloat16 runs on the tensor cores at <1 pixel-value
    # error — the right default whenever the consuming trunk computes in
    # bf16 anyway.
    #
    # Layout: fold C into the non-contracted dim of each pass so both passes
    # are plain [M,K]x[K,N] matmuls with large N. The naive einsum
    # ("pw,owc->opc") forms degenerate N=C(=3) matmuls per output row —
    # measured 19x slower at VOC shapes.
    c = im.shape[2]
    im = im.astype(compute_dtype)
    rows = jnp.matmul(wy, im.reshape(hp, wp * c),
                      preferred_element_type=jnp.float32).astype(compute_dtype)
    rows = rows.reshape(out_h, wp, c).transpose(1, 0, 2).reshape(wp, out_h * c)
    out = jnp.matmul(wx, rows, preferred_element_type=jnp.float32)
    out = out.reshape(out_w, out_h, c).transpose(1, 0, 2)
    if pad_value:
        yy = jnp.arange(out_h)[:, None]
        xx = jnp.arange(out_w)[None, :]
        mask = (yy < valid_h) & (xx < valid_w)
        out = jnp.where(mask[..., None], out, pad_value)
    return out, valid_h, valid_w


def preprocess_image(im, pixel_means, target_size: int, max_size: int,
                     out_h: int, out_w: int, dtype=jnp.float32,
                     compute_dtype=None, src_hw=None, scale=None):
    """Fused prep_im_for_blob on device: mean-subtract + scale-resize + pad.

    ``im``: [H, W, 3] BGR (uint8 or float). Returns ``(blob [out_h, out_w, 3],
    im_scale, valid_hw)``. The canvas (out_h, out_w) is static; choose it from
    TEST.SCALES/MAX_SIZE via :func:`canvas_shape`. ``compute_dtype`` controls
    the resize matmul precision (defaults to ``dtype`` when that is bf16,
    else float32).

    Batched-padded path: when ``im`` is zero-padded to a static raw shape,
    pass the dynamic true ``src_hw`` (h, w) and the host-computed ``scale``
    (the scale rule needs true extents, which are data here, not shape).
    """
    if compute_dtype is None:
        compute_dtype = jnp.bfloat16 if dtype == jnp.bfloat16 else jnp.float32
    if scale is None:
        h, w = im.shape[0], im.shape[1]
        scale = jnp.asarray(compute_scale(h, w, target_size, max_size), jnp.float32)
    else:
        scale = jnp.asarray(scale, jnp.float32)
    means = jnp.asarray(pixel_means, dtype=jnp.float32)
    centered = im.astype(jnp.float32) - means
    out, vh, vw = resize_bilinear_scale(centered, scale, out_h, out_w,
                                        pad_value=0.0,
                                        compute_dtype=compute_dtype,
                                        src_hw=src_hw)
    return out.astype(dtype), scale, (vh, vw)


def canvas_shape(target_size: int, max_size: int, multiple: int = 32):
    """Static canvas large enough for any image at the reference scale rule."""
    def _round_up(v):
        return int(-(-v // multiple) * multiple)
    return _round_up(max(target_size, max_size)), _round_up(max(target_size, max_size))


# ---------------------------------------------------------------------------
# Host-side utilities (NumPy; parity with lib/utils/blob.py)
# ---------------------------------------------------------------------------


def prep_im_for_blob(im: np.ndarray, pixel_means, target_size: int, max_size: int):
    """Host parity version of the reference's ``prep_im_for_blob``.

    float32, subtract means, bilinear resize (half-pixel). Returns
    ``(im, im_scale)``. Uses cv2 when importable, else a NumPy bilinear
    matching :func:`resize_bilinear_scale`.
    """
    im = im.astype(np.float32, copy=False) - np.asarray(pixel_means, np.float32)
    scale = compute_scale(im.shape[0], im.shape[1], target_size, max_size)
    out_h = int(round(im.shape[0] * scale))
    out_w = int(round(im.shape[1] * scale))
    try:  # pragma: no cover - cv2 optional
        import cv2

        im = cv2.resize(im, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        im = _resize_bilinear_np(im, out_h, out_w)
    return im, scale


def _resize_bilinear_np(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    h, w = im.shape[:2]
    ys = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    xs = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    rows = im[y0] * (1 - fy) + im[y1] * fy
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx


def im_list_to_blob(ims: list) -> np.ndarray:
    """Pad a list of HWC float32 images to the batch max -> [N, H, W, C].

    NHWC (the layout the models use) where the reference produced NCHW.
    """
    max_shape = np.array([im.shape for im in ims]).max(axis=0)
    blob = np.zeros((len(ims), max_shape[0], max_shape[1], ims[0].shape[2]), np.float32)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1]] = im
    return blob
