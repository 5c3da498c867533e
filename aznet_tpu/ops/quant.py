"""Post-training int8 calibration for the VGG trunk.

Runs the bf16 trunk on calibration images, reads every conv layer's
pre-ReLU output (the trunk's calibration taps), and derives one static
symmetric scale per layer from the post-ReLU absolute-max (optionally a
percentile, which clips rare outliers for tighter quantization grids).

The scales are *model configuration*, not weights: they return as a plain
tuple for ``cfg.MODEL.INT8_SCALES`` (static under jit, baked into the
compiled program as constants), so checkpoints are untouched and the int8
net is a pure config swap:

    scales = calibrate_trunk_int8(net, images)
    cfg8 = with_int8_scales(net.cfg, scales)
    net8 = build_az_net(cfg8, params=net.params)

Reference equivalent: none — the reference (Caffe VGG-16, SURVEY.md §2.1)
has no quantized inference path (DESIGN.md finding 10).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import jax.numpy as jnp

from aznet_tpu.config import Config
from aznet_tpu.models.vgg import CONV_NAMES


def calibrate_trunk_int8(net, images, percentile: float = 100.0,
                         batch_size: int = 4) -> tuple:
    """Derive per-layer activation scales from calibration images.

    net: a bf16/f32 ``Net`` (``build_az_net``/``build_frcnn_net``) whose
    trunk is vgg16. images: [N, H, W, 3] preprocessed blobs (BGR, mean-
    subtracted) — a handful of representative images suffices.
    Returns a tuple of len(CONV_NAMES) floats (conv5_3's is recorded for
    diagnostics; the trunk never requantizes its output).
    """
    if net.cfg.MODEL.COMPUTE_DTYPE == "int8":
        raise ValueError("calibrate with a bfloat16/float32 net, not int8")
    import jax

    images = np.asarray(images, np.float32)
    maxes = {n: 0.0 for n in CONV_NAMES}

    # taps = pre-ReLU conv outputs; the quantized tensor is post-ReLU, so
    # only the positive side sets the scale.
    def relu_taps(params, chunk):
        taps = net.model.apply(params, chunk, method="trunk_taps")
        return {n: jnp.maximum(taps[n].astype(jnp.float32), 0.0)
                for n in CONV_NAMES}

    @jax.jit
    def captured_max(params, chunk):
        return {n: jnp.max(t) for n, t in relu_taps(params, chunk).items()}

    use_pct = percentile < 100.0
    for start in range(0, images.shape[0], batch_size):
        chunk = jnp.asarray(images[start : start + batch_size])
        if use_pct:
            taps = jax.device_get(jax.jit(relu_taps)(net.params, chunk))
            for name in CONV_NAMES:
                maxes[name] = max(maxes[name], float(
                    np.percentile(np.asarray(taps[name]), percentile)))
        else:
            m = jax.device_get(captured_max(net.params, chunk))
            for name in CONV_NAMES:
                maxes[name] = max(maxes[name], float(m[name]))
    return tuple(max(maxes[n], 1e-6) / 127.0 for n in CONV_NAMES)


def calibrate_trunk_int8_resnet(net, images, batch_size: int = 2) -> tuple:
    """Activation scales for the int8 ResNet-50 bottleneck 1x1 GEMMs.

    Runs the bf16 trunk and reads the ``qin_absmax`` / ``qmid_absmax``
    taps of each bottleneck (models/resnet.py): the block input (feeds
    conv1 + downsample) and the post-bn2-ReLU mid activation (feeds
    conv3). Returns 2 floats per block in block-definition order, plus a
    trailing trunk-OUTPUT scale — the layout ``MODEL.INT8_SCALES``
    expects for the resnet50 backbone (the model ignores the extra
    trailing entry; ``calibrate_head_int8`` reads it as
    ``trunk_scales[-1]``, the pooled-feature scale).
    """
    if net.cfg.MODEL.COMPUTE_DTYPE == "int8":
        raise ValueError("calibrate with a bfloat16/float32 net, not int8")
    import jax

    block_names = [name for name, _, _ in net.model.trunk._blocks()]
    sown_maxes = jax.jit(
        lambda params, chunk: net.model.apply(params, chunk,
                                              method="trunk_taps"))

    images = np.asarray(images, np.float32)
    maxes = {n: [0.0, 0.0] for n in block_names}
    out_max = 0.0
    for start in range(0, images.shape[0], batch_size):
        chunk = jnp.asarray(images[start : start + batch_size])
        taps = jax.device_get(sown_maxes(net.params, chunk))
        out_max = max(out_max, float(taps["qout_absmax"]))
        for name in block_names:
            maxes[name][0] = max(maxes[name][0],
                                 float(taps[name]["qin_absmax"]))
            maxes[name][1] = max(maxes[name][1],
                                 float(taps[name]["qmid_absmax"]))
    per_block = [max(v, 1e-6) / 127.0
                 for name in block_names for v in maxes[name]]
    return tuple(per_block + [max(out_max, 1e-6) / 127.0])


def calibrate_head_int8(net, images, trunk_scales, batch_size: int = 2):
    """(s_in, s_mid) for the int8 fc6/fc7 stack.

    s_in = the trunk output (conv5_3) scale — roi_align is a convex
    combination so pooled features share its range. s_mid = calibrated
    fc6 post-ReLU absmax over division-tree rois of the calib images.
    """
    import jax

    images = np.asarray(images, np.float32)
    h, w = images.shape[1:3]
    from aznet_tpu.train.labels import division_tree_regions

    rois = jnp.asarray(division_tree_regions((h, w), 2,
                                             offset=net.cfg.BOX_OFFSET))

    @jax.jit
    def fc6_max(params, chunk):
        def one(feat):
            y = net.model.apply(params, feat, rois, method="fc6_preact")
            return jnp.max(jnp.maximum(y.astype(jnp.float32), 0.0))

        feats = net.model.apply(params, chunk, method="features")
        return jnp.max(jax.vmap(one)(feats))

    m = 0.0
    for start in range(0, images.shape[0], batch_size):
        chunk = jnp.asarray(images[start : start + batch_size])
        m = max(m, float(jax.device_get(fc6_max(net.params, chunk))))
    return (float(trunk_scales[-1]), max(m, 1e-6) / 127.0)


def calibrate_net_on_imdb(net, imdb, n_images: int = 8,
                          percentile: float = 100.0, int8_heads: bool = True):
    """Calibrate on real imdb images (TEST-scale blobs) and return the
    int8 net: ``build`` is re-invoked with the scale-carrying config and
    the SAME params. vgg16 trunks only; ``int8_heads`` also quantizes the
    fc6/fc7 stack."""
    from aznet_tpu.ops.preprocess import prep_im_for_blob, im_list_to_blob

    cfg = net.cfg
    if cfg.MODEL.BACKBONE != "vgg16":
        raise ValueError("int8 calibration supports the vgg16 trunk only")
    ims = []
    n = min(n_images, imdb.num_images)
    for i in range(n):
        im = imdb.image_array(imdb.roidb[i])
        blob, _ = prep_im_for_blob(im, cfg.PIXEL_MEANS, cfg.TEST.SCALES[0],
                                   cfg.TEST.MAX_SIZE)
        ims.append(blob)
    images = im_list_to_blob(ims)
    scales = calibrate_trunk_int8(net, images, percentile=percentile,
                                  batch_size=2)
    head_scales = (calibrate_head_int8(net, images, scales)
                   if int8_heads else ())
    from aznet_tpu.api import build_az_net, build_frcnn_net
    from aznet_tpu.models import AZNet

    builder = build_az_net if isinstance(net.model, AZNet) else build_frcnn_net
    return builder(with_int8_scales(cfg, scales, head_scales),
                   params=net.params)


def with_int8_scales(cfg: Config, scales: Sequence[float],
                     head_scales: Sequence[float] = ()) -> Config:
    """cfg with COMPUTE_DTYPE='int8' and the given trunk (+head) scales."""
    model = dataclasses.replace(
        cfg.MODEL, COMPUTE_DTYPE="int8",
        INT8_SCALES=tuple(float(s) for s in scales),
        INT8_HEAD_SCALES=tuple(float(s) for s in head_scales))
    return dataclasses.replace(cfg, MODEL=model)
