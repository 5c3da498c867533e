"""int8 ROI align (ops/roi_pool.py::roi_align_int8): the search head's
pooling row-contraction as an int8 GEMM, pooled features fed to the int8
fc6 pre-quantized (no dequant->requant round trip).

Oracle strategy per repo convention (CLAUDE.md): exactness where the math
is exact (cell-aligned one-hot weights), bounded error vs the f32
roi_align elsewhere, and an end-to-end propose equivalence smoke.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from aznet_tpu.ops.roi_pool import roi_align, roi_align_int8, roi_pool


def _quantize(feat_f32, scale):
    q = np.clip(np.round(feat_f32 / scale), -127, 127)
    return q.astype(np.int8)


def test_cell_aligned_rois_tight_bound():
    # sampling=1 + 1-cell bins: each sample bilinear-blends two cells at
    # exactly 0.5/0.5. 0.5 is NOT representable in round(w*127)/127
    # (63.5 rounds to 64), so the int8 path deviates from the f32 align by
    # at most |64/127 - 0.5| * 2 * 127 = 1 unit per axis — a tight,
    # hand-derivable corner of the documented error budget.
    h, w, c = 12, 12, 8
    rng = np.random.RandomState(0)
    feat8 = rng.randint(-127, 128, (h, w, c)).astype(np.int8)
    rois = jnp.asarray([[2 * 16.0, 3 * 16.0, 6 * 16.0, 7 * 16.0]])
    out = np.asarray(roi_align_int8(jnp.asarray(feat8), rois, 1.0 / 16,
                                    pool_size=4, sampling=1))
    want = np.asarray(roi_align(jnp.asarray(feat8, jnp.float32).astype(
        jnp.float32), rois, 1.0 / 16, pool_size=4, sampling=1))
    assert out.shape == want.shape
    assert np.abs(out.astype(np.float32) - want).max() <= 2.0


def test_tracks_f32_roi_align_bounded():
    """Dequantized int8-align vs f32 align on the dequantized features:
    total error <= weight-quant + bf16-rows + final-round budget (~3 int8
    units; see the roi_align_int8 docstring)."""
    rng = np.random.RandomState(7)
    h, w, c = 38, 50, 64
    feat = rng.uniform(-1, 1, (h, w, c)).astype(np.float32) * 5.0
    scale = np.abs(feat).max() / 127.0
    feat8 = _quantize(feat, scale)
    feat_dq = feat8.astype(np.float32)  # f32 oracle in int8 units

    r = 64
    x1 = rng.uniform(0, (w - 4) * 16, r)
    y1 = rng.uniform(0, (h - 4) * 16, r)
    x2 = x1 + rng.uniform(16, w * 8, r)
    y2 = y1 + rng.uniform(16, h * 8, r)
    rois = jnp.asarray(np.stack([x1, y1, np.minimum(x2, w * 16 - 1),
                                 np.minimum(y2, h * 16 - 1)], 1),
                       jnp.float32)

    got = np.asarray(roi_align_int8(jnp.asarray(feat8), rois, 1.0 / 16, 7)
                     ).astype(np.float32)
    want = np.asarray(roi_align(jnp.asarray(feat_dq), rois, 1.0 / 16, 7))
    err = np.abs(got - want)
    assert err.max() <= 3.5, err.max()
    # and the overall agreement is tight
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.999


def test_convexity_keeps_range():
    # max-magnitude features everywhere -> pooled must stay in [-127, 127]
    # (clip covers the weight-quant slack at the rails, no wraparound).
    feat8 = np.full((10, 10, 4), 127, np.int8)
    rois = jnp.asarray([[0.0, 0.0, 150.0, 150.0]])
    out = np.asarray(roi_align_int8(jnp.asarray(feat8), rois, 1.0 / 16, 7))
    assert out.min() >= 120 and out.max() <= 127


def test_roi_pool_dispatch_int8():
    feat8 = jnp.zeros((8, 8, 4), jnp.int8)
    rois = jnp.asarray([[0.0, 0.0, 100.0, 100.0]])
    out = roi_pool(feat8, rois, 1.0 / 16, 7, mode="align")
    assert out.dtype == jnp.int8 and out.shape == (1, 7, 7, 4)
    with pytest.raises(ValueError, match="int8 features"):
        roi_pool(feat8, rois, 1.0 / 16, 7, mode="caffe_max")


def _int8_heads_net(rng, fc_dim=64):
    """f32 calibration net + bf16-trunk/int8-heads net (the int8_heads
    bench configuration) sharing params."""
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu.ops.quant import calibrate_head_int8, calibrate_trunk_int8
    import dataclasses

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": fc_dim,
                  "NUM_TEMPLATES": 5, "COMPUTE_DTYPE": "float32",
                  "DROPOUT": 0.0}})
    net = build_az_net(cfg)
    images = rng.uniform(-120, 120, (2, 64, 64, 3)).astype(np.float32)
    scales = calibrate_trunk_int8(net, images)
    head_scales = calibrate_head_int8(net, images, scales)
    cfg8 = dataclasses.replace(cfg, MODEL=dataclasses.replace(
        cfg.MODEL, COMPUTE_DTYPE="bfloat16",
        INT8_HEAD_SCALES=tuple(head_scales), INT8_ROI=True))
    net8 = build_az_net(cfg8, params=net.params)
    return net, net8, images


def test_int8_feat_head_matches_bf16_feat_head():
    """roi_forward(int8 feat) == roi_forward(bf16 feat) through the SAME
    int8-heads net, up to the pooling quantization (sigmoid scale)."""
    rng = np.random.RandomState(3)
    _, net8, images = _int8_heads_net(rng)
    s_in = net8.cfg.MODEL.INT8_HEAD_SCALES[0]

    feat = net8.model.apply(net8.params, jnp.asarray(images[:1]),
                            method="features")[0]
    feat8 = jnp.clip(jnp.round(feat.astype(jnp.float32) / s_in),
                     -127, 127).astype(jnp.int8)
    rois = jnp.asarray([[0.0, 0.0, 31.0, 31.0], [8.0, 8.0, 55.0, 47.0],
                        [4.0, 12.0, 60.0, 60.0]])
    ref = net8.model.apply(net8.params, feat, rois, method="roi_forward")
    out = net8.model.apply(net8.params, feat8, rois, method="roi_forward")
    for k in ("zoom", "adj_score"):
        a = 1 / (1 + np.exp(-np.asarray(ref[k], np.float32)))
        b = 1 / (1 + np.exp(-np.asarray(out[k], np.float32)))
        assert np.abs(a - b).max() < 0.1, (k, np.abs(a - b).max())


def test_im_propose_int8_roi_equivalence():
    """Full im_propose with INT8_ROI on vs off: same net, near-identical
    proposal sets (the pipeline-level guarantee the bench A/B rests on)."""
    import dataclasses

    from aznet_tpu.api import build_az_net, im_propose

    rng = np.random.RandomState(11)
    _, net8, _ = _int8_heads_net(rng)
    im = rng.randint(0, 256, (72, 96, 3)).astype(np.uint8)

    props8 = im_propose(net8, im)
    cfg_off = dataclasses.replace(net8.cfg, MODEL=dataclasses.replace(
        net8.cfg.MODEL, INT8_ROI=False))
    net_off = build_az_net(cfg_off, params=net8.params)
    props = im_propose(net_off, im)

    assert props8.shape[1] == 5 and np.isfinite(props8).all()
    # same candidate count and near-identical scores for the top boxes
    assert abs(len(props8) - len(props)) <= max(2, len(props) // 10)
    k = min(len(props8), len(props), 10)
    if k:
        assert np.abs(np.sort(props8[:, 4])[-k:]
                      - np.sort(props[:, 4])[-k:]).max() < 0.05


def test_non_int8_head_rejects_int8_pooled():
    """Guard: int8 pooled features reaching a head WITHOUT int8 scales is
    a wiring bug and must raise, not silently cast."""
    from aznet_tpu.models.heads import _FCStack

    stack = _FCStack(fc_dim=16, dropout=0.0)
    x = jnp.zeros((2, 3, 3, 4), jnp.float32)
    params = stack.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="int8 pooled"):
        stack.apply(params, jnp.zeros((2, 3, 3, 4), jnp.int8))
