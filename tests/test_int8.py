"""Int8 conv-as-GEMM path: exactness, quantization error, trunk parity."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aznet_tpu.ops.conv_int8 import (
    conv3x3_f32_reference,
    conv3x3_int8,
    quantize_acts,
    quantize_weights,
)


def test_conv3x3_int8_exact_on_integer_grid():
    """With integer-valued activations/weights in range and unit scales,
    the int8 GEMM must reproduce the f32 conv EXACTLY (int32 accumulate)."""
    rng = np.random.RandomState(0)
    x = rng.randint(-5, 6, (2, 12, 16, 8)).astype(np.float32)
    w = rng.randint(-3, 4, (3, 3, 8, 16)).astype(np.float32)
    b = rng.randint(-2, 3, (16,)).astype(np.float32)

    # Unit scales: quantization is the identity on these grids.
    w_q = jnp.asarray(w.reshape(3, 3 * 8, 16), jnp.int8)
    s_w = jnp.ones((16,), jnp.float32)
    y = conv3x3_int8(jnp.asarray(x, jnp.int8), 1.0, w_q, s_w,
                     jnp.asarray(b), out_dtype=jnp.float32)
    ref = conv3x3_f32_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(y), np.asarray(ref))


def test_weight_pack_layout_matches_dx_concat():
    """quantize_weights' [dy, dx*C, Co] flatten must match dx_pack order."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (1, 8, 8, 4)).astype(np.float32)
    w = rng.uniform(-1, 1, (3, 3, 4, 8)).astype(np.float32)
    b = np.zeros((8,), np.float32)
    w_q, s_w = quantize_weights(jnp.asarray(w))
    s_x = float(np.abs(x).max() / 127.0)
    y = conv3x3_int8(quantize_acts(jnp.asarray(x), s_x), s_x, w_q, s_w,
                     jnp.asarray(b), out_dtype=jnp.float32)
    ref = conv3x3_f32_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    # Only quantization noise separates them; a layout bug would be O(1).
    err = np.abs(np.asarray(y) - np.asarray(ref)).max()
    assert err < 0.05, err


def test_conv3x3_int8_quantization_error_bounded():
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 2.0, (2, 16, 16, 16)).astype(np.float32)
    w = (rng.randn(3, 3, 16, 32) * 0.1).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (32,)).astype(np.float32)
    w_q, s_w = quantize_weights(jnp.asarray(w))
    s_x = float(x.max() / 127.0)
    ref = np.asarray(conv3x3_f32_reference(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b)))
    y = np.asarray(conv3x3_int8(quantize_acts(jnp.asarray(x), s_x), s_x,
                                w_q, s_w, jnp.asarray(b),
                                out_dtype=jnp.float32))
    rel = np.abs(y - ref).max() / max(ref.max(), 1e-6)
    assert rel < 0.02, rel
    # Requantized output path: round-trips through int8 with s_out.
    s_out = float(ref.max() / 127.0)
    y8 = np.asarray(conv3x3_int8(quantize_acts(jnp.asarray(x), s_x), s_x,
                                 w_q, s_w, jnp.asarray(b), s_out=s_out))
    assert y8.dtype == np.int8
    rel8 = np.abs(y8.astype(np.float32) * s_out - ref).max() / ref.max()
    assert rel8 < 0.03, rel8


def test_int8_trunk_matches_f32_features():
    """Calibrate -> int8 trunk; features must closely track the f32 trunk."""
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu.ops.quant import (CONV_NAMES, calibrate_trunk_int8,
                                     with_int8_scales)

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": 32,
                  "COMPUTE_DTYPE": "float32"}})
    net = build_az_net(cfg)
    rng = np.random.RandomState(0)
    images = rng.uniform(-120, 120, (2, 64, 64, 3)).astype(np.float32)

    scales = calibrate_trunk_int8(net, images)
    assert len(scales) == len(CONV_NAMES) == 13
    assert all(s > 0 for s in scales)

    cfg8 = with_int8_scales(cfg, scales)
    net8 = build_az_net(cfg8, params=net.params)
    ref = np.asarray(net.model.apply(net.params, jnp.asarray(images),
                                     method="features"), np.float32)
    out = np.asarray(net8.model.apply(net8.params, jnp.asarray(images),
                                      method="features"), np.float32)
    assert out.shape == ref.shape
    # Quantization noise accumulates over 13 layers; demand high cosine
    # similarity and bounded relative energy error, not elementwise match.
    cos = (out * ref).sum() / max(np.linalg.norm(out) * np.linalg.norm(ref),
                                  1e-9)
    assert cos > 0.98, cos
    rel = np.abs(out - ref).mean() / max(np.abs(ref).mean(), 1e-9)
    assert rel < 0.2, rel


def test_int8_requires_scales():
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": 32,
                  "COMPUTE_DTYPE": "int8"}})
    net = build_az_net(cfg)  # init itself runs the normal (bf16) path
    with pytest.raises(ValueError, match="INT8_SCALES"):
        net.model.apply(net.params, jnp.zeros((1, 64, 64, 3)),
                        method="features")


def test_int8_heads_match_f32_roi_forward():
    """int8 fc6/fc7 stack tracks the f32 head closely on the same rois."""
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu.ops.quant import (calibrate_head_int8,
                                     calibrate_trunk_int8, with_int8_scales)

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": 64,
                  "NUM_TEMPLATES": 5, "COMPUTE_DTYPE": "float32",
                  "DROPOUT": 0.0}})
    net = build_az_net(cfg)
    rng = np.random.RandomState(3)
    images = rng.uniform(-120, 120, (2, 64, 64, 3)).astype(np.float32)
    scales = calibrate_trunk_int8(net, images)
    head_scales = calibrate_head_int8(net, images, scales)
    assert len(head_scales) == 2 and all(s > 0 for s in head_scales)

    net8 = build_az_net(with_int8_scales(cfg, scales, head_scales),
                        params=net.params)
    feat = net.model.apply(net.params, jnp.asarray(images[:1]),
                           method="features")[0]
    feat8 = net8.model.apply(net8.params, jnp.asarray(images[:1]),
                             method="features")[0]
    rois = jnp.asarray([[0.0, 0.0, 31.0, 31.0], [8.0, 8.0, 55.0, 47.0]])
    ref = net.model.apply(net.params, feat, rois, method="roi_forward")
    out = net8.model.apply(net8.params, feat8, rois, method="roi_forward")
    for k in ("zoom", "adj_score"):
        a, b = np.asarray(ref[k], np.float32), np.asarray(out[k], np.float32)
        # logits: compare on a sigmoid-ish scale
        assert np.abs(1 / (1 + np.exp(-a)) - 1 / (1 + np.exp(-b))).max() < 0.1
