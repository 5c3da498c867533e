"""ResNet-50 int8 path (bottleneck 1x1 GEMMs): exactness, calibration,
trunk parity, head compatibility.

VERDICT r3 weak #2: models/resnet.py's int8 path shipped with zero tests.
These mirror tests/test_int8.py's VGG patterns (the repo convention: every
compute-path variant gets a CPU test vs an oracle).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aznet_tpu.ops.conv_int8 import (
    conv1x1_int8,
    quantize_acts,
    quantize_weights_1x1,
)


def test_conv1x1_int8_exact_on_integer_grid():
    """Integer activations/weights with unit scales: the int8 GEMM must
    equal the f32 matmul EXACTLY (int32 accumulate, no epilogue)."""
    rng = np.random.RandomState(0)
    x = rng.randint(-5, 6, (2, 9, 11, 16)).astype(np.float32)
    w = rng.randint(-3, 4, (16, 32)).astype(np.float32)
    y = conv1x1_int8(jnp.asarray(x, jnp.int8), 1.0, jnp.asarray(w, jnp.int8),
                     jnp.ones((32,), jnp.float32), out_dtype=jnp.float32)
    ref = x.reshape(-1, 16) @ w
    np.testing.assert_array_equal(np.asarray(y).reshape(-1, 32), ref)


def test_conv1x1_module_int8_vs_f32_with_stride():
    """models/resnet.py::Conv1x1: the int8 path (s_in > 0) must track the
    f32 path within quantization noise, including the stride-2 subsample
    (1x1/SAME at stride s == sampling positions 0, s, 2s, ...)."""
    from aznet_tpu.models.resnet import Conv1x1

    rng = np.random.RandomState(1)
    x = rng.uniform(-2, 2, (2, 12, 14, 24)).astype(np.float32)
    s_in = float(np.abs(x).max() / 127.0)
    for stride in (1, 2):
        mod = Conv1x1(features=48, stride=stride, dtype=jnp.float32)
        params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        ref = np.asarray(mod.apply(params, jnp.asarray(x)))
        got = np.asarray(mod.apply(
            params, quantize_acts(jnp.asarray(x), s_in).astype(jnp.float32)
            .astype(jnp.int8), s_in))
        assert got.shape == ref.shape == (2, 12 // stride + (12 % stride),
                                          14 // stride + (14 % stride), 48)
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err < 0.03, (stride, err)


def test_quantize_weights_1x1_layouts():
    """[1,1,C,Co] and [C,Co] inputs give identical packs; dequantized
    weights reproduce the originals within half a quantization step."""
    rng = np.random.RandomState(2)
    w = rng.uniform(-0.5, 0.5, (1, 1, 8, 16)).astype(np.float32)
    q4, s4 = quantize_weights_1x1(jnp.asarray(w))
    q2, s2 = quantize_weights_1x1(jnp.asarray(w[0, 0]))
    np.testing.assert_array_equal(np.asarray(q4), np.asarray(q2))
    np.testing.assert_array_equal(np.asarray(s4), np.asarray(s2))
    deq = np.asarray(q4, np.float32) * np.asarray(s4)[None, :]
    assert np.abs(deq - w[0, 0]).max() <= 0.5 * np.asarray(s4).max() + 1e-7


def _resnet_nets(rng, hw=(64, 64)):
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu.ops.quant import (calibrate_trunk_int8_resnet,
                                     with_int8_scales)

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "resnet50", "FC_DIM": 64, "NUM_TEMPLATES": 5,
                  "COMPUTE_DTYPE": "float32", "DROPOUT": 0.0}})
    net = build_az_net(cfg)
    images = rng.uniform(-120, 120, (2,) + hw + (3,)).astype(np.float32)
    scales = calibrate_trunk_int8_resnet(net, images)
    # 13 bottlenecks x 2 taps + the trailing trunk-output scale.
    assert len(scales) == 2 * 13 + 1
    assert all(s > 0 for s in scales)
    net8 = build_az_net(with_int8_scales(cfg, scales), params=net.params)
    return net, net8, images, scales


def test_resnet_int8_trunk_matches_f32_features():
    """calibrate_trunk_int8_resnet -> int8 trunk; features must closely
    track the f32 trunk (quantization noise compounds over 13 blocks +
    residual adds, so demand cosine/energy bounds, not elementwise)."""
    rng = np.random.RandomState(3)
    net, net8, images, _ = _resnet_nets(rng)
    ref = np.asarray(net.model.apply(net.params, jnp.asarray(images),
                                     method="features"), np.float32)
    out = np.asarray(net8.model.apply(net8.params, jnp.asarray(images),
                                      method="features"), np.float32)
    assert out.shape == ref.shape == (2, 4, 4, 1024)
    cos = (out * ref).sum() / max(np.linalg.norm(out) * np.linalg.norm(ref),
                                  1e-9)
    assert cos > 0.98, cos
    rel = np.abs(out - ref).mean() / max(np.abs(ref).mean(), 1e-9)
    assert rel < 0.2, rel


def test_resnet_int8_heads_match_f32_roi_forward():
    """The bench's full resnet int8 configuration (int8 trunk + int8 fc
    stack, calibrate_head_int8 fed the trunk-output scale) tracks the f32
    head on the same rois."""
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu.ops.quant import calibrate_head_int8, with_int8_scales

    rng = np.random.RandomState(4)
    net, _, images, scales = _resnet_nets(rng)
    head_scales = calibrate_head_int8(net, images, scales, batch_size=1)
    assert len(head_scales) == 2 and all(s > 0 for s in head_scales)
    net8 = build_az_net(with_int8_scales(net.cfg, scales, head_scales),
                        params=net.params)
    feat = net.model.apply(net.params, jnp.asarray(images[:1]),
                           method="features")[0]
    feat8 = net8.model.apply(net8.params, jnp.asarray(images[:1]),
                             method="features")[0]
    rois = jnp.asarray([[0.0, 0.0, 31.0, 31.0], [8.0, 8.0, 55.0, 47.0]])
    ref = net.model.apply(net.params, feat, rois, method="roi_forward")
    out = net8.model.apply(net8.params, feat8, rois, method="roi_forward")
    for k in ("zoom", "adj_score"):
        a = np.asarray(ref[k], np.float32)
        b = np.asarray(out[k], np.float32)
        assert np.abs(1 / (1 + np.exp(-a)) - 1 / (1 + np.exp(-b))).max() < 0.1


def test_resnet_int8_requires_scales():
    from aznet_tpu.api import build_az_net
    from aznet_tpu.config import Config, cfg_from_dict

    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "resnet50", "FC_DIM": 64,
                  "COMPUTE_DTYPE": "int8"}})
    # The resnet trunk validates scales at trace time, so init raises
    # (earlier than the VGG trunk, which defers to the first apply).
    with pytest.raises(ValueError, match="INT8_SCALES"):
        build_az_net(cfg)
