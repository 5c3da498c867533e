"""Caffe weight conversion: shape/layout correctness via synthetic params."""

import numpy as np
import jax
import jax.numpy as jnp

from aznet_tpu.utils.convert_weights import (
    convert_conv,
    convert_dense,
    convert_fc6,
    convert_vgg16_trunk,
    VGG16_CONV_NAMES,
)


def test_convert_conv_layout():
    rng = np.random.RandomState(0)
    w = rng.randn(64, 3, 3, 3).astype(np.float32)  # caffe (out, in, kh, kw)
    b = rng.randn(64).astype(np.float32)
    out = convert_conv(w, b)
    assert out["kernel"].shape == (3, 3, 3, 64)  # (kh, kw, in, out)
    # spot-check one element
    assert out["kernel"][1, 2, 0, 7] == w[7, 0, 1, 2]


def test_convert_fc6_permutation_semantics():
    # A Caffe fc6 applied to channel-first flattened features must equal our
    # converted fc6 applied to channel-last flattened features.
    rng = np.random.RandomState(1)
    p, c, out_dim = 3, 5, 7
    w = rng.randn(out_dim, c * p * p).astype(np.float32)
    b = rng.randn(out_dim).astype(np.float32)
    feat = rng.randn(p, p, c).astype(np.float32)  # our (ph, pw, c)
    caffe_in = np.transpose(feat, (2, 0, 1)).reshape(-1)  # (c, ph, pw) flat
    want = w @ caffe_in + b
    conv = convert_fc6(w, b, pool=p, channels=c)
    got = feat.reshape(-1) @ conv["kernel"] + conv["bias"]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_convert_vgg16_trunk_loads_into_model():
    rng = np.random.RandomState(2)
    caffe = {}
    channels = {"conv1": (3, 64), "conv2": (64, 128), "conv3": (128, 256),
                "conv4": (256, 512), "conv5": (512, 512)}
    prev = 3
    for name in VGG16_CONV_NAMES:
        block = name.split("_")[0]
        out_ch = channels[block][1]
        caffe[name] = (rng.randn(out_ch, prev, 3, 3).astype(np.float32),
                       rng.randn(out_ch).astype(np.float32))
        prev = out_ch
    trunk_params = convert_vgg16_trunk(caffe)

    from aznet_tpu.models.vgg import VGG16Trunk

    trunk = VGG16Trunk(dtype=jnp.float32)
    ref = jax.eval_shape(lambda: trunk.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3))))
    for name, sub in ref["params"].items():
        assert trunk_params[name]["kernel"].shape == sub["kernel"].shape, name
        assert trunk_params[name]["bias"].shape == sub["bias"].shape, name
    # and it actually runs
    out = trunk.apply({"params": trunk_params}, jnp.ones((1, 32, 32, 3)))
    assert out.shape == (1, 2, 2, 512)
    assert np.isfinite(np.asarray(out)).all()


def test_convert_caffenet_trunk_grouped_convs():
    """Grouped Caffe kernels (out, in/g, kh, kw) land directly in XLA's
    feature_group_count layout — round-trip into CaffeNetTrunk and run."""
    from aznet_tpu.utils.convert_weights import convert_trunk
    from aznet_tpu.models.small import CaffeNetTrunk

    rng = np.random.RandomState(3)
    spec = {  # name: (out, in_per_group, k)
        "conv1": (96, 3, 11), "conv2": (256, 48, 5), "conv3": (384, 256, 3),
        "conv4": (384, 192, 3), "conv5": (256, 192, 3),
    }
    caffe = {n: (rng.randn(o, i, k, k).astype(np.float32) * 0.01,
                 rng.randn(o).astype(np.float32) * 0.01)
             for n, (o, i, k) in spec.items()}
    trunk_params = convert_trunk(caffe, "caffenet")

    trunk = CaffeNetTrunk(dtype=jnp.float32)
    ref = jax.eval_shape(lambda: trunk.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    for name, sub in ref["params"].items():
        assert trunk_params[name]["kernel"].shape == sub["kernel"].shape, name
    out = trunk.apply({"params": trunk_params}, jnp.ones((1, 64, 64, 3)))
    assert out.shape == (1, 4, 4, 256)
    assert np.isfinite(np.asarray(out)).all()


def test_convert_vgg_cnn_m_1024_trunk():
    from aznet_tpu.utils.convert_weights import convert_trunk
    from aznet_tpu.models.small import VGGCNNM1024Trunk

    rng = np.random.RandomState(4)
    spec = {"conv1": (96, 3, 7), "conv2": (256, 96, 5), "conv3": (512, 256, 3),
            "conv4": (512, 512, 3), "conv5": (512, 512, 3)}
    caffe = {n: (rng.randn(o, i, k, k).astype(np.float32) * 0.01,
                 rng.randn(o).astype(np.float32) * 0.01)
             for n, (o, i, k) in spec.items()}
    trunk_params = convert_trunk(caffe, "vgg_cnn_m_1024")
    trunk = VGGCNNM1024Trunk(dtype=jnp.float32)
    out = trunk.apply({"params": trunk_params}, jnp.ones((1, 64, 64, 3)))
    assert out.shape == (1, 4, 4, 512)
    assert np.isfinite(np.asarray(out)).all()
