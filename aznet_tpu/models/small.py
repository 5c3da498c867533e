"""Small convolutional trunks: CaffeNet, VGG_CNN_M_1024, and a CI stand-in.

The reference fork ships smaller prototxts alongside VGG-16 (CaffeNet and
VGG_CNN_M_1024 — SURVEY.md §2.1 "AZ network definitions" [M]; the mount is
empty, so the architectures here follow the fast-rcnn lineage's published
prototxts from memory, layer names kept for weight conversion):

  - :class:`CaffeNetTrunk` — AlexNet single-stream: conv1 11x11/4, LRN after
    pool1/pool2, grouped conv2/conv4/conv5, conv5 output 256ch, stride 16.
    Heads use POOL_SIZE=6 + fc6/fc7 both 4096.
  - :class:`VGGCNNM1024Trunk` — conv1 7x7/2, conv2 5x5/2, three 512ch 3x3
    convs, LRN after conv1/conv2, stride 16. Heads use POOL_SIZE=6 +
    fc6=4096 / fc7=1024 (``MODEL.FC7_DIM``).
  - :class:`SmallTrunk` — no reference equivalent: a cheap 5-conv net for
    tests/CI (kept because CPU suites run hundreds of forwards).

Structural deviation, documented: convs use SAME padding (the Caffe
prototxts crop borders with pad-0 conv1), keeping the trunk output exactly
[H/16, W/16] — the contract the ROI projection (1/FEAT_STRIDE) and the
search's feature-coordinate math assume. The reference's own ROI projection
ignores conv cropping (it divides by 16 regardless), so this is a parity
*improvement*, not a drift. Caffe's overlapping 3x3/2 ceil-mode pools are
reproduced exactly by max_pool((3,3),(2,2)) with low/high padding (0,1)
(pads with -inf; output ceil((H-1)/2) == Caffe's ceil((H-3)/2)+1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from aznet_tpu.models.layers import Module, conv, conv_params, max_pool


def lrn(x, size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 1.0):
    """Caffe cross-channel Local Response Normalization (ACROSS_CHANNELS).

    ``y = x / (k + (alpha/size) * sum_{window} x^2) ** beta`` with the sum
    over ``size`` adjacent channels centered on each channel — Caffe divides
    ``alpha`` by the window size (lrn_layer.cpp's ``alpha_ / size_``), which
    is how the CaffeNet/VGG_CNN prototxt constants (5, 1e-4, 0.75) are
    calibrated. Runs in float32 (the squared-sum underflows bf16).
    """
    xf = x.astype(jnp.float32)
    sq = xf * xf
    pad = ((0, 0),) * (x.ndim - 1) + ((size // 2, size - 1 - size // 2),)
    window = (1,) * (x.ndim - 1) + (size,)
    ssum = jax.lax.reduce_window(
        sq, 0.0, jax.lax.add, window_dimensions=window,
        window_strides=(1,) * x.ndim, padding=pad)
    return (xf / (k + (alpha / size) * ssum) ** beta).astype(x.dtype)


def _pool3x2(x):
    """Caffe ceil-mode 3x3/2 max pool (see module docstring)."""
    return max_pool(x, (3, 3), (2, 2), padding=((0, 1), (0, 1)))


class _ConvTrunk(Module):
    """A chain of named convs + ReLU, each optionally followed by pools
    and LRN. ``_LAYERS``: ``(name, kernel, stride, out, groups, after)``
    where ``after`` lists "pool" / "lrn" steps in order."""

    _LAYERS = ()

    def _layers(self):
        return self._LAYERS

    def init_params(self, key, x) -> dict:
        params, cin = {}, x.shape[-1]
        for name, k, _, cout, groups, _ in self._layers():
            params[name] = conv_params(key.child(name), k, k, cin, cout,
                                       groups)
            cin = cout
        return params

    def __call__(self, p, x):
        x = x.astype(self.dtype)
        for name, _, stride, _, groups, after in self._layers():
            x = jax.nn.relu(conv(p[name], x, stride=stride, groups=groups,
                                 dtype=self.dtype))
            for step in after:
                x = {"pool": _pool3x2, "lrn": lrn,
                     "pool2": lambda y: max_pool(y, (2, 2), (2, 2))}[step](x)
        return x


@dataclasses.dataclass(frozen=True)
class CaffeNetTrunk(_ConvTrunk):
    """AlexNet-style trunk (fast-rcnn's models/CaffeNet [M]).

    Input [..., H, W, 3] -> [..., H/16, W/16, 256].
    """

    dtype: Any = jnp.bfloat16

    feat_stride: int = 16
    out_channels: int = 256

    _LAYERS = (
        ("conv1", 11, 4, 96, 1, ("pool", "lrn")),
        ("conv2", 5, 1, 256, 2, ("pool", "lrn")),
        ("conv3", 3, 1, 384, 1, ()),
        ("conv4", 3, 1, 384, 2, ()),
        ("conv5", 3, 1, 256, 2, ()),
    )


@dataclasses.dataclass(frozen=True)
class VGGCNNM1024Trunk(_ConvTrunk):
    """VGG_CNN_M_1024 trunk (fast-rcnn's models/VGG_CNN_M_1024 [M]).

    Input [..., H, W, 3] -> [..., H/16, W/16, 512]. Pair with
    ``MODEL.FC7_DIM = 1024`` (the "1024" in the net's name is fc7's width).
    """

    dtype: Any = jnp.bfloat16

    feat_stride: int = 16
    out_channels: int = 512

    _LAYERS = (
        ("conv1", 7, 2, 96, 1, ("lrn", "pool")),
        ("conv2", 5, 2, 256, 1, ("lrn", "pool")),
        ("conv3", 3, 1, 512, 1, ()),
        ("conv4", 3, 1, 512, 1, ()),
        ("conv5", 3, 1, 512, 1, ()),
    )


@dataclasses.dataclass(frozen=True)
class SmallTrunk(_ConvTrunk):
    """Input [..., H, W, 3] -> [..., H/16, W/16, out_channels]."""

    dtype: Any = jnp.bfloat16
    width: int = 64

    feat_stride: int = 16
    out_channels: int = 128

    def _layers(self):
        w = self.width
        return (
            ("conv1", 5, 2, w, 1, ("pool2",)),
            ("conv2", 3, 2, w * 2, 1, ()),
            ("conv3", 3, 1, w * 2, 1, ("pool2",)),
            ("conv4", 3, 1, self.out_channels, 1, ()),
        )
