"""VGG-16 convolutional trunk (conv1_1 .. conv5_3), stride 16.

Reference equivalent: the VGG-16 prototxt trunk (models/VGG16/*, SURVEY.md
§2.1) — 13 3x3 convs + ReLU with 4 max-pools; the 5th pool is NOT applied
(fast-rcnn uses conv5_3 at stride 16 for ROI pooling). Layer names mirror
the prototxt (conv1_1, ...) so converted Caffe weights map 1:1.

NHWC layout, bfloat16 compute / float32 params by default; XLA fuses the
bias and ReLU into each convolution.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from aznet_tpu.models.layers import Module, conv, conv_params, max_pool

# (name, channels) per conv; 'pool' entries are 2x2/2 max pools.
VGG16_LAYOUT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool3", None),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool4", None),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
)
CONV_NAMES = tuple(n for n, ch in VGG16_LAYOUT if ch is not None)


def conv1_1_s2d(x, kernel, bias, dtype):
    """conv1_1 (3x3/s1, 3->64) + ReLU as an EXACT space-to-depth-2 rewrite.

    The stride-1 analog of the ResNet stem rewrite (models/resnet.py
    ``StemConv``): a 3-channel contraction gives the matrix unit K = 3
    per tap at full resolution. Rewrite: pack the input 2x2 ->
    [H/2, W/2, 12], run ONE 3x3 stride-1 conv producing all four output
    phases ([H/2, W/2, 4*64]), then depth-to-space back. Term-identical
    math: output phase p's tap dy = 2u + a - p for packed-row offset u and
    intra-cell row a, so each original weight lands in exactly one
    packed-kernel slot and every other slot is zero; zero-padding the
    packed borders reproduces SAME padding (the extra original rows it
    implies only ever multiply zero weights). 4x the MACs (3/4 zeros) but
    K = 12 per tap at quarter spatial size.

    Parameters stay the ``kernel [3, 3, 3, 64]`` / ``bias [64]`` layout —
    checkpoints and Caffe conversion untouched; the re-layout happens
    in-jit. Requires even H and W (608x800 canvases).

    Reference equivalent: none — the reference's conv1_1 is cuDNN's
    problem (SURVEY.md §2.1). Exact.
    """
    b, h, w, c = x.shape
    co = kernel.shape[-1]
    z = x.reshape(b, h // 2, 2, w // 2, 2, c)
    z = z.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    k4 = jnp.zeros((3, 3, 2, 2, c, 2, 2, co), kernel.dtype)
    for u in (-1, 0, 1):
        for a in (0, 1):
            for p in (0, 1):
                dy = 2 * u + a - p
                if not -1 <= dy <= 1:
                    continue
                for v in (-1, 0, 1):
                    for bb in (0, 1):
                        for q in (0, 1):
                            dx = 2 * v + bb - q
                            if not -1 <= dx <= 1:
                                continue
                            k4 = k4.at[u + 1, v + 1, a, bb, :, p, q, :].set(
                                kernel[dy + 1, dx + 1])
    k4 = k4.reshape(3, 3, 4 * c, 4 * co)
    y = jax.lax.conv_general_dilated(
        z.astype(dtype), k4.astype(dtype), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    y = jnp.maximum(y + jnp.tile(bias, 4), 0.0).astype(dtype)
    y = y.reshape(b, h // 2, w // 2, 2, 2, co)
    return y.transpose(0, 1, 3, 2, 4, 5).reshape(b, h, w, co)


def _even_hw(x) -> bool:
    return x.shape[-3] % 2 == 0 and x.shape[-2] % 2 == 0


@dataclasses.dataclass(frozen=True)
class VGG16Trunk(Module):
    """Input [..., H, W, 3] (preprocessed BGR) -> [..., H/16, W/16, 512*width]."""

    dtype: Any = jnp.bfloat16
    # Channel-width multiplier: 1.0 = the reference VGG-16; smaller keeps
    # the structure (layer names, sharding rules) at reduced cost.
    width: float = 1.0
    # The reference training freezes conv1/conv2 when fine-tuning from
    # ImageNet (fast-rcnn lineage lr_mult=0). Opt in via
    # cfg.TRAIN.FREEZE_PREFIXES=("conv1", "conv2") — see train/optim.py.

    # Inference-only int8 path (ops/conv_int8.py): conv2_2..conv5_3 as
    # dx-packed int8 GEMMs with int32 accumulation; activations flow
    # between layers as int8. Identical parameters/checkpoints; requires
    # calibrated per-layer activation scales (ops/quant.py).
    int8_mode: bool = False
    int8_scales: tuple = ()

    # conv1_1 as the exact s2d-2 rewrite (:func:`conv1_1_s2d`); applies to
    # both the bf16 and int8-prefix paths when H/W are even. Identical
    # math/checkpoints; cfg.MODEL.CONV1_S2D.
    conv1_s2d: bool = False

    feat_stride: int = 16

    @property
    def out_channels(self) -> int:
        return self._channels(512)

    def _channels(self, ch: int) -> int:
        return max(int(ch * self.width), 8)

    # Layers kept in `dtype` in int8 mode: conv1_1 has a 3-channel K=27
    # input and conv1_2/conv2_1 have 64 input channels, too shallow a
    # contraction for int8 GEMMs to pay; int8 starts at conv2_2.
    _INT8_BF16_PREFIX = ("conv1_1", "conv1_2", "conv2_1")

    def init_params(self, key, x) -> dict:
        params, cin = {}, x.shape[-1]
        for name, ch in VGG16_LAYOUT:
            if ch is not None:
                cout = self._channels(ch)
                params[name] = conv_params(key.child(name), 3, 3, cin, cout)
                cin = cout
        return params

    def __call__(self, p, x, taps: dict | None = None):
        """``taps``, when given, receives each conv's pre-ReLU output by
        layer name (int8 calibration, ops/quant.py)."""
        if self.int8_mode:
            return self._int8_forward(p, x)
        x = x.astype(self.dtype)
        for name, ch in VGG16_LAYOUT:
            if ch is None:
                x = max_pool(x, (2, 2), (2, 2))
            elif (name == "conv1_1" and self.conv1_s2d and taps is None
                  and _even_hw(x)):
                squeeze = x.ndim == 3
                xb = x[None] if squeeze else x
                xb = conv1_1_s2d(xb, p[name]["kernel"], p[name]["bias"],
                                 self.dtype)
                x = xb[0] if squeeze else xb
            else:
                y = conv(p[name], x, dtype=self.dtype)
                if taps is not None:
                    taps[name] = y
                x = jax.nn.relu(y)
        return x

    def _int8_forward(self, p, x):
        """Hybrid trunk: `dtype` conv1 block + conv2_1, int8 GEMM convs
        after."""
        from aznet_tpu.ops.conv_int8 import conv3x3_int8, quantize_acts, \
            quantize_weights

        if len(self.int8_scales) < len(CONV_NAMES) - 1:
            raise ValueError(
                "int8 trunk needs MODEL.INT8_SCALES for conv1_1..conv5_2 "
                "(run aznet_tpu.ops.quant.calibrate_trunk_int8 first); got "
                f"{len(self.int8_scales)} scales")
        scales = dict(zip(CONV_NAMES, self.int8_scales))
        prefix = self._INT8_BF16_PREFIX
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        x = x.astype(self.dtype)
        s_x = None
        for name, ch in VGG16_LAYOUT:
            if ch is None:
                x = max_pool(x, (2, 2), (2, 2))
                continue
            if name in prefix:
                if name == "conv1_1" and self.conv1_s2d and _even_hw(x):
                    y = conv1_1_s2d(x, p[name]["kernel"], p[name]["bias"],
                                    self.dtype)
                else:
                    y = jax.lax.conv_general_dilated(
                        x, p[name]["kernel"].astype(self.dtype), (1, 1),
                        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                        preferred_element_type=jnp.float32)
                    y = jnp.maximum(y + p[name]["bias"], 0.0)
                if name == prefix[-1]:  # quantize into the int8 layers
                    s_x = scales[name]
                    x = quantize_acts(y, s_x)
                else:
                    x = y.astype(self.dtype)
                continue
            # conv5_3 is the trunk output: emit `dtype`, never requantize.
            s_out = scales[name] if name != CONV_NAMES[-1] else None
            w_q, s_w = quantize_weights(p[name]["kernel"].astype(jnp.float32))
            x = conv3x3_int8(x, s_x, w_q, s_w,
                             p[name]["bias"].astype(jnp.float32),
                             s_out=s_out, out_dtype=self.dtype)
            if s_out is not None:
                s_x = s_out
        return x[0] if squeeze else x
