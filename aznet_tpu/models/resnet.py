"""ResNet-50 trunk (backbone-swap config, BASELINE config 5).

The reference has no ResNet (2016 Caffe-era VGG), but BASELINE.json's
config 5 calls for a ResNet-50 backbone swap. Output is the conv4_x (C4)
stage at stride 16, the classic Faster-R-CNN-style choice so ROI heads see
the same 1/16 feature scale as VGG.

BatchNorm is "frozen" (per-channel scale/bias parameters, no batch stats) —
standard practice for detection fine-tuning and far simpler under pjit (no
cross-device stat sync). Compute in bfloat16.

Int8 mode (``MODEL.COMPUTE_DTYPE: "int8"``): the bottleneck 1x1 convs —
conv1, conv3 and the downsample projection, ~47% of trunk FLOPs — run as
int8 GEMMs with int32 accumulation (ops/conv_int8.py::conv1x1_int8).
Unlike the VGG 3x3 path, a 1x1 conv needs NO dx-packing: it is already a
[B*H*W, C] @ [C, Co] matmul. The 7x7 stem and the 3x3 convs stay
bfloat16. Two static activation scales per block (block input,
post-bn2-ReLU mid) come from
:func:`aznet_tpu.ops.quant.calibrate_trunk_int8_resnet`; weights quantize
in-jit per output channel from the f32 params, so checkpoints are
untouched and int8 is a pure config swap, exactly like the VGG trunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp

from aznet_tpu.models.layers import Module, conv, conv_params, max_pool
from aznet_tpu.ops.conv_int8 import (
    conv1x1_int8,
    quantize_acts,
    quantize_weights_1x1,
)

_LECUN = jax.nn.initializers.lecun_normal()


@dataclasses.dataclass(frozen=True)
class StemConv(Module):
    """The 7x7/stride-2 stem, optionally as an EXACT space-to-depth
    rewrite (``s2d=True``).

    A 3-channel 7x7 conv has a shallow contraction: 7*7*3 = 147 values
    with only 3 per tap, over the full-resolution input at stride 2. The
    MLPerf-ResNet trick rewrites it exactly: pad the kernel 7x7 -> 8x8
    with a zero leading row/column, space-to-depth the input by 2
    (``[H, W, 3] -> [H/2, W/2, 12]``), and run a 4x4 *stride-1* conv —
    identical math term-by-term, since output position i's taps
    ``u = a-3 in [-3, 3]`` map to s2d rows ``p - i in [-2, 1]`` with
    ``u = 2(p-i) + dy`` and the padded ``u = -4`` row multiplied by zero.
    The contraction depth becomes 4*4*12 = 192 and the conv runs at the
    already-halved resolution.

    The parameter stays the ``kernel [7, 7, 3, 64]`` layout — checkpoints
    and Caffe weight conversion are untouched; the re-layout happens
    in-jit (XLA constant-folds it per compilation).

    Reference equivalent: none — the reference's Caffe stem is cuDNN's
    problem (SURVEY.md §2.3).
    """

    features: int = 64
    dtype: Any = jnp.bfloat16
    s2d: bool = True

    def init_params(self, key, x) -> dict:
        return {"kernel": _LECUN(key.param(1),
                                 (7, 7, x.shape[-1], self.features),
                                 jnp.float32)}

    def __call__(self, p, x):
        kernel = p["kernel"]
        b, h, w, c = x.shape
        if not self.s2d or h % 2 or w % 2:
            return jax.lax.conv_general_dilated(
                x.astype(self.dtype), kernel.astype(self.dtype),
                window_strides=(2, 2), padding=((3, 3), (3, 3)),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
        # channel packing order (dy, dx, c) — must match the kernel reshape
        z = x.reshape(b, h // 2, 2, w // 2, 2, c)
        z = z.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        w8 = jnp.pad(kernel, ((1, 0), (1, 0), (0, 0), (0, 0)))  # u=-4 row/col
        k4 = w8.reshape(4, 2, 4, 2, c, self.features)  # (py, dy, px, dx, c, o)
        k4 = k4.transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c, self.features)
        return jax.lax.conv_general_dilated(
            z.astype(self.dtype), k4.astype(self.dtype), window_strides=(1, 1),
            padding=((2, 1), (2, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))


def bn_params(ch: int) -> dict:
    return {"scale": jnp.ones((ch,), jnp.float32),
            "bias": jnp.zeros((ch,), jnp.float32)}


def frozen_bn(p, x, dtype):
    """Per-channel affine (the inference form of BatchNorm)."""
    return x * p["scale"].astype(dtype) + p["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class Conv1x1(Module):
    """1x1 conv (no bias) with an optional int8-GEMM fast path.

    Stores the kernel as ``[1, 1, C, Co]`` f32 (the conv layout, so
    weight conversion and checkpoints are interchangeable with a plain
    1x1 convolution). ``s_in > 0`` selects the int8 path: the caller
    passes a pre-quantized ``x_i8`` (so a block input feeding two 1x1s —
    conv1 + downsample — quantizes once).
    """

    features: int
    stride: int = 1
    dtype: Any = jnp.bfloat16

    def init_params(self, key, x) -> dict:
        return {"kernel": _LECUN(key.param(1),
                                 (1, 1, x.shape[-1], self.features),
                                 jnp.float32)}

    def __call__(self, p, x, s_in: float = 0.0):
        if self.stride > 1:
            # 1x1/SAME at stride s samples positions 0, s, 2s, ...
            x = x[:, :: self.stride, :: self.stride, :]
        w = p["kernel"][0, 0]
        if s_in > 0.0:
            w_q, s_w = quantize_weights_1x1(w)
            return conv1x1_int8(x, s_in, w_q, s_w, out_dtype=self.dtype)
        return jnp.dot(x.astype(self.dtype), w.astype(self.dtype))


def _bottleneck_params(key, cin: int, channels: int, stride: int) -> dict:
    x = jax.ShapeDtypeStruct((1, 1, 1, cin), jnp.float32)
    mid = jax.ShapeDtypeStruct((1, 1, 1, channels), jnp.float32)
    p = {
        "conv1": Conv1x1(channels).init_params(key.child("conv1"), x),
        "bn1": bn_params(channels),
        "conv2": conv_params(key.child("conv2"), 3, 3, channels, channels,
                             bias=False),
        "bn2": bn_params(channels),
        "conv3": Conv1x1(channels * 4).init_params(key.child("conv3"), mid),
        "bn3": bn_params(channels * 4),
    }
    if cin != channels * 4 or stride != 1:
        p["downsample"] = Conv1x1(channels * 4).init_params(
            key.child("downsample"), x)
        p["downsample_bn"] = bn_params(channels * 4)
    return p


def bottleneck(p, x, channels: int, stride: int, dtype,
               int8_scales: Tuple[float, ...] = (), taps: dict | None = None):
    """One bottleneck block. ``int8_scales = (s_in, s_mid)`` selects the
    int8 1x1 GEMMs; ``taps`` receives the two calibration absmaxes."""
    s_in, s_mid = int8_scales if int8_scales else (0.0, 0.0)
    if taps is not None:
        taps["qin_absmax"] = jnp.max(jnp.abs(x.astype(jnp.float32)))
    xq = quantize_acts(x, s_in) if s_in > 0.0 else x
    residual = x
    y = Conv1x1(channels, dtype=dtype)(p["conv1"], xq, s_in)
    y = jax.nn.relu(frozen_bn(p["bn1"], y, dtype))
    y = conv(p["conv2"], y, stride=stride, dtype=dtype)
    y = jax.nn.relu(frozen_bn(p["bn2"], y, dtype))
    if taps is not None:
        taps["qmid_absmax"] = jnp.max(jnp.abs(y.astype(jnp.float32)))
    if s_mid > 0.0:
        y = quantize_acts(y, s_mid)
    y = Conv1x1(channels * 4, dtype=dtype)(p["conv3"], y, s_mid)
    y = frozen_bn(p["bn3"], y, dtype)
    if "downsample" in p:
        residual = Conv1x1(channels * 4, stride=stride, dtype=dtype)(
            p["downsample"], xq, s_in)
        residual = frozen_bn(p["downsample_bn"], residual, dtype)
    return jax.nn.relu(y + residual)


@dataclasses.dataclass(frozen=True)
class ResNet50Trunk(Module):
    """Input [..., H, W, 3] -> C4 features [..., H/16, W/16, 1024]."""

    dtype: Any = jnp.bfloat16
    stage_sizes: Sequence[int] = (3, 4, 6)  # C2, C3, C4 (C5 unused at 1/16)
    # 2 scales per bottleneck block, block-definition order (13 blocks ->
    # 26 floats from calibrate_trunk_int8_resnet); empty = all-bf16.
    int8_mode: bool = False
    int8_scales: Tuple[float, ...] = ()
    # Exact space-to-depth stem rewrite (StemConv docstring). Same params/
    # checkpoints; falls back to the plain 7x7 conv on odd input sizes.
    stem_s2d: bool = True

    feat_stride: int = 16
    out_channels: int = 1024

    def _blocks(self):
        """(name, channels, stride) per bottleneck, definition order."""
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                yield f"layer{stage + 1}_block{block}", 64 * 2 ** stage, stride

    def _check_scales(self):
        n_blocks = sum(self.stage_sizes)
        if self.int8_mode and len(self.int8_scales) < 2 * n_blocks:
            raise ValueError(
                f"int8 ResNet trunk needs MODEL.INT8_SCALES with "
                f"{2 * n_blocks} entries (2 per bottleneck; run "
                f"aznet_tpu.ops.quant.calibrate_trunk_int8_resnet first); "
                f"got {len(self.int8_scales)}")

    def init_params(self, key, x) -> dict:
        self._check_scales()
        params = {"conv1": StemConv().init_params(key.child("conv1"), x),
                  "bn1": bn_params(64)}
        cin = 64
        for name, channels, stride in self._blocks():
            params[name] = _bottleneck_params(key.child(name), cin, channels,
                                              stride)
            cin = channels * 4
        return params

    def __call__(self, p, x, taps: dict | None = None):
        """``taps``, when given, receives each block's calibration absmaxes
        by block name plus the trunk output's ``qout_absmax``."""
        self._check_scales()
        scales = self.int8_scales if self.int8_mode else ()
        x = x.astype(self.dtype)
        x = StemConv(dtype=self.dtype, s2d=self.stem_s2d)(p["conv1"], x)
        x = jax.nn.relu(frozen_bn(p["bn1"], x, self.dtype))
        x = max_pool(x, (3, 3), (2, 2), padding=((1, 1), (1, 1)))
        for i, (name, channels, stride) in enumerate(self._blocks()):
            blk_taps = None
            if taps is not None:
                blk_taps = taps[name] = {}
            x = bottleneck(p[name], x, channels, stride, self.dtype,
                           tuple(scales[2 * i : 2 * i + 2]), blk_taps)
        # Trunk-output tap: calibrate_trunk_int8_resnet appends this as the
        # trailing scale so calibrate_head_int8's trunk_scales[-1] (the
        # pooled-feature scale — roi_align is convex) stays correct here.
        if taps is not None:
            taps["qout_absmax"] = jnp.max(jnp.abs(x.astype(jnp.float32)))
        return x
