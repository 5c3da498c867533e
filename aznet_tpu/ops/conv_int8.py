"""Int8 3x3 conv expressed as dx-packed shifted GEMMs (the int8 trunk).

Int8 GEMMs run at twice the bf16 tensor-core rate on the H100 (data
sheet), but XLA's int8 *convolutions* are a separate path; this module
expresses the conv as matmuls instead:

  conv3x3(x, w) = sum_dy  X_cat[:, dy:dy+H] @ W[dy]

where ``X_cat [B, H+2, W, 3C]`` concatenates the three dx-shifted copies of
the (zero-padded) input along channels, and ``W[dy] [3C, Cout]`` flattens
the (dx, Cin) axes of the kernel. Each of the 3 dots has K = 3*Cin >= 192
and M = H*W — large and static — and accumulates in int32.

Quantization scheme (inference-only):
  - symmetric, zero-point 0 (so zero-padding is exact)
  - weights: per-output-channel scales, quantized in-jit from the f32
    params (cheap: one read of the ~59 MB trunk weights per program)
  - activations: one static per-layer scale from a calibration pass
    (see :func:`aznet_tpu.ops.quant.calibrate_trunk_int8`); activations
    flow between layers AS int8, so HBM traffic is 1 byte/element
  - epilogue: y = relu(acc * (s_x * s_w) + b), requantized to int8 for the
    next layer or emitted as ``out_dtype`` for the trunk output

Reference equivalent: the Caffe VGG-16 conv layers this replaces
(SURVEY.md §2.1 "AZ network definitions"; mount empty — no file:line
exists). The reference has no quantized path at all.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INT8_MAX = 127.0


def quantize_weights(w: jnp.ndarray):
    """f32 [3, 3, C, Co] -> (int8 [3, 3C, Co] dy-major pack, scales [Co])."""
    s = jnp.max(jnp.abs(w), axis=(0, 1, 2)) / INT8_MAX
    s = jnp.maximum(s, 1e-12)
    q = jnp.clip(jnp.round(w / s), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    kh, kw, c, co = w.shape
    # [dy, dx, C, Co] -> [dy, dx*C, Co]: dx-major flatten matches the
    # channel order of the dx-concatenated activations below.
    return q.reshape(kh, kw * c, co), s


def quantize_acts(x: jnp.ndarray, scale) -> jnp.ndarray:
    """f32/bf16 -> int8 with a static per-tensor scale (symmetric)."""
    q = jnp.round(x.astype(jnp.float32) / scale)
    return jnp.clip(q, -INT8_MAX, INT8_MAX).astype(jnp.int8)


def dx_pack(xp: jnp.ndarray) -> jnp.ndarray:
    """[B, H+2, W+2, C] zero-padded int8 -> [B, H+2, W, 3C] dx-cat."""
    w = xp.shape[2] - 2
    return jnp.concatenate(
        [xp[:, :, 0:w], xp[:, :, 1 : w + 1], xp[:, :, 2 : w + 2]], axis=-1
    )


def conv3x3_int8(x_i8: jnp.ndarray, s_x, w_q: jnp.ndarray, s_w, bias,
                 s_out=None, out_dtype=jnp.bfloat16):
    """One 3x3/SAME conv + ReLU on int8 activations.

    x_i8: [B, H, W, C] int8 with activation scale ``s_x`` (scalar).
    w_q/s_w: from :func:`quantize_weights`. bias: f32 [Co].
    Returns int8 [B, H, W, Co] when ``s_out`` is given (the next layer's
    input scale), else ``out_dtype`` activations.
    """
    b_, h, w, c = x_i8.shape
    xp = jnp.pad(x_i8, ((0, 0), (1, 1), (1, 1), (0, 0)))
    xc = dx_pack(xp)  # [B, H+2, W, 3C]
    acc = None
    for dy in range(3):
        a = jax.lax.slice_in_dim(xc, dy, dy + h, axis=1)
        d = jax.lax.dot_general(
            a, w_q[dy],
            dimension_numbers=(((3,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        acc = d if acc is None else acc + d
    y = acc.astype(jnp.float32) * (s_x * s_w) + bias
    y = jnp.maximum(y, 0.0)
    if s_out is None:
        return y.astype(out_dtype)
    return quantize_acts(y, s_out)


def quantize_weights_1x1(w: jnp.ndarray):
    """f32 [1, 1, C, Co] (or [C, Co]) -> (int8 [C, Co], scales [Co]).

    Per-output-channel symmetric scales, same scheme as
    :func:`quantize_weights` — but a 1x1 conv needs no dx/dy packing at
    all: it IS a matmul, so the int8 GEMM needs zero extra HBM traffic
    (the 3x3 path's dx packing does not exist here).
    """
    w2 = w.reshape(w.shape[-2], w.shape[-1])
    s = jnp.maximum(jnp.max(jnp.abs(w2), axis=0) / INT8_MAX, 1e-12)
    q = jnp.clip(jnp.round(w2 / s), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    return q, s


def conv1x1_int8(x_i8: jnp.ndarray, s_x, w_q: jnp.ndarray, s_w,
                 out_dtype=jnp.float32):
    """1x1/SAME conv on int8 activations = one int8 GEMM, int32 accumulate.

    x_i8: [..., C] int8 with static activation scale ``s_x`` (scalar).
    w_q/s_w: from :func:`quantize_weights_1x1`. No bias/ReLU epilogue —
    ResNet applies FrozenBN after, which absorbs the affine (the caller
    fuses dequant * BN-scale into one elementwise pass under XLA).
    Returns dequantized ``out_dtype`` activations ``[..., Co]``.
    """
    acc = jax.lax.dot_general(
        x_i8, w_q,
        dimension_numbers=(((x_i8.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * (s_x * s_w)).astype(out_dtype)


def conv3x3_f32_reference(x, w, bias):
    """Float oracle (XLA conv) for testing the GEMM formulation."""
    y = jax.lax.conv_general_dilated(
        x.astype(jnp.float32), w.astype(jnp.float32),
        window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return jnp.maximum(y + bias, 0.0)
