"""ROI heads: AZ (zoom + adjacency) and Fast-R-CNN (cls + bbox).

Reference equivalents (SURVEY.md §2.1): the prototxt head stacks —
ROIPool(7x7) -> fc6(4096)/ReLU/Dropout -> fc7(4096)/ReLU/Dropout -> heads.
AZ head: 1 zoom sigmoid, K adjacency sigmoids, 4K regression outputs.
FRCNN head: 21-way softmax ``cls_score`` + 84-d ``bbox_pred``.

Init mirrors the lineage: gaussian(0.01) for scores, gaussian(0.001) for
bbox regressors, zeros for biases. Heads return LOGITS; sigmoids/softmax are
applied by the callers (losses want logits, search wants probabilities).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from aznet_tpu.models.layers import Module, dense, dense_params, dropout


@dataclasses.dataclass(frozen=True)
class _FCStack(Module):
    """fc6/fc7 with ReLU + dropout, shared by both heads.

    ``int8_scales = (s_in, s_mid)`` switches inference to int8 GEMMs
    (ops/conv_int8 quantization scheme): the pooled features quantize with
    the calibrated trunk-output scale, fc6's output with ``s_mid``. Same
    params.
    """

    fc_dim: int = 4096
    # fc7 width; 0 = fc_dim (VGG_CNN_M_1024 uses 4096/1024).
    fc7_dim: int = 0
    dropout: float = 0.5
    dtype: Any = jnp.bfloat16
    int8_scales: tuple = ()

    def init_params(self, key, x) -> dict:
        din = 1
        for d in x.shape[1:]:
            din *= d
        return {"fc6": dense_params(key.child("fc6"), din, self.fc_dim),
                "fc7": dense_params(key.child("fc7"), self.fc_dim,
                                    self.fc7_dim or self.fc_dim)}

    def __call__(self, p, x, train: bool = False, rng=None):
        # x: [R, P, P, C] pooled roi features. int8 input = ALREADY
        # quantized at s_in (the int8 roi_align path) — valid only for the
        # int8 inference stack, which then skips its own quantize.
        x = x.reshape((x.shape[0], -1))
        if self.int8_scales and not train:
            return self._int8_stack(p, x)
        if x.dtype == jnp.int8:
            raise ValueError("int8 pooled features reached a non-int8 head "
                             "(missing INT8_HEAD_SCALES, or train=True)")
        r6 = r7 = None
        if train and rng is not None:
            r6, r7 = jax.random.split(rng)
        x = jax.nn.relu(dense(p["fc6"], x, self.dtype))
        x = dropout(x, self.dropout, train, r6)
        x = jax.nn.relu(dense(p["fc7"], x, self.dtype))
        return dropout(x, self.dropout, train, r7)

    def fc6_preact(self, p, x):
        """fc6's pre-ReLU output (int8 head calibration, ops/quant.py)."""
        return dense(p["fc6"], x.reshape((x.shape[0], -1)), self.dtype)

    def _int8_stack(self, p, x):
        from aznet_tpu.ops.conv_int8 import INT8_MAX, quantize_acts

        s_in, s_mid = self.int8_scales

        def int8_dense(x8, sx, name, s_out):
            w = p[name]["kernel"].astype(jnp.float32)
            sw = jnp.maximum(jnp.max(jnp.abs(w), axis=0) / INT8_MAX, 1e-12)
            wq = jnp.clip(jnp.round(w / sw), -INT8_MAX, INT8_MAX
                          ).astype(jnp.int8)
            acc = jax.lax.dot_general(
                x8, wq, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            y = acc.astype(jnp.float32) * (sx * sw) + p[name]["bias"]
            y = jnp.maximum(y, 0.0)
            if s_out is None:
                return y.astype(self.dtype)
            return quantize_acts(y, s_out)

        # roi_align_int8 hands pooled features over pre-quantized at s_in
        # (same scale by convexity) — skip the dequant->requant round trip.
        x8 = x if x.dtype == jnp.int8 else quantize_acts(
            x.astype(jnp.float32), s_in)
        h8 = int8_dense(x8, s_in, "fc6", s_mid)
        return int8_dense(h8, s_mid, "fc7", None)


def _fused_heads(params, x, names):
    """One f32 dot against the column-concatenated kernels of ``names``."""
    w = jnp.concatenate(
        [params[n]["kernel"].astype(jnp.float32) for n in names], axis=1)
    b = jnp.concatenate(
        [params[n]["bias"].astype(jnp.float32) for n in names])
    return jax.lax.dot_general(
        x.astype(jnp.float32), w,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ()))) + b


@dataclasses.dataclass(frozen=True)
class _Head(Module):
    """fc stack + float32 output projections ``_OUTPUTS``:
    ``(name, width multiplier of num_outputs, init stddev)``."""

    fc_dim: int = 4096
    fc7_dim: int = 0
    dropout: float = 0.5
    dtype: Any = jnp.bfloat16
    int8_scales: tuple = ()

    _OUTPUTS = ()

    @property
    def fc(self) -> _FCStack:
        return _FCStack(self.fc_dim, self.fc7_dim, self.dropout, self.dtype,
                        self.int8_scales)

    def _widths(self) -> dict:
        raise NotImplementedError

    def init_params(self, key, roi_feats) -> dict:
        params = {"fc": self.fc.init_params(key.child("fc"), roi_feats)}
        din = self.fc7_dim or self.fc_dim
        widths = self._widths()
        for name, std in self._OUTPUTS:
            params[name] = dense_params(key.child(name), din, widths[name],
                                        std)
        return params

    def _project(self, p, roi_feats, train, rng):
        """Concatenated [R, sum(widths)] float32 outputs."""
        x = self.fc(p["fc"], roi_feats, train, rng)
        names = [n for n, _ in self._OUTPUTS]
        if train:
            return jnp.concatenate(
                [dense(p[n], x, jnp.float32) for n in names], axis=-1)
        # Inference fast path: ONE [fc7, sum-of-heads] dot instead of
        # several separate tiny-N f32 dots — XLA does not merge sibling
        # dots, and these run EVERY search level inside the while_loop. The
        # concat of loop-invariant params is hoisted by XLA; per-column
        # math is identical to the separate projections.
        return _fused_heads(p, x, names)


@dataclasses.dataclass(frozen=True)
class AZHead(_Head):
    """[R, P, P, C] roi features -> zoom/adjacency logits and deltas.

    Returns dict: ``zoom [R]``, ``adj_score [R, K]`` (logits),
    ``adj_delta [R, K, 4]`` (float32 regression outputs).
    """

    num_templates: int = 11

    _OUTPUTS = (("zoom_score", 0.01), ("adj_score", 0.01),
                ("adj_bbox", 0.001))

    def _widths(self):
        k = self.num_templates
        return {"zoom_score": 1, "adj_score": k, "adj_bbox": 4 * k}

    def __call__(self, p, roi_feats, train: bool = False, rng=None):
        k = self.num_templates
        y = self._project(p, roi_feats, train, rng)
        delta = y[..., 1 + k :]
        return {
            "zoom": y[..., 0],
            "adj_score": y[..., 1 : 1 + k],
            "adj_delta": delta.reshape(delta.shape[:-1] + (k, 4)),
        }


@dataclasses.dataclass(frozen=True)
class FRCNNHead(_Head):
    """[R, P, P, C] roi features -> ``cls_score [R, C]``, ``bbox_pred [R, 4C]``."""

    num_classes: int = 21

    _OUTPUTS = (("cls_score", 0.01), ("bbox_pred", 0.001))

    def _widths(self):
        return {"cls_score": self.num_classes,
                "bbox_pred": 4 * self.num_classes}

    def __call__(self, p, roi_feats, train: bool = False, rng=None):
        y = self._project(p, roi_feats, train, rng)
        return {"cls_score": y[..., : self.num_classes],
                "bbox_pred": y[..., self.num_classes :]}
