"""Training losses.

Reference equivalents (SURVEY.md §2.3): Caffe's CUDA ``SmoothL1LossLayer``
(with inside-weights masking) and the prototxt-defined sigmoid cross-entropy
/ softmax losses. These are a few fused elementwise ops — no kernels needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def smooth_l1_loss(pred, target, inside_weights=None, outside_weights=None, sigma: float = 1.0):
    """Smooth-L1 (Huber) loss, Caffe SmoothL1LossLayer semantics.

    ``loss = 0.5 * (sigma*d)^2        if |d| < 1/sigma^2
             |d| - 0.5/sigma^2        otherwise``
    with ``d = inside_weights * (pred - target)``; the result is multiplied
    by ``outside_weights`` and summed. Reference:
    caffe-fast-rcnn/src/caffe/layers/smooth_L1_loss_layer.{cpp,cu}.
    """
    d = pred - target
    if inside_weights is not None:
        d = d * inside_weights
    s2 = sigma * sigma
    abs_d = jnp.abs(d)
    loss = jnp.where(abs_d < 1.0 / s2, 0.5 * s2 * d * d, abs_d - 0.5 / s2)
    if outside_weights is not None:
        loss = loss * outside_weights
    return jnp.sum(loss)


def sigmoid_ce_loss(logits, labels, weights=None):
    """Mean sigmoid cross-entropy (Caffe SigmoidCrossEntropyLossLayer).

    Numerically stable log-sum-exp form; ``weights`` masks/weights elements,
    normalization is by the weight sum (mean over contributing elements).
    """
    per = jnp.maximum(logits, 0.0) - logits * labels + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    if weights is None:
        return jnp.mean(per)
    denom = jnp.maximum(jnp.sum(weights), 1.0)
    return jnp.sum(per * weights) / denom


def softmax_ce_loss(logits, labels, weights=None):
    """Mean softmax cross-entropy with integer ``labels`` (Caffe SoftmaxWithLoss)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    per = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    if weights is None:
        return jnp.mean(per)
    denom = jnp.maximum(jnp.sum(weights), 1.0)
    return jnp.sum(per * weights) / denom
