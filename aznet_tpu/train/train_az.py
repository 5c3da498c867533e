"""AZ-Net training step.

Reference equivalent: ``lib/detect/train.py`` (SURVEY.md §2.1 "AZ training")
— a Caffe SGDSolver stepped from Python, with losses defined in the
prototxt: sigmoid CE for the zoom indicator and adjacency confidences,
SmoothL1 with inside-weights for the adjacency deltas. Here the whole
iteration (data-parallel forward/backward over the mesh + SGD update) is one
compiled program.

Batch layout (built by aznet_tpu.data.minibatch):
  images       [B, H, W, 3]   preprocessed (scaled, mean-subtracted BGR)
  rois         [B, R, 4]      anchor regions, scaled-image coords
  roi_valid    [B, R]         padding mask
  zoom_labels  [B, R]         {0, 1}
  adj_labels   [B, R, K]      {0, 1}
  adj_targets  [B, R, K, 4]   normalized regression targets
  adj_inside   [B, R, K, 4]   inside weights (1 on matched templates)
"""

from __future__ import annotations

import functools

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from aznet_tpu.config import Config
from aznet_tpu.ops.losses import sigmoid_ce_loss, smooth_l1_loss
from aznet_tpu.train.optim import make_optimizer


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["step", "params", "opt_state"],
                   meta_fields=["apply_fn", "tx"])
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Parameters, optimizer state and step count as one pytree
    (``apply_fn`` and ``tx`` are static)."""

    step: Any
    apply_fn: Callable
    params: Any
    tx: optax.GradientTransformation
    opt_state: Any

    @classmethod
    def create(cls, *, apply_fn, params, tx) -> "TrainState":
        return cls(step=jnp.asarray(0, jnp.int32), apply_fn=apply_fn,
                   params=params, tx=tx, opt_state=tx.init(params))

    def apply_gradients(self, *, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def az_loss(model, params, batch, dropout_rng=None, pos_weights=(1.0, 1.0),
            remat_trunk=False):
    """Composite AZ loss. Returns (loss, metrics).

    ``pos_weights``: (zoom, adjacency) positive-class CE weights
    (cfg.TRAIN.ZOOM_POS_WEIGHT / ADJ_POS_WEIGHT; 1.0 = reference parity).
    ``remat_trunk`` (cfg.TRAIN.REMAT_TRUNK): rematerialize the trunk
    forward during backward (jax.checkpoint) — drops the 13-conv
    activation stack from HBM (the batch-size limiter at 608x800) for
    one extra trunk forward per step.
    """
    train = dropout_rng is not None
    feats_fn = lambda p, im: model.apply(p, im, method="features")
    if remat_trunk:
        feats_fn = jax.checkpoint(feats_fn)
    feats = feats_fn(params, batch["images"])

    if train:
        # Per-image dropout rngs: split over the batch, else every image in
        # the vmapped head gets an identical mask (same key, same shapes).
        img_rngs = jax.random.split(dropout_rng, batch["images"].shape[0])

        def head_one(feat, rois, rng_i):
            return model.apply(params, feat, rois, method="roi_forward",
                               train=True, rngs={"dropout": rng_i})

        out = jax.vmap(head_one)(feats, batch["rois"], img_rngs)
    else:
        def head_one(feat, rois):
            return model.apply(params, feat, rois, method="roi_forward",
                               train=False)

        out = jax.vmap(head_one)(feats, batch["rois"])
    valid = batch["roi_valid"].astype(jnp.float32)  # [B, R]

    zw, aw = pos_weights
    zoom_w = valid * (1.0 + (zw - 1.0) * batch["zoom_labels"])
    zoom_loss = sigmoid_ce_loss(out["zoom"], batch["zoom_labels"], weights=zoom_w)
    adj_w = valid[..., None] * (1.0 + (aw - 1.0) * batch["adj_labels"])
    adj_loss = sigmoid_ce_loss(out["adj_score"], batch["adj_labels"], weights=adj_w)
    n_rois = jnp.maximum(jnp.sum(valid), 1.0)
    bbox_loss = (
        smooth_l1_loss(out["adj_delta"], batch["adj_targets"],
                       inside_weights=batch["adj_inside"],
                       outside_weights=valid[..., None, None])
        / n_rois
    )
    loss = zoom_loss + adj_loss + bbox_loss
    metrics = {
        "loss": loss,
        "zoom_loss": zoom_loss,
        "adj_loss": adj_loss,
        "bbox_loss": bbox_loss,
    }
    return loss, metrics


def make_az_train_state(cfg: Config, model, rng, image_hw=(64, 64)) -> TrainState:
    images = jnp.zeros((1,) + tuple(image_hw) + (3,), jnp.float32)
    rois = jnp.array([[0.0, 0.0, 31.0, 31.0]])
    params = model.init(rng, images, rois)
    tx = make_optimizer(cfg.TRAIN)
    return TrainState.create(apply_fn=model.apply, params=params, tx=tx)


def make_az_train_step(model, pos_weights=(1.0, 1.0), remat_trunk=False):
    """Pure ``(state, batch, rng) -> (state, metrics)``; jit/shard at will."""

    def step(state: TrainState, batch, rng):
        dropout_rng = jax.random.fold_in(rng, state.step)
        grad_fn = jax.value_and_grad(
            lambda p: az_loss(model, p, batch, dropout_rng, pos_weights,
                              remat_trunk),
            has_aux=True
        )
        (loss, metrics), grads = grad_fn(state.params)
        new_state = state.apply_gradients(grads=grads)
        metrics["grad_norm"] = optax.global_norm(grads)
        return new_state, metrics

    return step
