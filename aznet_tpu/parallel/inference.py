"""Sharded batched inference over the device mesh.

No reference equivalent (the reference is single-GPU, SURVEY.md §2.4); this
is the data-parallel path: the batch dimension shards over the 'data' axis,
parameters replicate, and XLA runs the whole propose pipeline SPMD with
zero collectives in the forward (embarrassingly parallel over images).
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from aznet_tpu.api import make_propose_batch, make_detect_batch
from aznet_tpu.parallel.mesh import batch_sharding, replicate


def region_roi_wrap(mesh, axes=("model",)):
    """Decorator for the search's per-level head call: constrain the
    frontier rois ``[R, 4]`` to shard R over ``axes``, so XLA partitions the
    ROI pool + fc6/fc7 head matmuls across devices WITHIN one image's search
    level. This is the convnet analogue of sequence parallelism the survey
    calls for (SURVEY.md §5.7 / §2.4 "shard the region batch across devices";
    the reference is single-GPU and host-loops the frontier, §3.1): the work
    unit being split is the zoom-tree frontier, not a token sequence. The
    trunk feature map stays replicated (it is read-only under the search),
    and the frontier update / NMS tail re-gathers automatically.
    """
    spec = NamedSharding(mesh, P(axes, None))

    def wrap(roi_fwd):
        def wrapped(f, r):
            return roi_fwd(f, jax.lax.with_sharding_constraint(r, spec))

        return wrapped

    return wrap


def make_sharded_propose(model, cfg, canvas_hw, mesh, shard_regions=False):
    """jitted ``(params, images [B, H, W, 3]) -> (boxes, scores, valid)``
    with B sharded over mesh axis 'data'. B must divide by the data size.

    ``shard_regions=True`` additionally shards each image's search frontier
    over the 'model' axis (region parallelism — use for latency-bound,
    small-batch serving like the 1080p config; pure DP wins at large B)."""
    wrap = region_roi_wrap(mesh) if shard_regions else None
    fn = make_propose_batch(model, cfg, canvas_hw, roi_wrap=wrap)
    out_shard = batch_sharding(mesh, 1)
    return jax.jit(
        fn,
        in_shardings=(replicate(mesh), batch_sharding(mesh, 4)),
        out_shardings=(out_shard, out_shard, out_shard),
    )


def make_latency_propose(model, cfg, canvas_hw, mesh):
    """Single-image latency path: ``(params, image [H, W, 3]) -> (boxes,
    scores, valid)`` with the search frontier sharded over EVERY mesh device
    (both axes flattened). This is BASELINE config 1's shape (one image at a
    time, the reference's demo path) scaled out: with FRONTIER_CAP=64 on 4
    cards, each device evaluates 16 regions per tree level."""
    wrap = region_roi_wrap(mesh, axes=("data", "model"))
    fn = make_propose_batch(model, cfg, canvas_hw, roi_wrap=wrap)

    def single(params, image):
        boxes, scores, valid = fn(params, image[None])
        return boxes[0], scores[0], valid[0]

    return jax.jit(single, in_shardings=(replicate(mesh), replicate(mesh)),
                   out_shardings=replicate(mesh))


def make_sharded_detect(model, cfg, canvas_hw, mesh):
    """jitted sharded ``(params, images, boxes [B, R, 4]) -> (scores, preds)``."""
    fn = make_detect_batch(model, cfg, canvas_hw)
    out_shard = batch_sharding(mesh, 1)
    return jax.jit(
        fn,
        in_shardings=(replicate(mesh), batch_sharding(mesh, 4),
                      batch_sharding(mesh, 3)),
        out_shardings=(out_shard, out_shard),
    )
