"""On-device adjacency-and-zoom search as a ``lax.while_loop``.

Reference call stack being replaced (SURVEY.md §3.1): ``im_propose`` runs the
trunk once, then host-loops over tree levels — writing a rois blob, calling
``net.forward`` (device round-trip per level), reading back zoom/adjacency,
decoding deltas and dividing regions in per-box NumPy. Here the whole loop is
a single compiled program over fixed shapes:

  state = (level, frontier [R,4]+valid, candidates [B,4]+scores)
  while level < MAX_LEVELS and any(frontier valid):
    head(feat, frontier)                      # ROI pool + fc + heads
    decode K adjacency boxes per region       # bbox_transform_inv, fused
    merge R*K scored candidates into top-B    # lax.top_k eviction
    children = divide(zoom > Tz regions)      # 5 per region
    frontier = top-R children by parent zoom  # score-based eviction

The padded-frontier + top-K-eviction design makes every shape static (XLA
requirement) at a controlled cost: recall loss only occurs when more than R
regions want to zoom at one level or more than B candidates are live —
both measurable against the NumPy oracle (tests/test_search.py).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from aznet_tpu.config import SearchConfig
from aznet_tpu.ops.boxes import bbox_transform_inv, clip_boxes
from aznet_tpu.ops.nms import nms_topk
from aznet_tpu.search.templates import (
    adjacency_templates,
    template_boxes,
    divide_regions,
    NUM_DIVISIONS,
)

NEG_INF = -1e30  # large-finite sentinel (avoids inf-inf NaN hazards)


def seed_count(seed_levels: int) -> int:
    """Static number of initial frontier regions: 1 + 5 + 25 + ..."""
    return sum(NUM_DIVISIONS ** l for l in range(seed_levels + 1))


def frontier_schedule(scfg: SearchConfig) -> Tuple[int, ...]:
    """Lossless per-level frontier capacities (static shapes per level).

    Level ``i`` of the search can hold at most ``seed_count * 5**i`` live
    regions, so the early levels never need the full FRONTIER_CAP — a single
    static cap pays full head FLOPs (fc6 is the hot matmul) on mostly-padding
    slots at levels 0/1. Capacities are bucketed to multiples of 8 and capped
    at FRONTIER_CAP; the schedule is exactly lossless vs. a uniform cap
    (tested against the oracle in tests/test_search.py).
    """
    n = seed_count(scfg.SEED_LEVELS)
    caps = []
    for _ in range(scfg.MAX_LEVELS):
        caps.append(min(scfg.FRONTIER_CAP, max(8, -(-n // 8) * 8)))
        n *= NUM_DIVISIONS
    return tuple(caps)


def init_frontier(im_h, im_w, scfg: SearchConfig, offset: float = 1.0,
                  cap: int | None = None):
    """Whole image + SEED_LEVELS of its divisions, padded to ``cap``
    (default FRONTIER_CAP).

    im_h/im_w may be traced scalars (dynamic valid extents on a static
    canvas). Returns (boxes [R, 4], valid [R]).
    """
    r = scfg.FRONTIER_CAP if cap is None else cap
    whole = jnp.stack(
        [jnp.zeros_like(jnp.asarray(im_w, jnp.float32)),
         jnp.zeros_like(jnp.asarray(im_h, jnp.float32)),
         jnp.asarray(im_w, jnp.float32) - offset,
         jnp.asarray(im_h, jnp.float32) - offset]
    )[None, :]
    seeds = [whole]
    current = whole
    for _ in range(scfg.SEED_LEVELS):
        current = divide_regions(current, scfg.DIV_OVERLAP, offset).reshape(-1, 4)
        seeds.append(current)
    boxes = jnp.concatenate(seeds, axis=0)
    n = boxes.shape[0]
    if n > r:
        raise ValueError(
            f"SEED_LEVELS={scfg.SEED_LEVELS} yields {n} seed regions "
            f"> FRONTIER_CAP={r}"
        )
    boxes = jnp.pad(boxes, ((0, r - n), (0, 0)))
    valid = jnp.arange(r) < n
    return boxes, valid


def az_search(
    roi_forward: Callable,
    feat,
    im_hw: Tuple,
    scfg: SearchConfig,
    num_templates: int = 11,
    offset: float = 1.0,
    collect_frontier: bool = False,
):
    """Run the zoom search over one image's features.

    Args:
      roi_forward: ``(feat, rois [R, 4]) -> dict`` with LOGITS ``zoom [R]``,
        ``adj_score [R, K]`` and deltas ``adj_delta [R, K, 4]`` (the AZNet
        head under ``model.apply``).
      feat: [h, w, C] trunk features of the (scaled) image.
      im_hw: (height, width) valid extents of the scaled image; traced OK.
      scfg: search config (thresholds, caps, NMS, proposal count).
      collect_frontier: also return every frontier region the head actually
        evaluated (training-time hard-region mining samples anchors from
        the model's OWN search distribution instead of only the static
        division tree + gt jitter).

    Returns:
      ``(boxes [N, 4], scores [N], valid [N])`` with N = NUM_PROPOSALS, in
      the SCALED image's coordinates (callers divide by im_scale — the
      reference's ``boxes / im_scale`` tail in im_propose). With
      ``collect_frontier``: ``(boxes, scores, valid, visited [V, 4],
      visited_valid [V])`` where V = MAX_LEVELS * FRONTIER_CAP.
    """
    r_cap = scfg.FRONTIER_CAP
    templates = adjacency_templates(num_templates)
    im_h = jnp.asarray(im_hw[0], jnp.float32)
    im_w = jnp.asarray(im_hw[1], jnp.float32)
    sched = frontier_schedule(scfg)

    def level_step(f_boxes, f_valid, next_cap):
        """One tree level: head on the frontier -> (candidates, children).

        Shapes are static per call site; ``next_cap`` sizes the child
        frontier (the per-level capacity schedule).
        """
        out = roi_forward(feat, f_boxes)
        zoom_p = jax.nn.sigmoid(out["zoom"])  # [R]
        adj_p = jax.nn.sigmoid(out["adj_score"])  # [R, K]
        deltas = out["adj_delta"]  # [R, K, 4]

        # Decode adjacency candidates against the template anchors.
        anchors = template_boxes(f_boxes, templates, offset)  # [R, K, 4]
        boxes = bbox_transform_inv(anchors, deltas, offset, clip=scfg.BBOX_XFORM_CLIP)
        boxes = clip_boxes(boxes, (im_h, im_w), offset)
        scores = jnp.where(f_valid[:, None], adj_p, NEG_INF)

        # Zoom: divide qualifying regions, keep top-next_cap children by
        # parent zoom.
        children = divide_regions(f_boxes, scfg.DIV_OVERLAP, offset)  # [R, 5, 4]
        cw = children[..., 2] - children[..., 0] + offset
        ch = children[..., 3] - children[..., 1] + offset
        parent_ok = f_valid & (zoom_p > scfg.ZOOM_THRESH)
        child_ok = parent_ok[:, None] & (jnp.minimum(cw, ch) >= scfg.MIN_SIZE)
        priority = jnp.where(child_ok, zoom_p[:, None], NEG_INF).reshape(-1)
        cboxes = children.reshape(-1, 4)
        if next_cap > priority.shape[0]:  # schedule can't grow faster than 5x
            pad = next_cap - priority.shape[0]
            priority = jnp.pad(priority, (0, pad), constant_values=NEG_INF)
            cboxes = jnp.pad(cboxes, ((0, pad), (0, 0)))
        top_p, top_i = jax.lax.top_k(priority, next_cap)
        return (boxes.reshape(-1, 4), scores.reshape(-1),
                cboxes[top_i], top_p > NEG_INF)

    # Unrolled prefix: the early levels where the lossless capacity is below
    # FRONTIER_CAP (level 0 holds only the seeds). Each gets its own static
    # shape — at the default cfg this cuts head FLOPs per image by ~25%
    # ((8+32)/64 of two levels' worth) with bit-identical results.
    f_boxes, f_valid = init_frontier(im_h, im_w, scfg, offset, cap=sched[0])
    cand_b, cand_s = [], []
    vis_b, vis_v = [], []  # frontier regions evaluated (collect_frontier)
    lvl = 0
    while lvl < scfg.MAX_LEVELS and sched[lvl] != r_cap:
        next_cap = sched[lvl + 1] if lvl + 1 < scfg.MAX_LEVELS else sched[lvl]
        if collect_frontier:
            pad = r_cap - f_boxes.shape[0]
            vis_b.append(jnp.pad(f_boxes, ((0, pad), (0, 0))))
            vis_v.append(jnp.pad(f_valid, (0, pad)))
        b, s, f_boxes, f_valid = level_step(f_boxes, f_valid, next_cap)
        cand_b.append(b)
        cand_s.append(s)
        lvl += 1

    # Steady-state tail: remaining levels all at FRONTIER_CAP, one
    # while_loop (early exit when the frontier empties). One static slot per
    # (level, region, template): no per-level eviction at all — cheaper than
    # a top-K merge each level AND exactly lossless.
    rem = scfg.MAX_LEVELS - lvl
    if rem > 0:
        per_level = r_cap * num_templates
        tail_total = rem * per_level
        c_boxes0 = jnp.zeros((tail_total, 4), jnp.float32)
        c_scores0 = jnp.full((tail_total,), NEG_INF, jnp.float32)
        v_boxes0 = jnp.zeros((rem * r_cap, 4), jnp.float32)
        v_valid0 = jnp.zeros((rem * r_cap,), bool)

        def cond(state):
            level = state[0]
            f_valid = state[2]
            return (level < rem) & jnp.any(f_valid)

        def body(state):
            level, f_boxes, f_valid, c_boxes, c_scores, vb, vv = state
            if collect_frontier:
                vb = jax.lax.dynamic_update_slice(
                    vb, f_boxes, (level * r_cap, 0))
                vv = jax.lax.dynamic_update_slice(vv, f_valid, (level * r_cap,))
            b, s, f_boxes, f_valid = level_step(f_boxes, f_valid, r_cap)
            c_boxes = jax.lax.dynamic_update_slice(
                c_boxes, b, (level * per_level, 0))
            c_scores = jax.lax.dynamic_update_slice(
                c_scores, s, (level * per_level,))
            return level + 1, f_boxes, f_valid, c_boxes, c_scores, vb, vv

        state = (jnp.asarray(0, jnp.int32), f_boxes, f_valid, c_boxes0,
                 c_scores0, v_boxes0, v_valid0)
        _, _, _, tb, ts, tvb, tvv = jax.lax.while_loop(cond, body, state)
        cand_b.append(tb)
        cand_s.append(ts)
        if collect_frontier:
            vis_b.append(tvb)
            vis_v.append(tvv)

    c_boxes = jnp.concatenate(cand_b, axis=0)
    c_scores = jnp.concatenate(cand_s, axis=0)
    total = c_scores.shape[0]

    # Cap the NMS input to CAND_BUF by score (single top-K at the END — the
    # only lossy step, and only when the accumulated slots exceed CAND_BUF).
    if total > scfg.CAND_BUF:
        c_scores, idx = jax.lax.top_k(c_scores, scfg.CAND_BUF)
        c_boxes = c_boxes[idx]

    # Confidence threshold, NMS, top-N — the reference's im_propose tail.
    final_scores = jnp.where(c_scores >= scfg.CONF_THRESH, c_scores, NEG_INF)
    live = final_scores > NEG_INF
    boxes, scores, valid = nms_topk(
        c_boxes, final_scores, scfg.NMS_THRESH, scfg.NUM_PROPOSALS,
        valid=live, offset=offset,
    )
    if collect_frontier:
        visited = jnp.concatenate(vis_b, axis=0)
        visited_valid = jnp.concatenate(vis_v, axis=0)
        return boxes, scores, valid, visited, visited_valid
    return boxes, scores, valid
