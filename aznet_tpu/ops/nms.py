"""Non-maximum suppression: host oracle + on-device exact greedy NMS.

Reference equivalent (SURVEY.md §2.3): the Cython CPU greedy NMS in
``lib/utils/nms.pyx`` (+ pure-Python ``nms.py`` fallback) — inherently
sequential host code, one box at a time. The device design:

- ``nms``        — host NumPy greedy, bit-parity oracle for eval/tests
                   (C++ fast path via aznet_tpu.utils.native when built).
- ``nms_mask``   — exact greedy NMS on device: an antitone fixpoint over
                   the suppression matrix (``keep = ~any(S & keep)``
                   iterated to convergence; one masked (N,N) reduction per
                   sweep, sweeps = depth of the suppression DAG), or the
                   blocked-bitmask Triton kernels
                   (``aznet_tpu.ops.pallas.nms_triton``). Fully
                   jit/vmap-able, static shapes.
- ``nms_jax``    — ``nms_mask`` on ``[N, 5]`` dets.
- ``nms_topk``   — nms_mask + top-k extraction with padding, for pipelines.

Convention notes (parity with the reference): "+1" areas via ``offset``;
suppression is strict ``IoU > thresh`` (the Cython code keeps ``ovr <=
thresh``); ties in score are broken toward the lower original index (the
reference's unstable quicksort makes ties platform-defined — tests use
distinct scores).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from aznet_tpu.ops.iou import bbox_overlaps
from aznet_tpu.utils import device


# ---------------------------------------------------------------------------
# Host oracle (reference lib/utils/nms.py semantics)
# ---------------------------------------------------------------------------


def nms(dets: np.ndarray, thresh: float, offset: float = 1.0) -> list:
    """Greedy NMS over ``dets [N, 5] = [x1, y1, x2, y2, score]`` on host.

    Returns the list of kept indices, highest score first — the same
    signature and semantics as the reference's ``nms(dets, thresh)``.
    Uses the C++ library (csrc/) when built, NumPy otherwise.
    """
    if dets.size == 0:
        return []
    from aznet_tpu.utils import native

    if native.available():
        return native.nms(np.asarray(dets), thresh, offset)
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + offset) * (y2 - y1 + offset)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + offset)
        h = np.maximum(0.0, yy2 - yy1 + offset)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep


# ---------------------------------------------------------------------------
# On-device exact greedy NMS
# ---------------------------------------------------------------------------


def _fixpoint_sorted(sboxes, svalid, iou_threshold, offset: float):
    """Fixpoint keep mask over score-sorted boxes -> (keep, iterations)."""
    n = sboxes.shape[0]
    iou = bbox_overlaps(sboxes, sboxes, offset=offset)
    tri = jnp.tril(jnp.ones((n, n), dtype=bool), k=-1)  # [i, j]: j before i
    supp = tri & (iou > iou_threshold) & svalid[None, :] & svalid[:, None]

    def cond(state):
        return state[1]

    def body(state):
        keep, _, it = state
        new_keep = ~jnp.any(supp & keep[None, :], axis=1) & svalid
        return new_keep, jnp.any(new_keep != keep), it + 1

    keep, _, iters = jax.lax.while_loop(
        cond, body, (svalid, jnp.asarray(True), jnp.int32(0)))
    return keep, iters


def _score_order(scores, valid):
    """Stable descending-score order with invalid boxes last."""
    neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
    return jnp.argsort(-jnp.where(valid, scores, neg_inf), stable=True)


def nms_mask(boxes, scores, iou_threshold, valid=None, offset: float = 1.0,
             impl: str = "auto", interpret: bool = False):
    """Exact greedy-NMS keep mask, in the ORIGINAL box order.

    ``boxes [N, 4]``, ``scores [N]``, optional ``valid [N]`` bool mask for
    padded inputs. Returns ``keep [N]`` bool. jit/vmap-safe, static shapes.

    ``impl``: 'auto' (``utils/device.py::nms_impl`` chooses), 'fixpoint',
    or 'triton' (``ops/pallas/nms_triton.py``: blocked suppression bitmask
    + one sequential scan, Pallas through Triton; ``interpret=True`` runs
    it on the CPU, for tests). Both are exact greedy (tested equal).

    Both sort by score in XLA first (stable, invalid last) and scatter the
    sorted keep mask back. Fixpoint algorithm: build the
    strict-lower-triangular suppression matrix ``S[i, j] = (j < i) &
    (IoU > t)``; iterate the antitone map ``keep <- ~any_j(S[:, j] &
    keep[j])`` from all-ones until fixpoint. By induction on sorted order
    the fixpoint is exactly the greedy solution; convergence takes at most
    the suppression-DAG depth iterations (bounded by N), so its cost
    depends on the data.
    """
    n = boxes.shape[0]
    if impl == "auto":
        impl = device.nms_impl()
    if valid is None:
        valid = jnp.ones((n,), dtype=bool)
    order = _score_order(scores, valid)
    sboxes = boxes[order]
    svalid = valid[order]
    if impl == "triton":
        from aznet_tpu.ops.pallas.nms_triton import nms_sorted_triton

        keep_sorted = nms_sorted_triton(sboxes, svalid, iou_threshold,
                                        offset, interpret=interpret)
    elif impl == "fixpoint":
        keep_sorted, _ = _fixpoint_sorted(sboxes, svalid, iou_threshold,
                                          offset)
    else:
        raise ValueError(f"unknown NMS impl {impl!r}")
    # Scatter back to original order.
    return jnp.zeros((n,), dtype=bool).at[order].set(keep_sorted)


def fixpoint_iterations(boxes, scores, iou_threshold, valid=None,
                        offset: float = 1.0):
    """Sweeps the fixpoint takes to converge on these boxes (int32)."""
    if valid is None:
        valid = jnp.ones((boxes.shape[0],), dtype=bool)
    order = _score_order(scores, valid)
    return _fixpoint_sorted(boxes[order], valid[order], iou_threshold,
                            offset)[1]


def nms_jax(dets, thresh, valid=None, offset: float = 1.0):
    """Device analogue of ``nms(dets, thresh)``: keep mask for [N,5] dets."""
    return nms_mask(dets[:, :4], dets[:, 4], thresh, valid=valid, offset=offset)


def nms_topk(boxes, scores, iou_threshold, k, valid=None, offset: float = 1.0):
    """NMS then top-k by score. Returns ``(boxes [k,4], scores [k], valid [k])``.

    Padded with zeros / -inf where fewer than k boxes survive. Static
    shapes — the on-device replacement for the reference's host
    "NMS then slice top-N" pattern in ``im_propose``.
    """
    keep = nms_mask(boxes, scores, iou_threshold, valid=valid, offset=offset)
    neg_inf = jnp.asarray(-jnp.inf, scores.dtype)
    kept_scores = jnp.where(keep, scores, neg_inf)
    k_eff = min(k, boxes.shape[0])  # fewer candidates than k: pad outputs
    top_scores, top_idx = jax.lax.top_k(kept_scores, k_eff)
    out_valid = top_scores > neg_inf
    out_boxes = jnp.where(out_valid[:, None], boxes[top_idx], 0.0)
    out_scores = jnp.where(out_valid, top_scores, 0.0)
    if k_eff < k:
        pad = k - k_eff
        out_boxes = jnp.pad(out_boxes, ((0, pad), (0, 0)))
        out_scores = jnp.pad(out_scores, (0, pad))
        out_valid = jnp.pad(out_valid, (0, pad))
    return out_boxes, out_scores, out_valid
