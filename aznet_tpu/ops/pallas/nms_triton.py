"""Exact greedy NMS on the GPU: two Pallas kernels through Triton.

The blocked-bitmask design of py-faster-rcnn's ``gpu_nms``, for boxes
already sorted by descending score (``ops/nms.py::nms_mask`` sorts in XLA
and scatters the keep mask back to the original order):

1. :func:`_mask_kernel` — one program per (row block, column-word block)
   computes the IoU tile of ``_ROWS`` earlier boxes against
   ``_COL_WORDS * 32`` later boxes and packs ``IoU > thresh`` (later box
   only) into ``uint32`` suppression words: bit ``k`` of ``mask[i, w]``
   says box ``32 w + k`` overlaps box ``i`` and comes after it.
2. :func:`_scan_kernel` — one program walks the boxes in score order with
   the removed-bits vector in registers: box ``i`` is kept iff it is valid
   and its bit is not set, and a kept box ORs its mask row in. It goes 32
   boxes at a time so that the sequential chain runs on one scalar word
   and no load waits on it.

Same semantics as the fixpoint: ``offset`` (+1) areas, strict
``IoU > thresh``, ties already broken by the stable sort, invalid boxes
never kept and never suppressing. Padding boxes (zero area, invalid) sit
after the real ones. Batched streams come from ``jax.vmap``, whose
``pallas_call`` rule adds a grid axis.

Reference equivalent: ``lib/nms/nms_kernel.cu`` (py-faster-rcnn's
``gpu_nms``: 64-box tiles, ``unsigned long long`` words, host scan); here
both passes run on the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_WORD = 32      # boxes per suppression word
_ROWS = 32      # boxes per row block of the mask kernel
_COL_WORDS = 4  # suppression words per column block of the mask kernel


def padded_size(n: int) -> int:
    """Boxes padded to a power of two with at least one full tile."""
    return max(pl.next_power_of_2(n), _ROWS, _WORD * _COL_WORDS)


def _mask_kernel(rx1, ry1, rx2, ry2, cx1, cy1, cx2, cy2, out_ref, *,
                 thresh: float, offset: float):
    i = pl.program_id(0)
    j = pl.program_id(1)
    first_row = i * _ROWS
    last_col = (j + 1) * _COL_WORDS * _WORD - 1

    @pl.when(last_col <= first_row)  # every column box precedes every row
    def _():
        out_ref[...] = jnp.zeros((_ROWS, _COL_WORDS), jnp.uint32)

    @pl.when(last_col > first_row)
    def _():
        row_ids = first_row + jnp.arange(_ROWS, dtype=jnp.int32)
        a_x1, a_y1, a_x2, a_y2 = rx1[...], ry1[...], rx2[...], ry2[...]
        area_a = (a_x2 - a_x1 + offset) * (a_y2 - a_y1 + offset)
        shifts = jnp.left_shift(jnp.uint32(1),
                                jnp.arange(_WORD, dtype=jnp.uint32))
        for w in range(_COL_WORDS):
            b_x1, b_y1, b_x2, b_y2 = (cx1[w, :], cy1[w, :], cx2[w, :],
                                      cy2[w, :])
            col_ids = ((j * _COL_WORDS + w) * _WORD
                       + jnp.arange(_WORD, dtype=jnp.int32))
            iw = (jnp.minimum(a_x2[:, None], b_x2[None, :])
                  - jnp.maximum(a_x1[:, None], b_x1[None, :]) + offset)
            ih = (jnp.minimum(a_y2[:, None], b_y2[None, :])
                  - jnp.maximum(a_y1[:, None], b_y1[None, :]) + offset)
            inter = jnp.maximum(iw, 0.0) * jnp.maximum(ih, 0.0)
            area_b = (b_x2 - b_x1 + offset) * (b_y2 - b_y1 + offset)
            union = area_a[:, None] + area_b[None, :] - inter
            iou = jnp.where(union > 0, inter / union, 0.0)
            over = (iou > thresh) & (col_ids[None, :] > row_ids[:, None])
            bits = jnp.where(over, shifts[None, :], jnp.uint32(0))
            out_ref[:, w] = jnp.sum(bits, axis=1)  # distinct bits: sum == or


def _scan_kernel(valid_ref, mask_ref, keep_ref):
    n, words = mask_ref.shape
    word_ids = jnp.arange(words, dtype=jnp.int32)

    def block(b, removed):
        # One block of 32 boxes: every load is issued up front (none depends
        # on the scan state), the 32 decisions run on one scalar word, and
        # the kept boxes' rows are ORed in once.
        base = b * _WORD
        rows = [mask_ref[base + k, :] for k in range(_WORD)]
        diag = [mask_ref[base + k, b] for k in range(_WORD)]
        valid = [valid_ref[base + k] != 0 for k in range(_WORD)]
        word = jnp.sum(jnp.where(word_ids == b, removed, jnp.uint32(0)))
        for k in range(_WORD):
            hit = jnp.bitwise_and(jnp.right_shift(word, jnp.uint32(k)),
                                  jnp.uint32(1))
            keep = (hit == 0) & valid[k]
            keep_ref[base + k] = keep.astype(jnp.int32)
            word = jnp.where(keep, word | diag[k], word)
            removed = jnp.where(keep, removed | rows[k], removed)
        return removed

    jax.lax.fori_loop(0, n // _WORD, block, jnp.zeros((words,), jnp.uint32))


def suppression_mask(sboxes, thresh: float, offset: float = 1.0,
                     interpret: bool = False):
    """Packed suppression words ``uint32 [Np, Np / 32]`` for score-sorted
    ``sboxes [Np, 4]`` (``Np = padded_size(Np)``)."""
    n = sboxes.shape[0]
    words = n // _WORD
    coords = [sboxes[:, k].astype(jnp.float32) for k in range(4)]
    cols = [c.reshape(words, _WORD) for c in coords]
    row_spec = pl.BlockSpec((_ROWS,), lambda i, j: (i,))
    col_spec = pl.BlockSpec((_COL_WORDS, _WORD), lambda i, j: (j, 0))
    return pl.pallas_call(
        functools.partial(_mask_kernel, thresh=float(thresh),
                          offset=float(offset)),
        out_shape=jax.ShapeDtypeStruct((n, words), jnp.uint32),
        grid=(n // _ROWS, words // _COL_WORDS),
        in_specs=[row_spec] * 4 + [col_spec] * 4,
        out_specs=pl.BlockSpec((_ROWS, _COL_WORDS), lambda i, j: (i, j)),
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="nms_suppression_mask",
    )(*coords, *cols)


def greedy_scan(svalid, mask, interpret: bool = False):
    """Keep mask (bool, sorted order) from the suppression words."""
    n = mask.shape[0]
    keep = pl.pallas_call(
        _scan_kernel,
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="nms_greedy_scan",
    )(svalid.astype(jnp.int32), mask)
    return keep != 0


def nms_sorted_triton(sboxes, svalid, thresh: float, offset: float = 1.0,
                      interpret: bool = False):
    """Exact greedy keep mask for score-sorted ``sboxes [N, 4]`` with
    ``svalid [N]`` (valid boxes first). Returns bool ``[N]``, sorted order."""
    n = sboxes.shape[0]
    pad = padded_size(n) - n
    sboxes = jnp.pad(sboxes.astype(jnp.float32), ((0, pad), (0, 0)))
    svalid = jnp.pad(svalid, (0, pad))
    mask = suppression_mask(sboxes, thresh, offset, interpret=interpret)
    return greedy_scan(svalid, mask, interpret=interpret)[:n]
