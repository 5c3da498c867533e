"""Triton NMS kernels in interpret mode vs the host ``nms``, the packed
suppression words vs a NumPy build, and ``nms_mask``'s dispatch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aznet_tpu.ops import nms_mask
from aznet_tpu.ops.nms import fixpoint_iterations
from aznet_tpu.ops.pallas import nms_triton
from aznet_tpu.utils import device
from aznet_tpu.utils.gpu_checks import (device_keep_order, diverse_boxes,
                                        host_keep_order)


def _triton(boxes, scores, thresh, valid=None, offset=1.0):
    return np.asarray(nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                               thresh, valid=valid, offset=offset,
                               impl="triton", interpret=True))


@pytest.mark.parametrize("n,offset,extent,ties,pad", [
    (1, 1.0, 200.0, False, False),
    (37, 1.0, 200.0, False, False),      # not a multiple of any block
    (130, 0.0, 200.0, False, False),     # offset 0 (half-open boxes)
    (200, 1.0, 200.0, True, False),      # heavy score ties
    (257, 1.0, 120.0, False, False),     # dense: chains across blocks
    (300, 1.0, 300.0, False, True),      # padding mask
    (128, 1.0, 80.0, True, True),        # ties + padding + dense
    (513, 0.0, 400.0, False, True),
])
def test_triton_interpret_matches_host(n, offset, extent, ties, pad):
    rng = np.random.RandomState(n)
    boxes = diverse_boxes(rng, (n,), extent=extent, lo=5.0, hi=60.0)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    valid = rng.rand(n) > 0.3 if pad else np.ones(n, bool)
    keep = _triton(boxes, scores, 0.5, jnp.asarray(valid), offset)
    assert not keep[~valid].any()
    assert (device_keep_order(keep, scores)
            == host_keep_order(boxes, scores, 0.5, offset, valid))


def test_triton_cross_block_chain():
    """A suppresses B, B would suppress C: C survives; the chain crosses
    word and row-block boundaries (boxes 31 -> 32 -> 64)."""
    n = 96
    boxes = np.stack([np.array([1000.0 * (i + 1), 0, 1000.0 * (i + 1) + 9, 9])
                      for i in range(n)]).astype(np.float32)
    boxes[[31, 32, 64]] = [[0, 0, 10, 10], [5, 0, 15, 10], [10, 0, 20, 10]]
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    keep = _triton(boxes, scores, 0.3)
    assert keep[31] and not keep[32] and keep[64]
    assert device_keep_order(keep, scores) == host_keep_order(
        boxes, scores, 0.3)


def test_triton_batched_streams_vmap():
    rng = np.random.RandomState(2)
    boxes = diverse_boxes(rng, (3, 150), extent=300.0, hi=80.0)
    scores = rng.rand(3, 150).astype(np.float32)
    keep = np.asarray(jax.vmap(lambda b, s: nms_mask(
        b, s, 0.5, impl="triton", interpret=True))(jnp.asarray(boxes),
                                                    jnp.asarray(scores)))
    fix = np.asarray(jax.vmap(lambda b, s: nms_mask(
        b, s, 0.5, impl="fixpoint"))(jnp.asarray(boxes), jnp.asarray(scores)))
    np.testing.assert_array_equal(keep, fix)
    for i in range(3):
        assert device_keep_order(keep[i], scores[i]) == host_keep_order(
            boxes[i], scores[i], 0.5)


def test_suppression_words_match_numpy():
    """Bit k of word w in row i is set iff box 32w+k comes after box i and
    their IoU exceeds the threshold."""
    rng = np.random.RandomState(4)
    n = nms_triton.padded_size(100)
    boxes = diverse_boxes(rng, (n,), extent=150.0, hi=60.0)
    words = np.asarray(nms_triton.suppression_mask(
        jnp.asarray(boxes), 0.4, 1.0, interpret=True))
    assert words.shape == (n, n // 32) and words.dtype == np.uint32
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    got = bits.reshape(n, n).astype(bool)
    x1, y1, x2, y2 = boxes.T.astype(np.float64)
    iw = np.minimum(x2[:, None], x2) - np.maximum(x1[:, None], x1) + 1
    ih = np.minimum(y2[:, None], y2) - np.maximum(y1[:, None], y1) + 1
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iou = inter / (area[:, None] + area - inter)
    want = (iou > 0.4) & np.triu(np.ones((n, n), bool), k=1)
    np.testing.assert_array_equal(got, want)


def test_padded_size():
    assert nms_triton.padded_size(1) == 128
    assert nms_triton.padded_size(129) == 256
    assert nms_triton.padded_size(2048) == 2048
    assert nms_triton.padded_size(4097) == 8192


def test_nms_mask_dispatch(monkeypatch):
    """'auto' asks utils/device.py; off the GPU that is the fixpoint, and a
    forced choice reaches the named implementation."""
    assert device.nms_impl() == "fixpoint"  # tests run on the CPU
    seen = []
    real = nms_triton.nms_sorted_triton

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(nms_triton, "nms_sorted_triton", spy)
    rng = np.random.RandomState(5)
    boxes = jnp.asarray(diverse_boxes(rng, (64,), extent=200.0))
    scores = jnp.asarray(rng.rand(64).astype(np.float32))
    auto = np.asarray(nms_mask(boxes, scores, 0.5))
    assert not seen
    monkeypatch.setattr(device, "nms_impl", lambda: "triton")
    forced = np.asarray(nms_mask(boxes, scores, 0.5, interpret=True))
    assert seen
    np.testing.assert_array_equal(auto, forced)
    with pytest.raises(ValueError, match="unknown NMS impl"):
        nms_mask(boxes, scores, 0.5, impl="bitonic")


def test_fixpoint_iterations_counts_chain_depth():
    # A chain of k boxes, each overlapping only its neighbours, needs k
    # sweeps to settle (plus the one that sees no change).
    k = 6
    boxes = jnp.asarray([[10.0 * i, 0, 10.0 * i + 19, 10] for i in range(k)])
    scores = jnp.linspace(1.0, 0.5, k)
    assert int(fixpoint_iterations(boxes, scores, 0.3)) >= k - 1
    far = jnp.asarray([[100.0 * i, 0, 100.0 * i + 9, 9] for i in range(k)])
    assert int(fixpoint_iterations(far, scores, 0.3)) == 1
