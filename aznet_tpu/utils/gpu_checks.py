"""Checks that only a GPU can run: kernels compiled for the card, compared
with their plain references.

``tests/test_gpu.py`` runs each check under the ``gpu`` marker (skipped
where JAX finds no GPU), and ``chip_smoke.py`` runs them all on the card.
Each check raises ``AssertionError`` on a mismatch and returns a one-line
summary.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def diverse_boxes(rng, shape, extent=2000.0, lo=5.0, hi=300.0):
    """``[..., 4]`` boxes with uniform corners and sizes (the NMS
    benchmark's streams)."""
    xy = rng.uniform(0, extent, shape + (2,)).astype(np.float32)
    wh = rng.uniform(lo, hi, shape + (2,)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def host_keep_order(boxes, scores, thresh, offset=1.0, valid=None):
    """Indices the host ``nms`` keeps, highest score first."""
    from aznet_tpu.ops.nms import nms

    idx = np.arange(len(scores)) if valid is None else np.nonzero(valid)[0]
    dets = np.concatenate([boxes[idx], scores[idx, None]], 1)
    return [int(idx[k]) for k in nms(dets, thresh, offset)]


def device_keep_order(keep, scores):
    """Kept indices ordered like the host oracle: score desc, index asc."""
    kept = np.nonzero(np.asarray(keep))[0]
    return [int(i) for i in kept[np.lexsort((kept, -scores[kept]))]]


def check_nms_triton_exact() -> str:
    """The Triton NMS kernels, compiled for the card, keep exactly the host
    ``nms`` set in the same order: odd N, padding masks, score ties,
    dense clusters (long suppression chains) and both offsets."""
    from aznet_tpu.ops.nms import nms_mask

    rng = np.random.RandomState(0)
    cases = 0
    for n, offset, ties, dense in ((37, 1.0, False, False),
                                   (1000, 0.0, False, False),
                                   (2048, 1.0, True, False),
                                   (4096, 1.0, False, True)):
        extent = 200.0 if dense else 2000.0
        boxes = diverse_boxes(rng, (n,), extent=extent)
        scores = rng.rand(n).astype(np.float32)
        if ties:
            scores = np.round(scores * 8) / 8
        valid = rng.rand(n) > 0.1
        keep = jax.jit(lambda b, s, v, o=offset: nms_mask(
            b, s, 0.5, valid=v, offset=o, impl="triton"))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
        want = host_keep_order(boxes, scores, 0.5, offset, valid)
        got = device_keep_order(keep, scores)
        assert got == want, (n, offset, len(got), len(want))
        cases += 1
    return f"triton NMS == host nms on {cases} cases"


def check_nms_auto_matches_host() -> str:
    """``nms_mask(impl='auto')`` on the card (the pipeline's choice),
    batched with vmap, equals the host oracle per stream."""
    from aznet_tpu.ops.nms import nms_mask
    from aznet_tpu.utils import device

    rng = np.random.RandomState(1)
    boxes = diverse_boxes(rng, (4, 3000))
    scores = rng.rand(4, 3000).astype(np.float32)
    keep = np.asarray(jax.jit(jax.vmap(
        lambda b, s: nms_mask(b, s, 0.7)))(jnp.asarray(boxes),
                                           jnp.asarray(scores)))
    for i in range(4):
        assert (device_keep_order(keep[i], scores[i])
                == host_keep_order(boxes[i], scores[i], 0.7))
    return f"nms_mask auto ({device.nms_impl()}) == host nms, 4 streams"


CHECKS = (check_nms_triton_exact, check_nms_auto_matches_host)
