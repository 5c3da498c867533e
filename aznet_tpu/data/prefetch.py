"""Multi-process minibatch prefetcher (the ``num_workers`` data layer).

Why this exists (DESIGN.md finding 30): the compiled train step reaches
54% MFU at IMS_PER_BATCH=8, but host minibatch build is ~24-38 ms/img on
one core, so a single prefetch thread caps sustained end-to-end training
at ~40 img/s regardless of batch size. The reference's BlobFetcher
(SURVEY.md §3.3; ``lib/roi_data_layer/layer.py`` in the fast-rcnn
lineage — mount empty, no file:line exists) is a single prefetch
*process*; this is the W-worker generalization with a deterministic
batch stream.

Design constraints, in order:

1. **Workers never touch the accelerator.** A JAX process reserves most
   of the card's memory when it first uses it, so a data worker that
   opened the card would starve the training process it feeds. Workers
   are ``spawn``ed (never forked: a fork would duplicate the parent's
   live client and its runtime threads' lock state) and force
   ``jax_platforms=cpu`` before any JAX use; batch building is pure
   numpy.
2. **The batch stream is deterministic and worker-count-invariant.**
   Batch ``t`` is built with an RNG derived from ``SeedSequence([seed,
   t])``, so the sequence for a given seed is identical for W=1, W=4, or
   the serial oracle — unlike the stateful shared-RNG thread in
   ``train/loop.py`` (kept as the parity default), resharding workers
   cannot reorder sampling. Worker ``w`` builds ``t = w, w+W, ...``; the
   consumer reorders into ``t`` order with a small buffer.
3. **Specs are picklable, closures are not.** ``spawn`` re-imports in a
   fresh interpreter, so workers rebuild their world from a (builder_fn,
   args) pair of module-level objects: the imdb is reconstructed by name
   in each worker (one-time cost), proposals are re-read from their pkl
   path. Anything that cannot be described that way (a custom in-memory
   imdb, the hard-region miner whose pool the main process updates
   mid-run) falls back to the threaded prefetcher in the caller.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["MPPrefetcher", "rng_for_batch", "az_batch_builder",
           "frcnn_batch_builder"]


def rng_for_batch(seed: int, t: int) -> np.random.RandomState:
    """Per-batch-index RandomState, identical for any worker count."""
    ss = np.random.SeedSequence([int(seed) & 0x7FFFFFFF, int(t)])
    return np.random.RandomState(ss.generate_state(4))


def _shard_indices(n_entries: int, pid: int, pcount: int):
    """process_local_indices with the parent's (pid, pcount) passed in —
    workers run single-process JAX-on-CPU and must not re-derive these."""
    idx = list(range(n_entries))[pid::pcount]
    return idx if idx else [0]


def az_batch_builder(args: dict) -> Callable[[int], dict]:
    """Module-level builder: reconstruct the AZ minibatch world in a
    worker and return ``make_batch(t)`` (train/loop.py's closure, with
    the per-index RNG of constraint 2)."""
    from aznet_tpu.data.imdb import get_imdb
    from aznet_tpu.data.minibatch import fixed_canvas, get_az_minibatch

    cfg = args["cfg"]
    imdb = get_imdb(args["imdb_name"])
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    roidb = imdb.roidb
    local_idx = _shard_indices(len(roidb), args["pid"], args["pcount"])
    ims_local = args["ims_local"]
    seed = args["seed"]

    def make_batch(t: int) -> dict:
        rng = rng_for_batch(seed, t)
        idx = rng.choice(local_idx, size=ims_local)
        return get_az_minibatch(imdb, [roidb[i] for i in idx], cfg, rng,
                                canvas)

    return make_batch


def frcnn_batch_builder(args: dict) -> Callable[[int], dict]:
    """Module-level builder for FRCNN minibatches; proposals come from
    the pkl path (train/loop.py's closure flips cached proposals for
    flipped entries — same math here)."""
    from aznet_tpu.data.imdb import get_imdb
    from aznet_tpu.data.minibatch import fixed_canvas, get_frcnn_minibatch

    cfg = args["cfg"]
    imdb = get_imdb(args["imdb_name"])
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    roidb = imdb.roidb
    local_idx = _shard_indices(len(roidb), args["pid"], args["pcount"])
    ims_local = args["ims_local"]
    seed = args["seed"]
    with open(args["proposals_path"], "rb") as f:
        props_all = pickle.load(f)

    def make_batch(t: int) -> dict:
        rng = rng_for_batch(seed, t)
        idx = rng.choice(local_idx, size=ims_local)
        entries = [roidb[i] for i in idx]
        props = []
        for i, entry in zip(idx, entries):
            p = np.asarray(props_all[int(i) % len(props_all)])[:, :4].copy()
            if entry.get("flipped"):
                w = entry["width"]
                p[:, [0, 2]] = w - p[:, [2, 0]] - 1.0
            props.append(p)
        return get_frcnn_minibatch(imdb, entries, props, cfg, rng, canvas)

    return make_batch


def _worker_main(builder, builder_args, w: int, n_workers: int, q, stop):
    # Constraint 1: this interpreter never opens the accelerator; pin the
    # platform to CPU before any JAX-importing code.
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass  # already configured by an inherited test env

    make_batch = builder(builder_args)
    t = w
    while not stop.is_set():
        batch = make_batch(t)
        while not stop.is_set():
            try:
                q.put((t, batch), timeout=0.5)
                break
            except queue.Full:
                continue
        t += n_workers


class MPPrefetcher:
    """W-process prefetcher with the same ``next()/close()`` surface as
    train/loop.py's threaded ``_Prefetcher``.

    ``builder(builder_args) -> make_batch(t)`` must both be picklable
    (module-level function + plain-data dict); batches come back in
    exact ``t = 0, 1, 2, ...`` order via a reorder buffer (bounded by
    ~W + depth entries: worker w's next index is at most W+depth ahead
    of the oldest unconsumed one).
    """

    def __init__(self, builder, builder_args: dict, workers: int,
                 depth: int = 4):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        ctx = mp.get_context("spawn")
        self._stop = ctx.Event()
        self._q = ctx.Queue(maxsize=max(depth, workers))
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(builder, builder_args, w, workers,
                              self._q, self._stop),
                        daemon=True)
            for w in range(workers)
        ]
        for p in self._procs:
            p.start()
        self._buf: dict = {}
        self._t = 0

    def next(self):
        while self._t not in self._buf:
            t, batch = self._q.get()
            self._buf[t] = batch
        out = self._buf.pop(self._t)
        self._t += 1
        return out

    def close(self):
        self._stop.set()
        # Drain so workers blocked on put() observe the stop event.
        try:
            while True:
                self._q.get(timeout=0.2)
        except queue.Empty:
            pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._q.close()
        self._q.join_thread()
