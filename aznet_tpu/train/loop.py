"""End-to-end training loops (the reference's ``train_net`` entry points).

Reference equivalents (SURVEY.md §3.3): ``lib/detect/train.py::train_net``
and ``lib/fast_rcnn/train.py::train_net`` — SolverWrapper + roidb + a
``solver.step(1)`` loop with periodic snapshots. Differences by design:
the minibatch builder runs on host threads while the compiled train step
runs on the device (the reference's optional prefetch process, made default),
and snapshots are orbax checkpoints with the bbox-normalization baking
applied to a deployment copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

import jax

from aznet_tpu.config import Config, get_output_dir
from aznet_tpu.data.imdb import get_imdb
from aznet_tpu.data.minibatch import get_az_minibatch, get_frcnn_minibatch, fixed_canvas
from aznet_tpu.models import AZNet, FRCNN
from aznet_tpu.train.train_az import make_az_train_state, make_az_train_step
from aznet_tpu.train.train_frcnn import make_frcnn_train_state, make_frcnn_train_step
from aznet_tpu.utils.checkpoint import Checkpointer, bake_bbox_normalization
from aznet_tpu.utils.logging import MetricLogger


def process_local_indices(n_entries: int):
    """Round-robin roidb shard for this host process (SURVEY.md §2.4
    "host data pipeline sharded per-process").

    Single-process (one host) returns all indices. On a multi-host
    cluster each jax process samples only its shard, so no image is decoded
    twice and the global batch is assembled from purely-local shards by
    :func:`jax.make_array_from_process_local_data` — zero cross-host data
    movement on the input path.
    """
    n, pid = jax.process_count(), jax.process_index()
    idx = list(range(n_entries))[pid::n]
    return idx if idx else [0]


def local_batch_size(global_ims: int) -> int:
    """Per-process slice of the global IMS_PER_BATCH.

    A non-divisible config would otherwise silently train with a different
    global batch than requested (and could fail to divide the 'data' mesh
    axis downstream), so it is an error, not a floor.
    """
    n = jax.process_count()
    if global_ims % n:
        raise ValueError(
            f"TRAIN.IMS_PER_BATCH={global_ims} must be divisible by the "
            f"jax process count ({n}); the global batch is assembled from "
            f"equal per-process shards.")
    return global_ims // n


def make_global_batch(batch: dict, mesh) -> dict:
    """Assemble each process's local minibatch into global sharded arrays.

    The batch dim is sharded over the mesh's 'data' axis; with one process
    this is equivalent to a sharded device_put, and on multi-host it is THE
    supported way to form a global array from per-process data.
    """
    from aznet_tpu.parallel.mesh import batch_sharding

    return {
        k: jax.make_array_from_process_local_data(
            batch_sharding(mesh, np.ndim(v)), np.asarray(v))
        for k, v in batch.items()
    }


class _Prefetcher:
    """Host-side minibatch prefetch thread (reference BlobFetcher role)."""

    def __init__(self, make_batch, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            pending = None
            while not self._stop.is_set():
                # Build each batch once and retry the put: rebuilding on a
                # full queue would burn a host core and make the seeded
                # batch sequence timing-dependent.
                if pending is None:
                    pending = make_batch()
                try:
                    self._q.put(pending, timeout=0.5)
                    pending = None
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def _run_loop(state, step_fn, prefetcher, cfg: Config, max_iters: int,
              output_dir: str, name: str, resume: bool = True, mesh=None,
              interval_hook=None):
    """``interval_hook``: optional ``(interval, fn(step, state))`` called
    every ``interval`` steps from the MAIN thread (e.g. region mining —
    the prefetch thread must never touch device arrays)."""
    logger = MetricLogger(output_dir, name)
    ckpt = Checkpointer(output_dir, prefix=cfg.TRAIN.SNAPSHOT_PREFIX)
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        # Auto-resume from the latest snapshot (reference: restart-by-hand
        # from .solverstate — SURVEY.md §5.3/5.4; we make it automatic).
        restored, start_step = ckpt.restore(
            {"params": jax.device_get(state.params),
             "opt_state": jax.device_get(state.opt_state),
             "step": 0}
        )
        state = state.replace(params=restored["params"],
                              opt_state=restored["opt_state"],
                              step=restored["step"])
        print(f"[{name}] resumed from step {start_step}")
    rng = jax.random.PRNGKey(cfg.RNG_SEED)
    jstep = jax.jit(step_fn, donate_argnums=0)
    batch_put = lambda b: b
    if mesh is not None:
        # Data-parallel (+TP on fc kernels) over the mesh: shard params once,
        # shard each batch's leading dim; XLA all-reduces gradients over ICI.
        # Batches are per-process-local and assembled into global arrays
        # (multi-host ready; identical layout at process_count == 1).
        from aznet_tpu.parallel.mesh import param_sharding, replicate

        p_shard = param_sharding(mesh, state.params)
        shardings = jax.tree_util.tree_map(
            lambda _: replicate(mesh), state, is_leaf=lambda x: hasattr(x, "ndim")
        ).replace(params=p_shard)
        state = jax.device_put(state, shardings)

        def batch_put(b):
            return make_global_batch(b, mesh)
    for it in range(start_step, max_iters):
        if (interval_hook is not None and interval_hook[0] > 0
                and it % interval_hook[0] == 0):
            interval_hook[1](it, state)
        batch = batch_put(prefetcher.next())
        state, metrics = jstep(state, batch, rng)
        if (it + 1) % 20 == 0 or it + 1 == max_iters:
            logger.log(it + 1, jax.device_get(metrics), prefix=f"{name} ")
        if (it + 1) % cfg.TRAIN.SNAPSHOT_ITERS == 0 or it + 1 == max_iters:
            ckpt.save(it + 1, {"params": jax.device_get(state.params),
                               "opt_state": jax.device_get(state.opt_state),
                               "step": it + 1})
    prefetcher.close()
    return state


def train_az_net(cfg: Config, imdb_name: str, max_iters: Optional[int] = None,
                 output_dir: Optional[str] = None, state=None, imdb=None,
                 mesh=None):
    """Train AZ-Net on an imdb. Returns (state, model, output_dir)."""
    imdb = imdb or get_imdb(imdb_name)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    model = AZNet(model_cfg=cfg.MODEL)
    if state is None:
        state = make_az_train_state(cfg, model, jax.random.PRNGKey(cfg.RNG_SEED))
    output_dir = output_dir or get_output_dir(cfg, imdb.name, "aznet")
    max_iters = max_iters or cfg.TRAIN.MAX_ITERS

    # Per-process sampling stream over this process's roidb shard (multi-
    # host input pipeline; both are identity at process_count == 1).
    rng = np.random.RandomState(cfg.RNG_SEED + 1000003 * jax.process_index())
    roidb = imdb.roidb
    local_idx = process_local_indices(len(roidb))
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH)

    miner = None
    hook = None
    if cfg.TRAIN.MINE_INTERVAL > 0:
        from aznet_tpu.train.mining import RegionMiner

        miner = RegionMiner(model, cfg, imdb, local_idx)

        def _mine(step, st):
            n = miner.harvest(st.params)
            print(f"[az] mined search regions for {n} images at step {step}")

        hook = (cfg.TRAIN.MINE_INTERVAL, _mine)

    def make_batch():
        idx = rng.choice(local_idx, size=ims_local)
        mined = ([miner.mined_for(i) for i in idx]
                 if miner is not None else None)
        return get_az_minibatch(imdb, [roidb[i] for i in idx], cfg, rng,
                                canvas, mined_by_entry=mined)

    prefetcher = None
    if cfg.TRAIN.NUM_WORKERS > 1:
        if miner is not None:
            # Worker processes can't see the miner's pool (the main
            # process updates it mid-run); the thread shares memory.
            print("[az] TRAIN.NUM_WORKERS ignored: hard-region mining "
                  "needs the in-process prefetch thread")
        else:
            from aznet_tpu.data.prefetch import MPPrefetcher, az_batch_builder

            prefetcher = MPPrefetcher(
                az_batch_builder,
                {"imdb_name": imdb_name, "cfg": cfg,
                 "seed": cfg.RNG_SEED + 1000003 * jax.process_index(),
                 "pid": jax.process_index(), "pcount": jax.process_count(),
                 "ims_local": ims_local},
                workers=cfg.TRAIN.NUM_WORKERS)
    if prefetcher is None:
        prefetcher = _Prefetcher(make_batch)

    step_fn = make_az_train_step(
        model, pos_weights=(cfg.TRAIN.ZOOM_POS_WEIGHT, cfg.TRAIN.ADJ_POS_WEIGHT),
        remat_trunk=cfg.TRAIN.REMAT_TRUNK)
    state = _run_loop(state, step_fn, prefetcher,
                      cfg, max_iters, output_dir, "az", mesh=mesh,
                      interval_hook=hook)
    # Deployment copy with normalization baked into the regression head
    # (the reference's snapshot-time unnormalization).
    if cfg.TRAIN.BBOX_NORMALIZE_TARGETS:
        baked = bake_bbox_normalization(
            jax.device_get(state.params),
            cfg.TRAIN.BBOX_NORMALIZE_MEANS, cfg.TRAIN.BBOX_NORMALIZE_STDS,
            head_name="adj_bbox",
        )
        Checkpointer(output_dir + "/deploy").save(max_iters, {"params": baked})
    return state, model, output_dir


def train_frcnn_net(cfg: Config, imdb_name: str, proposals_fn,
                    max_iters: Optional[int] = None,
                    output_dir: Optional[str] = None, state=None, imdb=None,
                    mesh=None, proposals_path: Optional[str] = None):
    """Train Fast R-CNN on an imdb with proposals.

    ``proposals_fn(entry_index) -> [N, 4+]`` boxes in original image coords
    (typically AZ-Net proposals, the reference's chained experiment flow).
    ``proposals_path``: the pkl behind ``proposals_fn``, if any — required
    for TRAIN.NUM_WORKERS > 1 (spawned workers re-read it; a bare callable
    can't cross the process boundary).
    """
    imdb = imdb or get_imdb(imdb_name)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    canvas = fixed_canvas(imdb, cfg)
    model = FRCNN(model_cfg=cfg.MODEL)
    if state is None:
        state = make_frcnn_train_state(cfg, model, jax.random.PRNGKey(cfg.RNG_SEED))
    output_dir = output_dir or get_output_dir(cfg, imdb.name, "frcnn")
    max_iters = max_iters or cfg.TRAIN.MAX_ITERS

    rng = np.random.RandomState(cfg.RNG_SEED + 1000003 * jax.process_index())
    roidb = imdb.roidb
    local_idx = process_local_indices(len(roidb))
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH)

    def make_batch():
        idx = rng.choice(local_idx, size=ims_local)
        entries = [roidb[i] for i in idx]
        props = []
        for i, entry in zip(idx, entries):
            p = np.asarray(proposals_fn(int(i)))[:, :4].copy()
            if entry.get("flipped"):
                # Cached proposals come from the unflipped image: mirror them
                # (x1' = W - x2 - 1), as the reference's
                # append_flipped_images does for its roidb boxes.
                w = entry["width"]
                p[:, [0, 2]] = w - p[:, [2, 0]] - 1.0
            props.append(p)
        return get_frcnn_minibatch(imdb, entries, props, cfg, rng, canvas)

    prefetcher = None
    if cfg.TRAIN.NUM_WORKERS > 1:
        if proposals_path is None:
            print("[frcnn] TRAIN.NUM_WORKERS ignored: workers need "
                  "proposals_path (a pkl), not a bare proposals_fn")
        else:
            from aznet_tpu.data.prefetch import (MPPrefetcher,
                                                 frcnn_batch_builder)

            prefetcher = MPPrefetcher(
                frcnn_batch_builder,
                {"imdb_name": imdb_name, "cfg": cfg,
                 "seed": cfg.RNG_SEED + 1000003 * jax.process_index(),
                 "pid": jax.process_index(), "pcount": jax.process_count(),
                 "ims_local": ims_local, "proposals_path": proposals_path},
                workers=cfg.TRAIN.NUM_WORKERS)
    if prefetcher is None:
        prefetcher = _Prefetcher(make_batch)

    state = _run_loop(state, make_frcnn_train_step(model), prefetcher,
                      cfg, max_iters, output_dir, "frcnn", mesh=mesh)
    if cfg.TRAIN.BBOX_NORMALIZE_TARGETS:
        baked = bake_bbox_normalization(
            jax.device_get(state.params),
            cfg.TRAIN.BBOX_NORMALIZE_MEANS, cfg.TRAIN.BBOX_NORMALIZE_STDS,
            head_name="bbox_pred",
        )
        Checkpointer(output_dir + "/deploy").save(max_iters, {"params": baked})
    return state, model, output_dir
