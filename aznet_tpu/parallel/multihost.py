"""Two-process multi-host dry run (jax.distributed over CPU devices).

The single-process CPU mesh (tests/test_parallel.py, ``dryrun_multichip``)
exercises the sharding program but make_global_batch's multi-host branch —
``jax.make_array_from_process_local_data`` assembling a global array from
per-process shards — degenerates at process_count == 1. This module runs
the REAL branch: a launcher spawns N worker processes, each with its own
forced-host CPU device set, joined by ``jax.distributed.initialize``; each
worker samples only its ``process_local_indices`` roidb shard, builds a
local AZ minibatch, assembles the global batch, and runs one sharded
train step on the global ('data', 'model') mesh.

Reference equivalent: none — the reference is single-process single-GPU
(SURVEY.md §2.4); multi-host input sharding is new here.

Usage:
  launcher (in-process API):  run_multihost_dryrun(num_processes=2)
  worker (internal):          python -m aznet_tpu.parallel.multihost \
                                  --process-id I --num-processes N \
                                  --coordinator localhost:PORT
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def force_device_count_flags(existing: str, n: int) -> str:
    """XLA_FLAGS with exactly one ``--xla_force_host_platform_device_count``.

    Appending a second copy does NOT override — XLA keeps the first — so a
    parent that already forces a count (the test conftest forces 8) would
    silently give every worker 8 devices instead of ``n``. Strip any
    existing instance first.
    """
    cleaned = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                     existing or "")
    return (cleaned + f" --xla_force_host_platform_device_count={n}").strip()


def run_multihost_dryrun(num_processes: int = 2, devices_per_proc: int = 4,
                         timeout: int = 900) -> str:
    """Spawn the workers, wait, and return process 0's report line."""
    if devices_per_proc < 2:
        # The worker builds a ('data', 'model'=2) mesh; the data axis must
        # have >= one shard per process for make_global_batch's per-process
        # assembly, so each process needs at least data=1 x model=2 devices.
        raise ValueError("devices_per_proc must be >= 2 "
                         f"(got {devices_per_proc}): the worker mesh is "
                         "(data, model=2)")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    coordinator = f"localhost:{_free_port()}"
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env["XLA_FLAGS"] = force_device_count_flags(env.get("XLA_FLAGS", ""),
                                                    devices_per_proc)
        env["JAX_PLATFORMS"] = "cpu"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "aznet_tpu.parallel.multihost",
             "--process-id", str(pid), "--num-processes", str(num_processes),
             "--coordinator", coordinator],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"multihost dryrun: process {pid} timed out")
        outs.append((p.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(
                f"multihost dryrun: process {pid} rc={rc}:\n{err[-2000:]}")
    report = [l for l in outs[0][1].splitlines()
              if l.startswith("dryrun_multihost")]
    if not report:
        raise RuntimeError(
            f"multihost dryrun: no report line:\n{outs[0][1][-1000:]}")
    print(report[-1])
    return report[-1]


def _worker(process_id: int, num_processes: int, coordinator: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    import numpy as np
    import jax.numpy as jnp

    from aznet_tpu.config import Config, cfg_from_dict
    from aznet_tpu.data.minibatch import get_az_minibatch
    from aznet_tpu.data.synthetic import SyntheticImdb
    from aznet_tpu.models import AZNet
    from aznet_tpu.parallel.mesh import make_mesh, param_sharding, replicate
    from aznet_tpu.train import make_az_train_state, make_az_train_step
    from aznet_tpu.train.loop import (local_batch_size, make_global_batch,
                                      process_local_indices)

    assert jax.process_count() == num_processes, jax.process_count()
    cfg = cfg_from_dict(Config(), {
        "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5,
                  "NUM_CLASSES": 4, "COMPUTE_DTYPE": "float32"},
        "TRAIN": {"SCALES": (64,), "MAX_SIZE": 96, "REGIONS_PER_IMAGE": 8,
                  "IMS_PER_BATCH": 2 * num_processes, "USE_FLIPPED": False},
    })
    imdb = SyntheticImdb(num_images=8)
    # THE multi-host input path under test: per-process roidb shard ->
    # local minibatch -> global array assembled from local shards.
    shard = process_local_indices(len(imdb.roidb))
    assert len(shard) == len(imdb.roidb) // num_processes
    ims_local = local_batch_size(cfg.TRAIN.IMS_PER_BATCH)
    rng = np.random.RandomState(100 + process_id)
    entries = [imdb.roidb[shard[i % len(shard)]] for i in range(ims_local)]
    batch = get_az_minibatch(imdb, entries, cfg, rng, canvas=(64, 96))

    model = AZNet(model_cfg=cfg.MODEL)
    mesh = make_mesh(jax.device_count(), model_parallel=2)
    state = make_az_train_state(cfg, model, jax.random.PRNGKey(0),
                                image_hw=(64, 96))
    step = make_az_train_step(model)

    gbatch = make_global_batch(batch, mesh)
    assert gbatch["images"].shape[0] == cfg.TRAIN.IMS_PER_BATCH

    p_shard = param_sharding(mesh, state.params)
    shardings = jax.tree_util.tree_map(
        lambda _: replicate(mesh), state, is_leaf=lambda x: hasattr(x, "ndim")
    ).replace(params=p_shard)
    state = jax.device_put(state, shardings)
    with mesh:
        _, metrics = jax.jit(step, donate_argnums=0)(
            state, gbatch, jax.random.PRNGKey(1))
    loss = float(jax.device_get(metrics["loss"]))
    assert np.isfinite(loss), loss
    if process_id == 0:
        print(f"dryrun_multihost: processes={num_processes} "
              f"devices={jax.device_count()} mesh={dict(mesh.shape)} "
              f"global_batch={int(gbatch['images'].shape[0])} "
              f"loss={loss:.4f} OK", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    a = ap.parse_args()
    _worker(a.process_id, a.num_processes, a.coordinator)
