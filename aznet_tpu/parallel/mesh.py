"""Mesh construction and sharding rules.

Design (SURVEY.md §2.4): data parallelism over the batch is the throughput
axis; tensor parallelism shards the 4096-wide fc6/fc7 kernels over
``model`` (they dominate head FLOPs and params — 25088x4096 for VGG-16).
Everything else is replicated. XLA inserts the psum/all-gathers (NCCL on
GPUs). The cards of one host are joined all to all by NVLink, so the mesh
follows the algorithm alone: any ``data x model`` factorisation of the
device list.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """('data', 'model') mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.array(devices[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, ("data", "model"))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (batch) dim over 'data', replicate the rest."""
    return NamedSharding(mesh, P(*(("data",) + (None,) * (ndim - 1))))


# fc kernels wider than this get their OUTPUT dim sharded over 'model';
# matching biases shard too. Score/bbox heads stay replicated (tiny).
_TP_PATTERN = re.compile(r"(fc6|fc7)$")


def param_sharding(mesh: Mesh, params) -> dict:
    """NamedSharding tree for a params pytree: TP on fc6/fc7, replicate rest.

    fc6 kernel [in, H] shards H over 'model'; fc7 kernel [H, H] shards the
    output dim (XLA all-gathers the activations between them — the 4096-d
    activations are small vs the 100M-param kernels).
    """

    def rule(path, leaf):
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        in_fc = any(_TP_PATTERN.search(str(n) or "") for n in names)
        if in_fc and hasattr(leaf, "ndim"):
            if leaf.ndim == 2:  # kernel [in, out]
                return NamedSharding(mesh, P(None, "model"))
            if leaf.ndim == 1:  # bias [out]
                return NamedSharding(mesh, P("model"))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(rule, params)
