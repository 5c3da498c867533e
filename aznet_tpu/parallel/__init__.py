"""Device-mesh parallelism.

The reference is strictly single-process single-GPU with zero collectives
(SURVEY.md §2.4). This package is the multi-device replacement: a
``jax.sharding.Mesh`` with ``data`` (batch/DP) and ``model`` (TP over the
wide fc layers) axes; gradients all-reduce over ICI via jit's partitioner —
no NCCL/MPI analogue exists or is needed.
"""

from aznet_tpu.parallel.mesh import (
    make_mesh,
    batch_sharding,
    param_sharding,
    replicate,
)
