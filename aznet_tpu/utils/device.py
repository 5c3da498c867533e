"""The one place that looks at the accelerator.

Everything that depends on the platform asks here: which devices to use
(:func:`require_gpu`), what they are (:func:`describe`), their published
peak rates (:func:`peaks`), where compiled programs are cached
(:func:`setup_compile_cache`) and which NMS implementation runs
(:func:`nms_impl`). No other module reads ``jax.devices()[0].platform``.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

# Published dense peaks per device, keyed by ``device_kind``. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column (dense, without
# sparsity; rates assume the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,   # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM",
    },
}


def describe() -> dict:
    """``{"platform", "kind", "count"}`` of the visible devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> list:
    """The GPU devices to use; raises when JAX found no GPU (never falls
    back to the CPU)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default devices are {devs[0].platform!r} "
            f"({devs[0].device_kind}); this path needs an NVIDIA GPU")
    return devs


def peaks(device_kind: str | None = None) -> dict:
    """Peak table row for ``device_kind`` (default: device 0). A device
    that is not in the table is an error, not a default."""
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no peak rates recorded for device {kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def setup_compile_cache() -> str:
    """Persistent compilation cache: ``$JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself), else the fixed ``<repo>/.jax_cache``.
    Returns the directory in use. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    try:
        return jax.default_backend() == "gpu"
    except RuntimeError:  # no backend initialised / available
        return False


def nms_impl() -> str:
    """The exact-greedy NMS implementation: the Triton kernels on a GPU
    (faster end to end in propose on the H100, PERF.md PR 1), the fixpoint
    elsewhere."""
    return "triton" if on_gpu() else "fixpoint"
