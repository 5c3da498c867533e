"""utils/device.py: the one module that looks at the platform."""

import os
import re
import subprocess
import sys

import pytest

import jax

from aznet_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_describe_names_platform_kind_count():
    info = device.describe()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_peak_table_has_h100_and_rejects_unknown():
    row = device.peaks("NVIDIA H100 80GB HBM3")
    assert row["bf16_flops"] == 989e12 and row["int8_ops"] == 1979e12
    assert row["tf32_flops"] == 495e12 and row["fp32_flops"] == 67e12
    assert row["hbm_bytes_per_s"] == 3.35e12 and "data sheet" in row["source"]
    with pytest.raises(KeyError, match="no peak rates"):
        device.peaks("cpu")
    with pytest.raises(KeyError):
        device.peaks()  # device 0 here is the CPU


def _cache_dir_in_child(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from aznet_tpu.utils import device; "
            "print(device.setup_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-800:]
    return r.stdout.split()


@pytest.mark.parametrize("env_value", [None, "/tmp/aznet-test-cache"])
def test_compile_cache_dir(env_value):
    returned, configured = _cache_dir_in_child(env_value)
    if env_value is None:
        want = os.path.join(REPO, ".jax_cache")
        assert returned == configured == want
    else:
        assert returned == configured == env_value  # JAX reads the env


def test_no_tpu_kernels_or_platform_tests_left():
    """No module imports the TPU Pallas dialect, and only utils/device.py
    asks which platform JAX runs on."""
    pat = re.compile(r"pallas\.tpu|pltpu|default_backend\(\)|\.platform\b")
    hits = []
    for root in ("aznet_tpu", "tools"):
        for dirpath, _, files in os.walk(os.path.join(REPO, root)):
            for f in files:
                if f.endswith(".py"):
                    path = os.path.join(dirpath, f)
                    with open(path) as fh:
                        if pat.search(fh.read()):
                            hits.append(os.path.relpath(path, REPO))
    for f in ("bench.py", "chip_smoke.py"):
        with open(os.path.join(REPO, f)) as fh:
            if re.search(r"pallas\.tpu|pltpu|default_backend\(\)", fh.read()):
                hits.append(f)
    assert hits == [os.path.join("aznet_tpu", "utils", "device.py")], hits
