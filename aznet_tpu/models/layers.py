"""Plain-JAX layers and the small module protocol every network shares.

Parameters are nested dicts of arrays. A network is a frozen dataclass of
its hyper-parameters with two pure entry points:

- ``init(rng, *example_args)`` -> ``{"params": tree}``. Shapes follow from
  the hyper-parameters and the example arguments' shapes; no forward pass
  runs. Each parameter's key comes from the root key and the parameter's
  path (:class:`InitKey`).
- ``apply(variables, *args, method=None, rngs=None, **kwargs)`` runs
  ``method`` (a method name, ``__call__`` by default) on
  ``variables["params"]``. ``rngs={"dropout": key}`` hands the key to the
  method as ``rng=`` (only methods with a dropout path take it).

Layouts are the checkpoint layouts: a conv kernel is
``[kh, kw, in / groups, out]``, a dense kernel ``[in, out]``, each with a
``bias [out]``. Compute follows the usual mixed-precision rule: inputs and
kernels are cast to the layer's ``dtype``, parameters stay float32.
"""

from __future__ import annotations

import hashlib
from typing import Any, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

_LECUN = jax.nn.initializers.lecun_normal()


class InitKey(NamedTuple):
    """Initialisation key of one module: the root key and the module's path.

    Parameter ``index`` (1-based, in creation order) of the module draws from
    ``fold_in(rng, sha1(path names + index bytes)[:4])`` — the derivation the
    models used before they were plain JAX, so a seed gives the same
    initial values as it did then.
    """

    rng: Any
    path: tuple = ()

    def child(self, name: str) -> "InitKey":
        return InitKey(self.rng, self.path + (name,))

    def param(self, index: int = 1):
        m = hashlib.sha1()
        for name in self.path:
            m.update(name.encode("utf-8"))
        m.update(index.to_bytes((index.bit_length() + 7) // 8, "big"))
        word = np.uint32(int.from_bytes(m.digest()[:4], "big"))
        return jax.random.fold_in(self.rng, word)


class Module:
    """Base for the frozen-dataclass networks (see module docstring)."""

    def init_params(self, key: InitKey, *args) -> dict:
        raise NotImplementedError

    def init(self, rng, *args) -> dict:
        return {"params": self.init_params(InitKey(rng), *args)}

    def init_with_output(self, rng, *args, **kwargs):
        variables = self.init(rng, *args)
        return self.apply(variables, *args, **kwargs), variables

    def apply(self, variables, *args, method: str | None = None,
              rngs: dict | None = None, **kwargs):
        fn = getattr(self, method or "__call__")
        if rngs and "dropout" in rngs:
            kwargs["rng"] = rngs["dropout"]
        return fn(variables["params"], *args, **kwargs)


def conv_params(key: InitKey, kh: int, kw: int, cin: int, cout: int,
                groups: int = 1, bias: bool = True) -> dict:
    p = {"kernel": _LECUN(key.param(1), (kh, kw, cin // groups, cout),
                          jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((cout,), jnp.float32)
    return p


def conv(p: dict, x, stride: int = 1, padding: Any = "SAME", groups: int = 1,
         dtype: Any = jnp.float32):
    """NHWC convolution (+ bias when ``p`` has one); [H, W, C] inputs too."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups)
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y[0] if squeeze else y


def dense_params(key: InitKey, din: int, dout: int,
                 stddev: float | None = None) -> dict:
    init = _LECUN if stddev is None else jax.nn.initializers.normal(stddev)
    return {"kernel": init(key.param(1), (din, dout), jnp.float32),
            "bias": jnp.zeros((dout,), jnp.float32)}


def dense(p: dict, x, dtype: Any = jnp.float32):
    y = jax.lax.dot_general(
        x.astype(dtype), p["kernel"].astype(dtype),
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())))
    return y + p["bias"].astype(dtype)


def max_pool(x, window, strides, padding: Any = "VALID"):
    """Max pool over the two spatial dims of [..., H, W, C]; explicit
    ``padding`` pairs pad with the dtype's lowest value."""
    lead = x.ndim - len(window) - 1
    dims = (1,) * lead + tuple(window) + (1,)
    steps = (1,) * lead + tuple(strides) + (1,)
    if not isinstance(padding, str):
        padding = (((0, 0),) * lead + tuple(tuple(p) for p in padding)
                   + ((0, 0),))
    # A concrete identity lets JAX pick the differentiable max-pool rule.
    if jnp.issubdtype(x.dtype, jnp.floating):
        lowest = np.array(-np.inf, x.dtype)
    else:
        lowest = np.array(np.iinfo(x.dtype).min, x.dtype)
    return jax.lax.reduce_window(x, lowest, jax.lax.max, dims, steps, padding)


def dropout(x, rate: float, train: bool, rng=None):
    """Inverted dropout; identity unless ``train`` and ``rate > 0``."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("train=True with dropout needs rngs={'dropout': key}")
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))
