"""The plain-JAX networks reproduce recorded outputs and parameter trees.

``tests/fixtures/model_param_shapes.json`` and ``model_parity.npz`` were
recorded from the earlier module implementation of every backbone at a
small width: the parameter tree's paths and shapes, and the ``features``
and ``roi_forward`` outputs for seeded parameters (:func:`fixture_params`)
and fixed inputs, in float32 at ``highest`` matmul precision.
"""

import json
import os
import sys
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aznet_tpu.config import ModelConfig
from aznet_tpu.models import AZNet, FRCNN
from aznet_tpu.utils.checkpoint import flatten_dict, unflatten_dict

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CASES = {
    "vgg16": dict(BACKBONE="vgg16", WIDTH=0.125, FC_DIM=32),
    "resnet50": dict(BACKBONE="resnet50", FC_DIM=32),
    "smallnet": dict(BACKBONE="smallnet", FC_DIM=32),
    "caffenet": dict(BACKBONE="caffenet", FC_DIM=32, POOL_SIZE=6),
    "vgg_cnn_m_1024": dict(BACKBONE="vgg_cnn_m_1024", FC_DIM=32, FC7_DIM=16,
                           POOL_SIZE=6),
}


def fixture_params(shapes):
    """{path tuple: shape} -> {path tuple: float32 array}, seeded per path."""
    out = {}
    for path, shape in shapes.items():
        rng = np.random.RandomState(zlib.crc32("/".join(path).encode()))
        name = path[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = 0.1 * rng.normal(size=shape)
        out[path] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def recorded():
    with open(os.path.join(FIXTURES, "model_param_shapes.json")) as f:
        shapes = json.load(f)
    with np.load(os.path.join(FIXTURES, "model_parity.npz")) as z:
        arrays = dict(z)
    return shapes, arrays


def _model(backbone, cls):
    mc = ModelConfig(NUM_TEMPLATES=5, NUM_CLASSES=4, COMPUTE_DTYPE="float32",
                     **CASES[backbone])
    return cls(model_cfg=mc)


@pytest.mark.parametrize("backbone", sorted(CASES))
def test_param_tree_paths_and_shapes(recorded, backbone):
    shapes, arrays = recorded
    for cls in (AZNet, FRCNN):
        model = _model(backbone, cls)
        tree = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(arrays["images"]),
            jnp.asarray(arrays["rois"])))
        got = {"/".join(k): list(v.shape)
               for k, v in flatten_dict(tree).items()}
        assert got == shapes[f"{backbone}.{cls.__name__}"]


@pytest.mark.parametrize("backbone", sorted(CASES))
def test_outputs_match_recorded(recorded, backbone):
    shapes, arrays = recorded
    images = jnp.asarray(arrays["images"])
    rois = jnp.asarray(arrays["rois"])
    for cls in (AZNet, FRCNN):
        tag = f"{backbone}.{cls.__name__}"
        model = _model(backbone, cls)
        shp = {tuple(k.split("/")): tuple(v) for k, v in shapes[tag].items()}
        params = unflatten_dict({k: jnp.asarray(v) for k, v in
                                 fixture_params(shp).items()})
        with jax.default_matmul_precision("highest"):
            feat = model.apply(params, images, method="features")
            out = model.apply(params, feat[0], rois, method="roi_forward")
        if cls is AZNet:
            want = arrays[f"{tag}.features"]
            assert np.abs(want).max() > 0  # a live, non-trivial fixture
            np.testing.assert_allclose(np.asarray(feat), want, atol=1e-5,
                                       rtol=1e-5)
        for k, v in out.items():
            np.testing.assert_allclose(np.asarray(v), arrays[f"{tag}.{k}"],
                                       atol=1e-5, rtol=1e-5, err_msg=k)


def test_dropout_train_path_uses_key_and_rate():
    """train=True draws a dropout mask from rngs['dropout'] (same key,
    same mask; surviving units scaled by 1/(1-rate)); eval ignores it."""
    mc = ModelConfig(BACKBONE="smallnet", FC_DIM=64, NUM_TEMPLATES=5,
                     COMPUTE_DTYPE="float32", DROPOUT=0.5)
    model = AZNet(model_cfg=mc)
    images = jnp.ones((1, 64, 64, 3))
    rois = jnp.array([[0.0, 0.0, 31.0, 31.0]] * 4)
    params = model.init(jax.random.PRNGKey(0), images, rois)
    k = jax.random.PRNGKey(5)
    a = model.apply(params, images, rois, train=True, rngs={"dropout": k})
    b = model.apply(params, images, rois, train=True, rngs={"dropout": k})
    np.testing.assert_array_equal(np.asarray(a["zoom"]), np.asarray(b["zoom"]))
    with pytest.raises(ValueError, match="dropout"):
        model.apply(params, images, rois, train=True)
    # the fc stack alone: dropped units are 0, kept ones doubled
    stack = model.head.fc
    x = jnp.ones((2, 7, 7, 128))
    hp = params["params"]["head"]["fc"]
    ev = np.asarray(stack(hp, x))
    tr = np.asarray(stack(hp, x, train=True, rng=k))
    kept = tr != 0
    assert 0 < kept.mean() < 1
    live = ev != 0
    assert not np.allclose(tr[live], ev[live])


def test_models_import_without_flax():
    """The main path imports with flax hidden (it is not a dependency)."""
    import subprocess

    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'flax' or name.startswith('flax.'):\n"
        "            raise ImportError('flax is hidden')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "for m in [m for m in sys.modules if m.startswith('flax')]:\n"
        "    del sys.modules[m]\n"
        "import aznet_tpu.api, aznet_tpu.train, aznet_tpu.models\n"
        "import aznet_tpu.search, aznet_tpu.parallel, aznet_tpu.utils.checkpoint\n"
        "assert not any(m.startswith('flax') for m in sys.modules)\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-1500:]


@pytest.mark.parametrize("backbone,kw", [("vgg16", dict(WIDTH=0.125)),
                                         ("smallnet", {})])
def test_init_values_match_recorded(backbone, kw):
    """A seed gives the initial values recorded from the earlier module
    implementation (per-parameter keys from the parameter path)."""
    with open(os.path.join(FIXTURES, "model_init_values.json")) as f:
        want = json.load(f)
    model = AZNet(model_cfg=ModelConfig(
        BACKBONE=backbone, FC_DIM=32, NUM_TEMPLATES=5,
        COMPUTE_DTYPE="float32", **kw))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                        jnp.array([[0.0, 0.0, 31.0, 31.0]]))
    got = {f"{backbone}:" + "/".join(k): np.asarray(v).ravel()[:3]
           for k, v in flatten_dict(params).items() if k[-1] == "kernel"}
    mine = {k: v for k, v in want.items() if k.startswith(backbone + ":")}
    assert set(got) == set(mine)
    for k, v in mine.items():
        np.testing.assert_array_equal(got[k], np.float32(v), err_msg=k)
