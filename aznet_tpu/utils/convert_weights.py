"""Caffe -> parameter-tree weight conversion.

Reference weights live in ``.caffemodel`` protobufs (VGG-16 ImageNet trunk +
trained AZ/FRCNN heads — SURVEY.md §5.4). This module converts a dict of
NumPy arrays extracted from such a snapshot (``{layer: (W, b)}``, the layout
``caffe.Net.params`` exposes) into our parameter trees. No network or
caffe installation is assumed here — extraction to .npz happens wherever
pycaffe exists; conversion is pure NumPy:

- Conv: Caffe (out, in, kh, kw) -> ours (kh, kw, in, out). Note the BGR
  question does NOT arise: Caffe nets are already BGR-input and we keep BGR
  preprocessing, so conv1_1 converts unchanged.
- Dense fc6: Caffe flattens ROI-pooled features channel-first (C, P, P); our
  pooled tensors flatten (P, P, C) — rows are permuted accordingly.
- Other Dense layers: simple transpose (out, in) -> (in, out).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def convert_conv(w: np.ndarray, b: np.ndarray):
    return {"kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
            "bias": b.astype(np.float32)}


def convert_dense(w: np.ndarray, b: np.ndarray):
    return {"kernel": w.T.astype(np.float32), "bias": b.astype(np.float32)}


def convert_fc6(w: np.ndarray, b: np.ndarray, pool: int, channels: int):
    """fc6 row permutation: Caffe input index c*P*P + ph*P + pw ->
    ours ph*P*C + pw*C + c."""
    out_dim = w.shape[0]
    w = w.reshape(out_dim, channels, pool, pool)  # (out, c, ph, pw)
    w = np.transpose(w, (2, 3, 1, 0))  # (ph, pw, c, out)
    return {"kernel": w.reshape(pool * pool * channels, out_dim).astype(np.float32),
            "bias": b.astype(np.float32)}


VGG16_CONV_NAMES = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
    "conv5_3",
)

# The fork's smaller nets (SURVEY.md §2.1 [M]): 5 convs each. Grouped
# layers (CaffeNet conv2/conv4/conv5, group=2) need NO special handling —
# Caffe stores grouped kernels as (out, in/g, kh, kw) and XLA's
# feature_group_count expects (kh, kw, in/g, out): the same transpose.
SMALL_TRUNK_CONV_NAMES = ("conv1", "conv2", "conv3", "conv4", "conv5")

_TRUNK_LAYOUTS = {
    # arch -> (conv names, conv5 channels, roi pool size)
    "vgg16": (VGG16_CONV_NAMES, 512, 7),
    "caffenet": (SMALL_TRUNK_CONV_NAMES, 256, 6),
    "vgg_cnn_m_1024": (SMALL_TRUNK_CONV_NAMES, 512, 6),
}


def convert_trunk(caffe_params: Dict[str, Tuple[np.ndarray, np.ndarray]],
                  arch: str = "vgg16"):
    """``{name: (W, b)}`` -> trunk param dict for the named backbone."""
    names = _TRUNK_LAYOUTS[arch][0]
    out = {}
    for name in names:
        if name not in caffe_params:
            raise KeyError(f"missing conv layer {name!r} in caffe params")
        out[name] = convert_conv(*caffe_params[name])
    return out


def convert_vgg16_trunk(caffe_params: Dict[str, Tuple[np.ndarray, np.ndarray]]):
    return convert_trunk(caffe_params, "vgg16")


def convert_az_head(caffe_params: Dict[str, Tuple[np.ndarray, np.ndarray]],
                    pool: int = 7, channels: int = 512,
                    name_map: Dict[str, str] | None = None):
    """Convert fc6/fc7 + AZ head layers.

    ``name_map`` maps our head names {'zoom_score','adj_score','adj_bbox'}
    to the prototxt layer names (unverifiable from the empty reference
    mount — pass the real names once known).
    """
    name_map = name_map or {"zoom_score": "zoom_score", "adj_score": "adj_score",
                            "adj_bbox": "adj_bbox"}
    out = {"fc": {
        "fc6": convert_fc6(*caffe_params["fc6"], pool=pool, channels=channels),
        "fc7": convert_dense(*caffe_params["fc7"]),
    }}
    for ours, theirs in name_map.items():
        out[ours] = convert_dense(*caffe_params[theirs])
    return out


def convert_frcnn_head(caffe_params, pool: int = 7, channels: int = 512):
    return {
        "fc": {
            "fc6": convert_fc6(*caffe_params["fc6"], pool=pool, channels=channels),
            "fc7": convert_dense(*caffe_params["fc7"]),
        },
        "cls_score": convert_dense(*caffe_params["cls_score"]),
        "bbox_pred": convert_dense(*caffe_params["bbox_pred"]),
    }


def load_npz(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Load ``{name_W, name_b}`` arrays saved by an extraction script."""
    data = np.load(path)
    names = sorted({k[:-2] for k in data.files if k.endswith("_W")})
    return {n: (data[f"{n}_W"], data[f"{n}_b"]) for n in names}


def convert_npz_to_checkpoint(npz_path: str, out_dir: str,
                              arch: str = "vgg16", pool: int | None = None,
                              channels: int | None = None,
                              backbone: str = "vgg16"):
    """End-to-end ingest: Caffe-export .npz -> orbax params checkpoint.

    ``arch``: 'vgg16' (trunk only — ImageNet warm start), 'az' (trunk +
    AZ head), or 'frcnn' (trunk + detection head). ``backbone`` picks the
    trunk layout ('vgg16' | 'caffenet' | 'vgg_cnn_m_1024'); pool/channels
    default from it. Head layers absent from the npz are simply omitted
    (load with partial restore / warm start).
    """
    from aznet_tpu.utils.checkpoint import Checkpointer

    if arch in _TRUNK_LAYOUTS:  # trunk-only ingest named by backbone
        backbone, arch = arch, "trunk"
    names, def_ch, def_pool = _TRUNK_LAYOUTS[backbone]
    pool = def_pool if pool is None else pool
    channels = def_ch if channels is None else channels
    caffe = load_npz(npz_path)
    params: Dict = {"trunk": convert_trunk(caffe, backbone)}
    if arch == "az" and "fc6" in caffe:
        params["head"] = convert_az_head(caffe, pool=pool, channels=channels)
    elif arch == "frcnn" and "fc6" in caffe:
        params["head"] = convert_frcnn_head(caffe, pool=pool, channels=channels)
    Checkpointer(out_dir).save(0, {"params": {"params": params}})
    return params
