"""Backbone factory keyed on cfg.MODEL.BACKBONE, and the trunk + ROI head
network both AZNet and FRCNN are built on."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from aznet_tpu.config import ModelConfig
from aznet_tpu.models.layers import Module
from aznet_tpu.models.vgg import VGG16Trunk
from aznet_tpu.models.resnet import ResNet50Trunk
from aznet_tpu.models.small import SmallTrunk, CaffeNetTrunk, VGGCNNM1024Trunk
from aznet_tpu.ops.roi_pool import roi_pool

_BACKBONES = {
    "vgg16": VGG16Trunk,
    "resnet50": ResNet50Trunk,
    "smallnet": SmallTrunk,
    # The reference fork's smaller prototxts (SURVEY.md §2.1 [M]). Pair
    # caffenet/vgg_cnn_m_1024 with MODEL.POOL_SIZE 6; the latter also with
    # MODEL.FC7_DIM 1024.
    "caffenet": CaffeNetTrunk,
    "vgg_cnn_m_1024": VGGCNNM1024Trunk,
}


def get_backbone(model_cfg: ModelConfig):
    """Instantiate the trunk module for a MODEL config."""
    try:
        cls = _BACKBONES[model_cfg.BACKBONE]
    except KeyError:
        raise ValueError(
            f"unknown backbone {model_cfg.BACKBONE!r}; options: {sorted(_BACKBONES)}"
        ) from None
    # int8 mode: trunk GEMMs are int8; conv1_1/heads compute in bfloat16.
    dtype = (jnp.float32 if model_cfg.COMPUTE_DTYPE == "float32"
             else jnp.bfloat16)
    if cls is VGG16Trunk:
        return cls(dtype=dtype, width=model_cfg.WIDTH,
                   int8_mode=model_cfg.COMPUTE_DTYPE == "int8",
                   int8_scales=tuple(model_cfg.INT8_SCALES),
                   conv1_s2d=model_cfg.CONV1_S2D)
    if cls is ResNet50Trunk:
        # Int8 bottleneck 1x1 GEMMs (models/resnet.py docstring); the
        # stem/3x3s stay bf16. Scales from calibrate_trunk_int8_resnet.
        return cls(dtype=dtype,
                   int8_mode=model_cfg.COMPUTE_DTYPE == "int8",
                   int8_scales=tuple(model_cfg.INT8_SCALES),
                   stem_s2d=model_cfg.STEM_S2D)
    if model_cfg.COMPUTE_DTYPE == "int8":
        raise ValueError(
            f"COMPUTE_DTYPE='int8' is only implemented for the vgg16 and "
            f"resnet50 backbones, not {model_cfg.BACKBONE!r}")
    return cls(dtype=dtype)


@dataclasses.dataclass(frozen=True)
class RoiNet(Module):
    """Trunk + ROI pooling + a head; params ``{"trunk": .., "head": ..}``.

    Methods (use with ``model.apply(..., method=...)``):
      - ``features(images [B,H,W,3])`` -> ``[B, H/16, W/16, C]``
      - ``roi_pool_only(feat [h,w,C], rois [R,4])`` -> ``[R, P, P, C]``
      - ``head_forward(pooled, train=False)`` -> head outputs dict
      - ``roi_forward(feat [h,w,C], rois [R,4], train=False)`` -> head
        outputs dict
      - ``__call__`` = features + roi_forward on image 0
    ``train=True`` applies dropout with ``rngs={"dropout": key}``.
    """

    model_cfg: ModelConfig = ModelConfig()

    @functools.cached_property
    def trunk(self):
        return get_backbone(self.model_cfg)

    @functools.cached_property
    def head(self):
        raise NotImplementedError

    def _head_kwargs(self) -> dict:
        mc = self.model_cfg
        return dict(
            fc_dim=mc.FC_DIM, fc7_dim=mc.FC7_DIM, dropout=mc.DROPOUT,
            dtype=self.trunk.dtype,
            # Heads quantize independently of the trunk: INT8_HEAD_SCALES
            # alone enables the int8 fc stack (bf16 trunk + int8 heads is
            # a valid, separately-benchable configuration).
            int8_scales=(tuple(mc.INT8_HEAD_SCALES)
                         if mc.COMPUTE_DTYPE != "float32" else ()))

    def init_params(self, key, images, rois=None) -> dict:
        p = self.model_cfg.POOL_SIZE
        pooled = jax.ShapeDtypeStruct((1, p, p, self.trunk.out_channels),
                                      jnp.float32)
        return {"trunk": self.trunk.init_params(key.child("trunk"), images),
                "head": self.head.init_params(key.child("head"), pooled)}

    def features(self, p, images):
        return self.trunk(p["trunk"], images)

    def trunk_taps(self, p, images) -> dict:
        """The trunk's int8 calibration taps (ops/quant.py)."""
        taps = {}
        self.trunk(p["trunk"], images, taps=taps)
        return taps

    def roi_pool_only(self, p, feat, rois):
        """Pool rois from one feature map (no head). The multi-scale
        pyramid pools per scale (cheap), SELECTS per roi, and runs the
        expensive fc head once — R instead of R*S head cost."""
        return roi_pool(feat, rois, 1.0 / self.model_cfg.FEAT_STRIDE,
                        self.model_cfg.POOL_SIZE,
                        mode=self.model_cfg.POOLING_MODE)

    def head_forward(self, p, pooled, train: bool = False, rng=None):
        return self.head(p["head"], pooled, train=train, rng=rng)

    def fc6_preact(self, p, feat, rois):
        """fc6's pre-ReLU output over ``rois`` (int8 head calibration)."""
        return self.head.fc.fc6_preact(p["head"]["fc"],
                                       self.roi_pool_only(p, feat, rois))

    def roi_forward(self, p, feat, rois, train: bool = False, rng=None):
        """feat: single-image [h, w, C]; rois: [R, 4] image coords."""
        return self.head_forward(p, self.roi_pool_only(p, feat, rois),
                                 train=train, rng=rng)

    def __call__(self, p, images, rois, train: bool = False, rng=None):
        feat = self.features(p, images)
        return self.roi_forward(p, feat[0], rois, train=train, rng=rng)
