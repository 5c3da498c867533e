"""Configuration tree for aznet_tpu.

Replacement for the reference's two parallel easydict config trees
(``lib/detect/config.py`` and ``lib/fast_rcnn/config.py`` — SURVEY.md §5.6):
a single frozen-dataclass tree with the reference's semantic knobs preserved
1:1 (SEAR.*, TRAIN.*, TEST.*, PIXEL_MEANS, RNG_SEED, ...) so that experiment
parity is a config translation, not a code change.

Like the reference, configs can be overridden from YAML files
(``cfg_from_file``, deep-merge with type checking against the defaults) and
from ``KEY VALUE`` lists (``cfg_from_list``). Unlike the reference, the tree
is immutable: overrides produce a new Config, which keeps jitted functions
keyed on hashable static config objects.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Tuple


# ---------------------------------------------------------------------------
# Sub-trees
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SearchConfig:
    """AZ adjacency-and-zoom search knobs (reference ``cfg.SEAR.*``).

    Reference: lib/detect/config.py (SURVEY.md §2.1 — zoom-indicator
    threshold, adjacency-confidence threshold, depth/budget caps, min region
    size, final proposal count). New knobs (FRONTIER_CAP, CAND_BUF) exist
    because the on-device search runs over fixed-shape padded frontiers.
    """

    # Zoom indicator threshold Tz: regions with z > Tz are subdivided.
    ZOOM_THRESH: float = 0.2
    # Adjacency confidence threshold Tc: candidates below are dropped.
    CONF_THRESH: float = 0.05
    # Maximum search-tree depth (levels of subdivision). COCO configs go deeper.
    MAX_LEVELS: int = 6
    # Regions smaller than this (in pixels, shorter side) are not subdivided.
    MIN_SIZE: float = 16.0
    # Static per-level frontier capacity R_max (a padded frontier; the
    # reference's frontier is an unbounded host-side list).
    FRONTIER_CAP: int = 64
    # Static proposal-candidate accumulator size (top-K eviction by score).
    CAND_BUF: int = 2048
    # Number of final proposals returned by im_propose (paper sweeps 100/300/1000).
    NUM_PROPOSALS: int = 300
    # NMS IoU threshold applied to the accumulated candidates.
    NMS_THRESH: float = 0.7
    # Extra relative overlap of the 5 zoom sub-regions (0.0 = exact quadrants+center).
    DIV_OVERLAP: float = 0.0
    # How many division levels to seed into the initial frontier alongside the
    # whole image (paper seeds the first division level).
    SEED_LEVELS: int = 1
    # Clip |dw|,|dh| in delta decoding (log(1000/16) as in the lineage).
    BBOX_XFORM_CLIP: float = 4.135166556742356


@dataclass(frozen=True)
class TrainConfig:
    """Training knobs (reference ``cfg.TRAIN.*`` — SURVEY.md §2.2)."""

    # Image scales (shortest side) and max longest side, fast-rcnn defaults.
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    # Images per minibatch and ROIs per image (fast-rcnn: 2 x 64 = 128 rois).
    IMS_PER_BATCH: int = 2
    BATCH_SIZE: int = 128
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1
    # Horizontal-flip augmentation.
    USE_FLIPPED: bool = True
    # Bbox regression target normalization (fast-rcnn's mean/std trick).
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_NORMALIZE_MEANS: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    BBOX_THRESH: float = 0.5
    # AZ-specific label generation.
    # A gt is "contained" in a region if inter(gt, region)/area(gt) >= this.
    ZOOM_CONTAIN_THRESH: float = 0.5
    # Zoom label is 1 iff a contained gt has area(gt)/area(region) < this.
    ZOOM_AREA_FRAC: float = 0.25
    # Adjacency template <-> gt assignment IoU threshold.
    ADJ_FG_THRESH: float = 0.5
    # Positive-class weight in the adjacency confidence CE (1.0 = reference
    # parity; > 1 counters the ~1:K positive/negative template imbalance
    # which otherwise collapses confidences below SEAR.CONF_THRESH).
    ADJ_POS_WEIGHT: float = 1.0
    # Same for the zoom-indicator CE.
    ZOOM_POS_WEIGHT: float = 1.0
    # Number of anchor regions sampled per image for AZ training.
    REGIONS_PER_IMAGE: int = 128
    # Search-driven hard-region mining (train/mining.py): every
    # MINE_INTERVAL steps run the CURRENT model's zoom search over
    # MINE_IMAGES training images and mix the visited frontier regions
    # into the anchor pool. 0 = off (reference-parity static sampler).
    MINE_INTERVAL: int = 0
    MINE_IMAGES: int = 32
    # Optimizer (Caffe SGD solver equivalents: momentum, weight decay, step LR).
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    STEPSIZE: int = 30000
    GAMMA: float = 0.1
    MAX_ITERS: int = 40000
    SNAPSHOT_ITERS: int = 10000
    SNAPSHOT_PREFIX: str = "aznet"
    # Gradient clip (not in the reference; 0 disables).
    GRAD_CLIP: float = 0.0
    # Rematerialize the trunk forward during backward (jax.checkpoint on
    # the features pass): drops the 13-conv activation stack from HBM —
    # the batch-size limiter at 608x800 — for one extra trunk forward
    # per step. Not in the reference.
    REMAT_TRUNK: bool = False
    # Minibatch-build worker processes (data/prefetch.py::MPPrefetcher).
    # 1 = the reference-parity single prefetch thread (stateful shared
    # RNG); >= 2 switches to spawned CPU-only workers with a per-batch-
    # index seeded stream (deterministic, worker-count-invariant). The
    # lever for the host-bound regime DESIGN.md finding 30 measured
    # (device 54% MFU at b8 vs ~40 img/s host wall on a 1-core machine).
    # Requires a registry-name imdb; falls back to the thread (with a
    # warning) when hard-region mining is on or proposals aren't a path.
    NUM_WORKERS: int = 1
    # Parameter-name prefixes whose gradients are zeroed (the reference sets
    # lr_mult=0 on conv1/conv2 when fine-tuning from ImageNet weights). Off
    # by default: from-scratch training must update everything.
    FREEZE_PREFIXES: Tuple[str, ...] = ()


@dataclass(frozen=True)
class TestConfig:
    """Inference knobs (reference ``cfg.TEST.*``)."""

    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    # Detection-head NMS threshold and score threshold.
    NMS: float = 0.3
    SCORE_THRESH: float = 0.05
    # Max detections kept per image after per-class NMS.
    MAX_PER_IMAGE: int = 100
    # Pad batched images to multiples of this (static shapes).
    SIZE_MULTIPLE: int = 32
    # Iterative bbox regression passes through the detection head (1 = the
    # reference's single decode). Each extra pass re-pools each roi at its
    # argmax-class decoded box and re-regresses — the one-shot adjacency
    # regression caps high-IoU localization (not in the reference; a lever
    # for recall@{0.8,0.9} and mAP@0.7).
    BBOX_ITER: int = 1


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture knobs (the reference keeps these in prototxts)."""

    # vgg16 | resnet50 | caffenet | vgg_cnn_m_1024 | smallnet
    BACKBONE: str = "vgg16"
    # Channel-width multiplier (1.0 = the reference architecture). Smaller
    # values keep the exact layer/sharding structure at a fraction of the
    # FLOPs — used by multi-chip dry runs and CPU tests.
    WIDTH: float = 1.0
    # Feature stride of the trunk output used for ROI pooling.
    FEAT_STRIDE: int = 16
    # ROI pooling: output grid and mode.
    POOL_SIZE: int = 7
    POOLING_MODE: str = "align"  # "align" (matmul form) | "caffe_max" (parity)
    # Number of adjacency templates K (paper uses a fixed small template set).
    NUM_TEMPLATES: int = 11
    # Detection classes (VOC: 20 + background).
    NUM_CLASSES: int = 21
    FC_DIM: int = 4096
    # fc7 width when it differs from fc6 (VGG_CNN_M_1024's fc7 is 1024 —
    # SURVEY.md §2.1 smaller nets [M]); 0 = same as FC_DIM.
    FC7_DIM: int = 0
    DROPOUT: float = 0.5
    # Compute dtype for conv/matmul ("bfloat16" on the tensor cores; params
    # stay f32). "int8" (inference-only, vgg16/resnet50) runs the trunk
    # convs as XLA int8 GEMMs — requires calibrated INT8_SCALES;
    # heads/conv1_1 stay bfloat16.
    COMPUTE_DTYPE: str = "bfloat16"
    # Static per-layer activation scales for the int8 trunk, in conv-layer
    # order (conv1_1..conv5_3): scale i quantizes conv i's post-ReLU output
    # for the next layer. Produced by ops/quant.py::calibrate_trunk_int8;
    # () = uncalibrated (int8 mode raises).
    INT8_SCALES: Tuple[float, ...] = ()
    # (pooled-input scale, fc6-output scale) for int8 fc6/fc7 heads
    # (ops/quant.py::calibrate_head_int8). () = heads stay bfloat16 even
    # in int8 mode.
    INT8_HEAD_SCALES: Tuple[float, ...] = ()
    # Inference-only: quantize the trunk output feature map once per image
    # (at INT8_HEAD_SCALES[0], the calibrated conv5_3 scale) and run the
    # ROI-align row contraction — the search head's hot pooling matmul —
    # as an int8 GEMM (ops/roi_pool.py::roi_align_int8). Pooled features
    # stay int8 into the int8 fc6, skipping a dequant->requant pass.
    # Requires INT8_HEAD_SCALES and POOLING_MODE 'align'; no effect on
    # training paths.
    INT8_ROI: bool = False
    # ResNet stem as the exact space-to-depth rewrite (models/resnet.py
    # StemConv): pad the 7x7 kernel to 8x8, s2d the input by 2, run a 4x4
    # stride-1 conv — term-identical math, ~4x deeper contraction on the
    # 3-channel input. Same checkpoints (in-jit re-layout);
    # auto-falls-back on odd input sizes. vgg16 ignores this.
    STEM_S2D: bool = True
    # VGG conv1_1 as the exact stride-1 space-to-depth rewrite
    # (models/vgg.py::conv1_1_s2d): pack the input 2x2, one 3x3 conv
    # emits all four output phases, depth-to-space back — term-identical
    # math, K=12 contraction at quarter spatial size instead of K=3 at
    # full 608x800. Same checkpoints (in-jit
    # re-layout); no-op on odd input sizes or non-vgg backbones.
    CONV1_S2D: bool = False


@dataclass(frozen=True)
class Config:
    """Root config. Frozen + hashable so it can be a jit static argument."""

    SEAR: SearchConfig = field(default_factory=SearchConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    # BGR pixel means, the exact Caffe constants (SURVEY.md §2.1 [H]).
    PIXEL_MEANS: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    RNG_SEED: int = 3
    EXP_DIR: str = "default"
    OUTPUT_DIR: str = "output"
    # Box coordinate convention: 1.0 = Caffe/fast-rcnn "+1" widths (parity),
    # 0.0 = modern half-open convention.
    BOX_OFFSET: float = 1.0


# ---------------------------------------------------------------------------
# Override machinery (cfg_from_file / cfg_from_list equivalents)
# ---------------------------------------------------------------------------


def _coerce(value: Any, template: Any, path: str) -> Any:
    """Coerce ``value`` to the type of ``template``, erroring on mismatch."""
    if is_dataclass(template):
        if not isinstance(value, dict):
            raise TypeError(f"{path}: expected mapping for {type(template).__name__}")
        return _merge_dataclass(template, value, path)
    t = type(template)
    if t is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if t is int:
        if isinstance(value, float) and value != int(value):
            raise TypeError(f"{path}: expected int, got {value!r}")
        return int(value)
    if t is float:
        return float(value)
    if t is str:
        return str(value)
    if t is tuple:
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{path}: expected sequence, got {value!r}")
        if len(template):
            elem = template[0]
            return tuple(type(elem)(v) for v in value)
        return tuple(value)
    raise TypeError(f"{path}: unsupported config type {t}")


def _merge_dataclass(base: Any, overrides: dict, path: str = "") -> Any:
    valid = {f.name: f for f in fields(base)}
    updates = {}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError(f"unknown config key: {path + key!r}")
        current = getattr(base, key)
        updates[key] = _coerce(value, current, path + key)
    return dataclasses.replace(base, **updates)


def cfg_from_dict(cfg: Config, overrides: dict) -> Config:
    """Deep-merge a nested dict of overrides into ``cfg`` (type-checked)."""
    return _merge_dataclass(cfg, overrides)


def cfg_from_file(cfg: Config, filename: str) -> Config:
    """Load a YAML config file and merge it into ``cfg``.

    Mirrors the reference's ``cfg_from_file`` (lib/fast_rcnn/config.py,
    SURVEY.md §5.6) but returns a new frozen Config.
    """
    try:
        import yaml
    except ImportError as e:
        raise ImportError("YAML config files need PyYAML "
                          "(pip install pyyaml)") from e

    with open(filename) as f:
        data = yaml.safe_load(f) or {}
    return cfg_from_dict(cfg, data)


def cfg_from_list(cfg: Config, args: list) -> Config:
    """Apply ``[KEY, VALUE, KEY, VALUE, ...]`` overrides with dotted keys.

    Mirrors the reference's ``cfg_from_list`` (``--set SEAR.NUM_PROPOSALS 300``).
    Values are parsed as Python literals when possible.
    """
    import ast

    if len(args) % 2 != 0:
        raise ValueError("cfg_from_list expects an even-length KEY VALUE list")
    nested: dict = {}
    for key, raw in zip(args[0::2], args[1::2]):
        try:
            value = ast.literal_eval(raw) if isinstance(raw, str) else raw
        except (ValueError, SyntaxError):
            value = raw
        node = nested
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return cfg_from_dict(cfg, nested)


def cfg_to_dict(cfg: Any) -> dict:
    """Dataclass tree -> plain nested dict (for logging / YAML dump)."""
    out = {}
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = cfg_to_dict(v) if is_dataclass(v) else v
    return out


def get_output_dir(cfg: Config, imdb_name: str, net_name: str | None = None) -> str:
    """Output directory convention mirroring the reference's ``get_output_dir``."""
    parts = [cfg.OUTPUT_DIR, cfg.EXP_DIR, imdb_name]
    if net_name:
        parts.append(net_name)
    path = os.path.join(*parts)
    os.makedirs(path, exist_ok=True)
    return path


# Module-level default (immutable; use the merge helpers to derive variants).
default_config = Config
