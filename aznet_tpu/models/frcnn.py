"""Fast R-CNN detector: trunk + ROI pooling + classification/bbox head.

Reference equivalent: the Fast R-CNN prototxts driven by
``lib/fast_rcnn/test.py::im_detect`` / ``train.py`` (SURVEY.md §2.2).
Same (features, rois) -> head factoring as AZNet so proposals from the
search can be scored end-to-end on device; the trunk can be SHARED with
AZNet by passing the same trunk params (the paper's shared-trunk evaluation,
SURVEY.md §2.1 "Shared-trunk / combined eval").
"""

from __future__ import annotations

import dataclasses
import functools

from aznet_tpu.models.backbones import RoiNet
from aznet_tpu.models.heads import FRCNNHead


@dataclasses.dataclass(frozen=True)
class FRCNN(RoiNet):
    """Detection head over proposal boxes (methods: see ``RoiNet``)."""

    @functools.cached_property
    def head(self):
        return FRCNNHead(num_classes=self.model_cfg.NUM_CLASSES,
                         **self._head_kwargs())
