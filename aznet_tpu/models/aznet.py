"""AZ-Net model: trunk + ROI pooling + adjacency/zoom head.

Reference equivalent: the AZ train/test prototxts (models/VGG16/az/*,
SURVEY.md §2.1) wired through pycaffe. Key structural difference from the
reference: the trunk runs ONCE per image and the head is a pure function of
(features, rois) — so the on-device search loop (aznet_tpu.search) can call
``roi_forward`` inside ``lax.while_loop`` with zero host round-trips, where
the reference re-enters Caffe from Python at every tree level (SURVEY.md
§3.1).
"""

from __future__ import annotations

import dataclasses
import functools

from aznet_tpu.models.backbones import RoiNet
from aznet_tpu.models.heads import AZHead


@dataclasses.dataclass(frozen=True)
class AZNet(RoiNet):
    """Zoom/adjacency proposal network (methods: see ``RoiNet``)."""

    @functools.cached_property
    def head(self):
        return AZHead(num_templates=self.model_cfg.NUM_TEMPLATES,
                      **self._head_kwargs())
