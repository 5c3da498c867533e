"""Network definitions in plain JAX (parameters as nested dicts).

The reference keeps architectures as Caffe prototxts under ``models/``
(SURVEY.md §2.1 "AZ network definitions"); here the modules ARE the
definition. Backbones output stride-16 feature maps consumed by ROI pooling
and the fc6/fc7 heads, mirroring the reference's VGG-16 → ROIPool(7x7, 1/16)
→ fc6/fc7 → heads topology. ``layers.py`` holds the shared layers and the
``init``/``apply`` protocol.
"""

from aznet_tpu.models.vgg import VGG16Trunk
from aznet_tpu.models.resnet import ResNet50Trunk
from aznet_tpu.models.small import SmallTrunk
from aznet_tpu.models.heads import AZHead, FRCNNHead
from aznet_tpu.models.aznet import AZNet
from aznet_tpu.models.frcnn import FRCNN
from aznet_tpu.models.backbones import get_backbone
