"""aznet_tpu — an adjacency-and-zoom proposal + detection framework in JAX.

JAX/XLA/Pallas implementation of the capabilities of the reference
``luyongxi/az-net`` (AZ-Net, CVPR 2016; see SURVEY.md). Not a port: the
reference's host-driven recursive region search becomes an on-device
``lax.while_loop`` over padded frontiers; its Cython NMS / CUDA ROIPooling
become vectorized JAX plus a Pallas (Triton) NMS kernel; its Caffe prototxt
nets become plain-JAX modules; training is data-parallel ``pjit`` over a
device mesh.

Public API mirrors the reference (SURVEY.md §3):
  - ``aznet_tpu.api.im_propose`` — scored proposal generation (reference
    ``lib/detect/test.py::im_propose``).
  - ``aznet_tpu.api.im_detect``  — Fast-R-CNN-style detection head forward
    (reference ``lib/fast_rcnn/test.py::im_detect``).
"""

__version__ = "0.1.0"
