"""Hand-written Pallas kernels for the GPU (``backend="triton"``).

Reference equivalents (SURVEY.md §2.3): the reference's "native layer" —
the CUDA NMS kernel. Each kernel keeps a plain-JAX version beside it as its
reference, and runs in interpret mode in the CPU tests.
"""

from aznet_tpu.ops.pallas.nms_triton import nms_sorted_triton
