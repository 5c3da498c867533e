"""The adjacency-and-zoom region search (the reason this framework exists).

Reference equivalent: ``lib/detect/test.py::im_propose`` (SURVEY.md §2.1,
§3.1) — a HOST-driven recursion with a GPU round-trip and per-box NumPy
loops at every tree level. Here the entire search is one on-device
``lax.while_loop`` over fixed-shape padded frontiers: zoom gating, region
division, delta decoding, candidate accumulation (top-K eviction) and final
NMS all stay on the device; the host sees only the final (N, 5) proposals.
"""

from aznet_tpu.search.templates import (
    adjacency_templates,
    template_boxes,
    divide_regions,
    NUM_DIVISIONS,
)
from aznet_tpu.search.propose import az_search, init_frontier
from aznet_tpu.search.oracle import az_search_oracle
