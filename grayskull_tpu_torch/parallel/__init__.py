"""Sharded paths: a device mesh, halo exchange between H-shards, and the
sharded pipelines, with ``grayskull_tpu.parallel``'s names.

The mesh is single-controller: one process drives every shard, as JAX's
``shard_map`` does, and a mesh may name one device several times (``cuda:0``
four times runs the real exchange on one card).  Two axes, as in the JAX package:

* **data** — frame batches sharded across devices;
* **space** — the H axis of frames sharded across devices, with halo rows
  exchanged for each stencil's radius and the histograms summed for Otsu.

:mod:`.sharded` holds the dense paths (preprocess, the integral, template
matching, the data-parallel scanner); :mod:`.sparse` the sparse ones (CCL,
blob statistics, the spatial scanner, ORB, matching, LBP and faces).  The
outputs land on the mesh's first device.
"""

from .halo import bottom_halo, exchange_halo  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    integral_sharded,
    match_template_sharded,
    preprocess_sharded,
    preprocess_spatial_shardmap,
    scan_sharded,
)
from .sparse import (  # noqa: F401
    blobs_sharded,
    detect_faces_sharded,
    label_components_sharded,
    lbp_detect_sharded,
    match_orb_sharded,
    orb_extract_spatial,
    scan_spatial_shardmap,
)

__all__ = [
    "make_mesh",
    "bottom_halo",
    "exchange_halo",
    "integral_sharded",
    "match_template_sharded",
    "scan_sharded",
    "preprocess_sharded",
    "preprocess_spatial_shardmap",
    "blobs_sharded",
    "detect_faces_sharded",
    "label_components_sharded",
    "match_orb_sharded",
    "orb_extract_spatial",
    "scan_spatial_shardmap",
    "lbp_detect_sharded",
    "Mesh",
]
