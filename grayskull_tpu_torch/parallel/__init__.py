"""Sharded paths: a device mesh, halo exchange between H-shards, and the
sharded pipelines, with ``grayskull_tpu.parallel``'s names.

The mesh is single-controller: one process drives every shard, as JAX's
``shard_map`` does, and a mesh may name one device several times (``cuda:0``
four times runs the real exchange on one card).  Two axes, as in the JAX package:

* **data** — frame batches sharded across devices;
* **space** — the H axis of frames sharded across devices, with halo rows
  exchanged for each stencil's radius and the histograms summed for Otsu.

Not ported yet: ``grayskull_tpu/parallel/sparse.py`` (sharded CCL, blobs, ORB,
LBP, faces and the spatial scanner).
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

__all__ = [
    "Mesh",
    "bottom_halo",
    "exchange_halo",
    "integral_sharded",
    "make_mesh",
    "match_template_sharded",
    "preprocess_sharded",
    "preprocess_spatial_shardmap",
    "scan_sharded",
]
