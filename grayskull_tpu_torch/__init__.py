"""grayskull_tpu_torch: the PyTorch + CUDA port of grayskull-tpu.

The same uint8 NHW convention, module layout and function names as
``grayskull_tpu``, computed on each tensor's own device: a CUDA tensor runs
hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` on first use), a
CPU tensor their plain PyTorch versions.  Outputs are bit-exact with the JAX
package.  This slice covers the preprocess main path::

    import grayskull_tpu_torch as gs
    frames = torch.as_tensor(gs.io.read_pgm_batch(paths)).cuda()
    # blur(2) -> Otsu -> threshold -> Sobel
    blurred, binary, edges, thresholds = gs.preprocess(frames)

The package imports no JAX and builds nothing at import.
"""

from . import core, io, kernels, ops, pipelines, profiling  # noqa: F401
from .core import Point, Rect, as_image, is_batched  # noqa: F401
from .ops import (blur, histogram, otsu_from_histogram, otsu_threshold,  # noqa: F401
                  sobel, threshold)
from .pipelines import preprocess, preprocess_reference  # noqa: F401

__all__ = [
    "Point",
    "Rect",
    "as_image",
    "blur",
    "histogram",
    "is_batched",
    "otsu_from_histogram",
    "otsu_threshold",
    "preprocess",
    "preprocess_reference",
    "sobel",
    "threshold",
]

__version__ = "0.1.0"
