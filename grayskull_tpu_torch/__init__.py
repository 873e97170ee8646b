"""grayskull_tpu_torch: the PyTorch + CUDA port of grayskull-tpu.

The same uint8 NHW convention, module layout and function names as
``grayskull_tpu``, computed on each tensor's own device: a CUDA tensor runs
hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` on first use), a
CPU tensor their plain PyTorch versions.  Outputs are bit-exact with the JAX
package.  Two slices are ported, the preprocess main path and face detection::

    import grayskull_tpu_torch as gs
    frames = torch.as_tensor(gs.io.read_pgm_batch(paths)).cuda()
    # blur(2) -> Otsu -> threshold -> Sobel
    blurred, binary, edges, thresholds = gs.preprocess(frames)
    # integral -> LBP cascade over the scale ladder -> first 100 rects per frame
    rects = gs.detect_faces(frames)

The package imports no JAX and builds nothing at import.
"""

from . import cascade, core, io, kernels, ops, pipelines, profiling  # noqa: F401
from .cascade import load_frontalface, load_opencv_xml  # noqa: F401
from .core import LbpCascade, Point, Rect, Rects, as_image, is_batched  # noqa: F401
from .ops import (blur, histogram, integral, integral_sum, lbp_detect,  # noqa: F401
                  lbp_warm_start, lbp_window, otsu_from_histogram, otsu_threshold,
                  scale_ladder, sobel, threshold)
from .pipelines import detect_faces, preprocess, preprocess_reference  # noqa: F401

__all__ = [
    "LbpCascade",
    "Point",
    "Rect",
    "Rects",
    "as_image",
    "blur",
    "detect_faces",
    "histogram",
    "integral",
    "integral_sum",
    "is_batched",
    "lbp_detect",
    "lbp_warm_start",
    "lbp_window",
    "load_frontalface",
    "load_opencv_xml",
    "otsu_from_histogram",
    "otsu_threshold",
    "preprocess",
    "preprocess_reference",
    "scale_ladder",
    "sobel",
    "threshold",
]

__version__ = "0.1.0"
