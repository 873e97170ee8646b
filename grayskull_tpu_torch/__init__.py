"""grayskull_tpu_torch: the PyTorch + CUDA port of grayskull-tpu.

The same uint8 NHW convention, module layout and function names as
``grayskull_tpu``, computed on each tensor's own device: a CUDA tensor runs
hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` on first use), a
CPU tensor their plain PyTorch versions.  Outputs are bit-exact with the JAX
package.  Three slices are ported, the preprocess main path, face detection and
ORB::

    import grayskull_tpu_torch as gs
    frames = torch.as_tensor(gs.io.read_pgm_batch(paths)).cuda()
    # blur(2) -> Otsu -> threshold -> Sobel
    blurred, binary, edges, thresholds = gs.preprocess(frames)
    # integral -> LBP cascade over the scale ladder -> first 100 rects per frame
    rects = gs.detect_faces(frames)
    # FAST -> oriented rBRIEF: 500 keypoints per frame
    kps = gs.orb_extract(frames, 500, 20)
    # pyramid ORB on two frames -> Hamming matches
    tmpl_kps, scene_kps, matches = gs.track(frames[0], frames[1])

The package imports no JAX and builds nothing at import.
"""

from . import cascade, core, io, kernels, libm32, ops, pipelines, profiling  # noqa: F401
from .cascade import load_frontalface, load_opencv_xml  # noqa: F401
from .core import (Keypoints, LbpCascade, Matches, Point, Rect, Rects, as_image,  # noqa: F401
                   is_batched)
from .ops import (blur, brief_descriptor, compute_orientation, downsample, fast,  # noqa: F401
                  fast_scoremap, hamming_distance, histogram, integral, integral_sum,
                  lbp_detect, lbp_warm_start, lbp_window, match_orb, orb_extract,
                  otsu_from_histogram, otsu_threshold, scale_ladder, sobel, threshold)
from .pipelines import (detect_faces, extract_pyramid_orb, preprocess,  # noqa: F401
                        preprocess_reference, track)

__all__ = [
    "Keypoints",
    "LbpCascade",
    "Matches",
    "Point",
    "Rect",
    "Rects",
    "as_image",
    "blur",
    "brief_descriptor",
    "compute_orientation",
    "detect_faces",
    "downsample",
    "extract_pyramid_orb",
    "fast",
    "fast_scoremap",
    "hamming_distance",
    "histogram",
    "integral",
    "integral_sum",
    "is_batched",
    "lbp_detect",
    "lbp_warm_start",
    "lbp_window",
    "load_frontalface",
    "load_opencv_xml",
    "match_orb",
    "orb_extract",
    "otsu_from_histogram",
    "otsu_threshold",
    "preprocess",
    "preprocess_reference",
    "scale_ladder",
    "sobel",
    "threshold",
    "track",
]

__version__ = "0.1.0"
