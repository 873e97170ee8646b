"""grayskull_tpu_torch: the PyTorch + CUDA port of grayskull-tpu.

The same uint8 NHW convention, module layout and function names as
``grayskull_tpu``, computed on each tensor's own device: a CUDA tensor runs
hand-written Hopper kernels (``csrc/*.cu``, built with ``nvcc`` on first use), a
CPU tensor their plain PyTorch versions; a numpy array goes to the CUDA device
(:func:`core.host_arrays_to` asks for the CPU instead).  Outputs are bit-exact
with the JAX package.  Seven slices are ported: the preprocess main path, face
detection, ORB, the document scanner, the rest of the dense pixel ops with the
nanomagick CLI (``python -m grayskull_tpu_torch.cli``) on top, the sharded
paths of :mod:`.parallel` with the bandwidth probe of :mod:`.profiling`, and
template matching and contour tracing::

    import grayskull_tpu_torch as gs
    frames = gs.as_image(gs.io.read_pgm_batch(paths))   # on the card
    # blur(2) -> Otsu -> threshold -> Sobel
    blurred, binary, edges, thresholds = gs.preprocess(frames)
    # integral -> LBP cascade over the scale ladder -> first 100 rects per frame
    rects = gs.detect_faces(frames)
    # FAST -> oriented rBRIEF: 500 keypoints per frame
    kps = gs.orb_extract(frames, 500, 20)
    # pyramid ORB on two frames -> Hamming matches
    tmpl_kps, scene_kps, matches = gs.track(frames[0], frames[1])
    # blur(1) -> Otsu+10 -> blobs -> largest blob's corners -> 1000x800 page
    pages, corners = gs.scan(frames)
    # adaptive threshold -> dilate -> erode (BASELINE config #2), bilinear resize
    clean = gs.erode(gs.dilate(gs.adaptive_threshold(frames, 15, 5)))
    small = gs.resize(frames, (480, 640))
    # the same preprocess with each frame's rows split over 4 shards of one card
    mesh = gs.parallel.make_mesh((1, 4), devices=["cuda:0"] * 4)
    blurred, binary, edges, thresholds = gs.parallel.preprocess_spatial_shardmap(frames, mesh)
    rates = gs.profiling.hbm_bandwidth_gbps()   # {"copy_gbps": ..., "triad_gbps": ...}
    # SSD template match of every frame (one launch), the best placement of each
    scores = gs.match_template(frames, frames[0, 200:232, 300:332])
    xs, ys = gs.find_best_match(scores)
    # the same with each frame's rows split over 4 shards
    scores = gs.parallel.match_template_sharded(frames, frames[0, 200:232, 300:332], mesh)
    # every blob's outer contour of one binary frame, in one launch
    table = gs.find_contours(gs.threshold(frames[0], 128), 16, 64)
    # the reference's GS_NO_STDLIB trig (K21 on the card) for the ORB path
    gs.libm32.use_freestanding(True)

``debug`` dumps frames to PGMs, guards float code against NaNs and draws
overlays; ``examples/stream_demo_torch.py`` and ``examples/live_demo_torch.py``
are the JAX package's demos on the port.

The package imports no JAX and builds nothing at import.
"""

from . import (cascade, core, debug, io, kernels, libm32, native, ops,  # noqa: F401
               parallel, pipelines, profiling, structlog)
from .cascade import load_frontalface, load_opencv_xml  # noqa: F401
from .core import (Blobs, Contour, Keypoints, LbpCascade, Matches, Point, Rect,  # noqa: F401
                   Rects, as_image, is_batched)
from .ops import (BLUR_BOX_KERNEL, BLUR_GAUSSIAN_KERNEL, EMBOSS_KERNEL,  # noqa: F401
                  SHARPEN_KERNEL, Contours, adaptive_threshold, blob_corners, blobs, blur,
                  blur_box, blur_gaussian, brief_descriptor, compute_orientation, copy, crop,
                  dilate, downsample, emboss, erode, fast, fast_scoremap, filter2d,
                  find_best_match, find_contours, hamming_distance, histogram, integral,
                  integral_sum, label_components, largest_blob_contour, lbp_detect,
                  lbp_warm_start, lbp_window, match_orb, match_template, orb_extract,
                  otsu_from_histogram, otsu_threshold, perspective_correct, resize, resize_nn,
                  scale_ladder, sharpen, sobel, threshold, trace_contour)
from .pipelines import (detect_faces, extract_pyramid_orb, preprocess,  # noqa: F401
                        preprocess_binarize, preprocess_reference, scan, track)

__all__ = [
    "BLUR_BOX_KERNEL",
    "BLUR_GAUSSIAN_KERNEL",
    "Blobs",
    "Contour",
    "Contours",
    "EMBOSS_KERNEL",
    "Keypoints",
    "LbpCascade",
    "Matches",
    "Point",
    "Rect",
    "Rects",
    "SHARPEN_KERNEL",
    "adaptive_threshold",
    "as_image",
    "blob_corners",
    "blobs",
    "blur",
    "blur_box",
    "blur_gaussian",
    "brief_descriptor",
    "compute_orientation",
    "copy",
    "crop",
    "detect_faces",
    "dilate",
    "downsample",
    "emboss",
    "erode",
    "extract_pyramid_orb",
    "fast",
    "fast_scoremap",
    "filter2d",
    "find_best_match",
    "find_contours",
    "hamming_distance",
    "histogram",
    "integral",
    "integral_sum",
    "is_batched",
    "label_components",
    "largest_blob_contour",
    "lbp_detect",
    "lbp_warm_start",
    "lbp_window",
    "load_frontalface",
    "load_opencv_xml",
    "match_orb",
    "match_template",
    "orb_extract",
    "otsu_from_histogram",
    "otsu_threshold",
    "perspective_correct",
    "preprocess",
    "preprocess_binarize",
    "preprocess_reference",
    "resize",
    "resize_nn",
    "scale_ladder",
    "scan",
    "sharpen",
    "sobel",
    "threshold",
    "trace_contour",
    "track",
]

__version__ = "0.1.0"
