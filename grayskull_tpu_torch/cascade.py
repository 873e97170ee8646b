"""LBP cascade loading — the ``gs_lbp_cascade`` data model
(grayskull.h:54-64) with two loaders, pure numpy like ``grayskull_tpu.cascade``:

* :func:`load_frontalface` — the bundled frontal-face cascade, read by path
  from ``grayskull_tpu/data/frontalface.npz`` (framework-neutral data, derived
  from OpenCV's public ``lbpcascade_frontalface.xml``);
* :func:`load_opencv_xml` — parse any OpenCV LBP cascade XML.
"""

from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET

import numpy as np

from .core import LbpCascade, lbp_cascade_from_arrays

__all__ = ["FRONTALFACE_PATH", "load_frontalface", "load_opencv_xml"]

FRONTALFACE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "grayskull_tpu", "data", "frontalface.npz")


@functools.lru_cache(maxsize=1)
def load_frontalface() -> LbpCascade:
    """The 24x24 / 136-feature / 139-weak / 20-stage frontal-face cascade.

    Memoized: :class:`LbpCascade` equality is identity, and ``ops.lbp`` caches
    each scale's device tables per cascade object, so ``detect_faces(img)``
    without a cascade argument reuses them across calls.
    """
    with np.load(FRONTALFACE_PATH) as z:
        return lbp_cascade_from_arrays(z)


def load_opencv_xml(path: str) -> LbpCascade:
    """Parse an OpenCV LBP cascade XML (``<featureType>LBP</featureType>``)."""
    root = ET.parse(path).getroot()
    cascade = root.find("cascade")
    if cascade is None:
        raise ValueError("not an OpenCV cascade file")
    ftype = cascade.findtext("featureType", "").strip()
    if ftype != "LBP":
        raise ValueError(f"featureType is {ftype!r}, only LBP is supported")
    out = {"window_w": int(cascade.findtext("width")),
           "window_h": int(cascade.findtext("height")),
           "features": [[int(v) for v in rect.findtext("rect").split()[:4]]
                        for rect in cascade.find("features")]}
    fields = ("weak_feature_idx", "weak_left_val", "weak_right_val", "weak_subset_offset",
              "weak_num_subsets", "subsets", "stage_weak_start", "stage_nweaks",
              "stage_threshold")
    out.update({name: [] for name in fields})
    for stage in cascade.find("stages"):
        out["stage_threshold"].append(float(stage.findtext("stageThreshold")))
        out["stage_weak_start"].append(len(out["weak_feature_idx"]))
        weaks = stage.find("weakClassifiers")
        out["stage_nweaks"].append(len(weaks))
        for weak in weaks:
            # left node, right node, feature index, then the int32 subset words
            nodes = weak.findtext("internalNodes").split()
            out["weak_feature_idx"].append(int(nodes[2]))
            words = [int(v) for v in nodes[3:]]
            out["weak_subset_offset"].append(len(out["subsets"]))
            out["weak_num_subsets"].append(len(words))
            out["subsets"].extend(words)
            left, right = weak.findtext("leafValues").split()[:2]
            out["weak_left_val"].append(float(left))
            out["weak_right_val"].append(float(right))
    return lbp_cascade_from_arrays(out)
