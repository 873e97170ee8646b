"""LBP cascades for the faces reference, read with numpy alone.

A cascade is a dict of numpy arrays under the twelve field names of the
``gs_lbp_cascade`` data model (``window_w``, ``window_h``, ``features``,
``weak_*``, ``subsets``, ``stage_*``).  :func:`frontalface` reads the bundled
frontal-face cascade (OpenCV's ``lbpcascade_frontalface.xml``: a 24 x 24
window, 136 features, 139 weak classifiers in 20 stages) by path, as data.
"""

from __future__ import annotations

import numpy as np

from .spec import ROOT

FRONTALFACE = ROOT / "grayskull_tpu" / "data" / "frontalface.npz"


def frontalface() -> dict:
    with np.load(FRONTALFACE) as z:
        return {name: z[name] for name in z.files}
