"""``lbp_faces_vga``: the port's ``detect_faces`` (the integral, the LBP cascade
over the scale ladder, the first ``max_rects`` windows in ladder order) on a
batch of frames with the bundled frontal-face cascade.  The rect table is
read back for every batch."""

import torch

from grayskull_tpu_torch.pipelines.faces import detect_faces

RESULT = "rects"  # the small output a batch is done with, once on the host


def call(frames, params):
    table = detect_faces(frames, max_rects=params["max_rects"],
                         scale_factor=params["scale_factor"], min_scale=params["min_scale"],
                         max_scale=params["max_scale"], step=params["step"])
    return {"n": table.n, "rects": torch.stack([table.x, table.y, table.w, table.h], -1)}
