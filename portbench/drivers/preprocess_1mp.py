"""``preprocess_1mp``: the port's ``preprocess`` (blur r=2 -> Otsu -> threshold
-> Sobel) on a batch of frames.  The thresholds are read back for every batch."""

from grayskull_tpu_torch.pipelines.preproc import preprocess

RESULT = "thresholds"  # the small output a batch is done with, once on the host


def call(frames, params):
    blurred, binary, edges, thresholds = preprocess(frames, radius=params["radius"],
                                                    want_binary=params["want_binary"])
    return {"blurred": blurred, "binary": binary, "edges": edges, "thresholds": thresholds}
