"""``document_scan``: the port's ``scan`` (blur r=1 -> Otsu + 10 -> blobs ->
largest blob's corners -> quad warp) on a batch of pages.  The corners are
read back for every batch."""

from grayskull_tpu_torch.pipelines.scan import scan

RESULT = "corners"  # the small output a batch is done with, once on the host


def call(frames, params):
    pages, corners = scan(frames, out_size=tuple(params["out_size"]),
                          max_blobs=params["max_blobs"])
    return {"pages": pages, "corners": corners}
