"""nanomagick-compatible CLI — the reference's 14-command image tool
(examples/nanomagick/nanomagick.c) on the port's ops and pipelines, with the
argv, messages, exit codes and drawing helpers of ``grayskull_tpu/cli.py``.

Usage: ``python -m grayskull_tpu_torch.cli <command> [params] [input.pgm]
[output.pgm]`` (or the ``nanomagick-torch`` script; ``-`` reads stdin / writes
stdout).  Images are decoded on the host and go to the CUDA device; results
come back to the host to be drawn on and written.  :func:`main` called inside
``grayskull_tpu_torch.core.host_arrays_to("cpu")`` runs every command on the
CPU instead, with the kernels' plain versions.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import io as gio
from . import ops, pipelines

__all__ = ["main"]


def _host(t) -> np.ndarray:
    """A result tensor back on the host."""
    return t.cpu().numpy()


def _err(msg):
    print(f"Error: {msg}", file=sys.stderr)


# --- drawing helpers (host-side, mirror nanomagick.c) -----------------------


def draw_line(img: np.ndarray, x1, y1, x2, y2, color):
    """Bresenham line (nanomagick.c:172-184)."""
    h, w = img.shape
    x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
    dx, dy = abs(x2 - x1), abs(y2 - y1)
    sx = 1 if x1 < x2 else -1
    sy = 1 if y1 < y2 else -1
    err = dx - dy
    x, y = x1, y1
    while True:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color
        if x == x2 and y == y2:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x += sx
        if e2 < dx:
            err += dx
            y += sy


# --- commands ---------------------------------------------------------------


def cmd_identify(img, argv):
    print(f"Portable Graymap, {img.shape[1]}x{img.shape[0]} ({img.size}) pixels")
    return None


def cmd_view(img, argv):
    """Terminal renderer (nanomagick.c:17-57): 256-color half blocks or ASCII."""
    term = os.environ.get("TERM", "")
    use_256 = "256color" in term
    term_width = 80
    try:
        term_width = os.get_terminal_size().columns
    except OSError:
        pass
    h, w = img.shape
    display_width = term_width - 2
    display_height = (h * display_width) // (w * (1 if use_256 else 2))
    out = []
    if use_256:
        for y in range(0, display_height, 2):
            row = []
            for x in range(display_width):
                ix = (x * w) // display_width
                iy1 = (y * h) // display_height
                iy2 = ((y + 1) * h) // display_height
                p1 = img[iy1, ix]
                p2 = img[iy2, ix] if iy2 < h else p1
                c1 = 232 + (int(p1) * 23) // 255
                c2 = 232 + (int(p2) * 23) // 255
                row.append(f"\x1b[38;5;{c1};48;5;{c2}m▀")
            out.append("".join(row) + "\x1b[0m")
    else:
        blocks = [" ", "░", "▒", "▓", "█"]
        for y in range(display_height):
            row = []
            for x in range(display_width):
                ix = (x * w) // display_width
                iy = (y * h) // display_height
                row.append(blocks[min((int(img[iy, ix]) * 4) // 255, 4)])
            out.append("".join(row))
    print("\n".join(out) + "\n")
    return None


def cmd_resize(img, argv):
    w, h = int(argv[0]), int(argv[1])
    if w <= 0 or h <= 0:
        _err("Invalid width or height")
        return None
    return _host(ops.resize(img, (h, w)))


def cmd_crop(img, argv):
    x, y, w, h = (int(v) for v in argv[:4])
    ih, iw = img.shape
    if x < 0 or y < 0 or w <= 0 or h <= 0 or x + w > iw or y + h > ih:
        _err("Invalid crop rectangle")
        return None
    return _host(ops.crop(img, (x, y, w, h)))


def cmd_blur(img, argv):
    r = int(argv[0])
    if r <= 0:
        _err(f"Invalid radius: {argv[0]}")
        return None
    return _host(ops.blur(img, r))


def cmd_threshold(img, argv):
    t = int(ops.otsu_threshold(img)) if argv[0] == "otsu" else int(argv[0])
    if t <= 0:
        _err(f"Invalid threshold: {argv[0]}")
        return None
    return _host(ops.threshold(img, t))


def cmd_adaptive(img, argv):
    r, c = int(argv[0]), int(argv[1])
    if r <= 0 or c < 0:
        _err("Invalid radius or constant")
        return None
    return _host(ops.adaptive_threshold(img, r, c))


def cmd_sobel(img, argv):
    return _host(ops.sobel(img))


def cmd_morph(img, argv):
    op, n = argv[0], int(argv[1])
    if op not in ("erode", "dilate") or n <= 0:
        _err("Invalid morphological operation or iterations")
        return None
    out = img
    fn = ops.erode if op == "erode" else ops.dilate
    for _ in range(n):
        out = fn(out)
    return _host(out)


def cmd_blobs(img, argv):
    n = int(argv[0])
    if n <= 0:
        _err("Invalid number of blobs")
        return None
    table, labels, _ = ops.blobs(img, n)
    nb = int(table.n)
    out = np.zeros_like(img)
    bx = _host(table.box.x)[:nb]
    by = _host(table.box.y)[:nb]
    bw = _host(table.box.w)[:nb]
    bh = _host(table.box.h)[:nb]
    h, w = img.shape
    # nanomagick.c:161-168: filled 128 boxes (2px margin), then bright pixels 255
    for i in range(nb):
        x1, y1 = max(0, int(bx[i]) - 2), max(0, int(by[i]) - 2)
        x2 = min(w, int(bx[i] + bw[i]) + 2)
        y2 = min(h, int(by[i] + bh[i]) + 2)
        out[y1 : y2 + 1, x1 : x2 + 1] = 128
    out[img > 128] = 255
    return out


def cmd_scan(img, argv):
    page, _ = pipelines.scan(img)
    return _host(page)


def cmd_keypoints(img, argv):
    n, t = int(argv[0]), int(argv[1])
    if n <= 0 or t < 0:
        _err("Invalid number of keypoints or threshold")
        return None
    kps, _ = ops.fast(img, 5000, t)
    nk = int(kps.n)
    xs = _host(kps.x)[:nk]
    ys = _host(kps.y)[:nk]
    resp = _host(kps.response)[:nk]
    order = np.argsort(-resp, kind="stable")
    out = img.copy()
    for i in order[: min(n, nk)]:
        x, y = int(xs[i]), int(ys[i])
        for d in range(-2, 3):
            if 0 <= y + d < img.shape[0] and 0 <= x < img.shape[1]:
                out[y + d, x] = 255
            if 0 <= y < img.shape[0] and 0 <= x + d < img.shape[1]:
                out[y, x + d] = 255
    return out


def cmd_orb(img, argv):
    template = gio.read_pgm(argv[0])
    if template is None:
        print(f"Error: Cannot load template image {argv[0]}")
        return None
    tk, sk, m = pipelines.track(template, img)
    nt, ns, nm = int(tk.n), int(sk.n), int(m.n)
    print(f"Template: {nt} keypoints, Scene: {ns} keypoints, Matches: {nm}")
    if nm == 0:
        return None
    # sort matches by distance (selection order like nanomagick.c:315-321)
    i1 = _host(m.idx1)[:nm].copy()
    i2 = _host(m.idx2)[:nm].copy()
    dist = _host(m.distance)[:nm].copy()
    for i in range(nm - 1):
        for j in range(i + 1, nm):
            if dist[j] < dist[i]:
                dist[i], dist[j] = dist[j], dist[i]
                i1[i], i1[j] = i1[j], i1[i]
                i2[i], i2[j] = i2[j], i2[i]
    th, tw = template.shape
    sh, sw = img.shape
    out = np.zeros((max(th, sh), tw + sw), np.uint8)
    out[:th, :tw] = template
    out[:sh, tw:] = img
    tx = _host(tk.x)
    ty = _host(tk.y)
    sx = _host(sk.x)
    sy = _host(sk.y)
    for i in range(min(15, nm)):
        draw_line(out, tx[i1[i]], ty[i1[i]], sx[i2[i]] + tw, sy[i2[i]], 255)
    return out


def cmd_faces(img, argv):
    step = int(argv[0]) if argv and argv[0] else 1
    if step <= 0:
        _err("minimum neighbors must be positive")
        return None
    rects = pipelines.detect_faces(img, step=step)
    n = int(rects.n)
    out = img.copy()
    xs = _host(rects.x)[:n]
    ys = _host(rects.y)[:n]
    ws = _host(rects.w)[:n]
    hs = _host(rects.h)[:n]
    for i in range(n):
        x, y, w, h = int(xs[i]), int(ys[i]), int(ws[i]), int(hs[i])
        draw_line(out, x, y, x + w, y, 255)
        draw_line(out, x, y + h, x + w, y + h, 255)
        draw_line(out, x, y, x, y + h, 255)
        draw_line(out, x + w, y, x + w, y + h, 255)
    return out


COMMANDS = {
    # name: (help, argc, has_output, fn)
    "identify": ("             Show image information", 0, False, cmd_identify),
    "view": ("                 Display image in terminal", 0, False, cmd_view),
    "resize": ("<w> <h>        Resize image to WxH", 2, True, cmd_resize),
    "crop": ("<x> <y> <w> <h>  Crop image to rectangle (x,y,w,h)", 4, True, cmd_crop),
    "blur": ("<r>              Blur image with radius R", 1, True, cmd_blur),
    "threshold": ("<t>         Apply threshold (0-255 or otsu)", 1, True, cmd_threshold),
    "adaptive": ("<r> <c>      Apply adaptive threshold, radius R and constant C", 2, True,
                 cmd_adaptive),
    "sobel": ("                Edge detection (Sobel)", 0, True, cmd_sobel),
    "morph": ("<op> <n>        Morphological operation (erode/dilate) N times", 2, True,
              cmd_morph),
    "blobs": ("<n>             Find up to N blobs", 1, True, cmd_blobs),
    "scan": ("                 Simple document scanner", 0, True, cmd_scan),
    "keypoints": ("<n> <t>     Detect N keypoints with threshold T", 2, True, cmd_keypoints),
    "orb": ("<template.pgm>    Find template in scene using ORB features", 1, True, cmd_orb),
    "faces": ("<n>             Detect faces using LBP cascade with N minNeighbors", 1, True,
              cmd_faces),
}


def usage(app):
    print(f"Usage: {app} <command> [params] [input.pgm] [output.pgm]\n")
    print("Commands:")
    for name, (help_, *_rest) in COMMANDS.items():
        print(f"  {name} {help_}")


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    app = argv[0] if argv else "nanomagick"
    if len(argv) < 2 or argv[1] in ("--help", "-h"):
        usage(app)
        return 1
    name = argv[1]
    if name not in COMMANDS:
        print(f"Error: Unknown command '{name}'")
        return 1
    _, argc, hasout, fn = COMMANDS[name]
    if len(argv) != argc + (1 if hasout else 0) + 3:
        _err(f"Wrong number of arguments for '{name}'")
        usage(app)
        return 1
    in_path = argv[argc + 2]
    img = gio.read_pgm(in_path)
    if img is None:
        _err(f"Could not load {in_path}")
        return 1
    from . import structlog

    # the block closes once the output is written: elapsed_ms is the whole command
    with structlog.timed("cli.command", command=name, input=in_path,
                         shape=list(img.shape)):
        out = fn(img, argv[2 : 2 + argc])
        if hasout:
            if out is None:
                _err(f"Command '{name}' did not produce output image")
                return 1
            out_path = argv[argc + 3]
            if gio.write_pgm(out, out_path) != 0:
                _err(f"Could not save {out_path}")
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
