#!/usr/bin/env python3
"""Interactive browser demo on the PyTorch + CUDA port — ``examples/live_demo.py``
on ``grayskull_tpu_torch``: the same page, endpoints and JSON bodies.

The reference runs grayskull compiled to wasm32 in the browser with a
pipeline-builder UI, a per-frame pipeline executor and overlay renderers
(its ``examples/wasm/grayskull.js``).  Here the same interaction runs against
the port over HTTP:

* ``GET /``       — single-file HTML/JS page: canvas, pipeline builder,
                    analyzer toggles, play/pause, fps counter, webcam
                    controls;
* ``GET /frame``  — query params ``i`` (frame index), ``pipeline`` (the same
                    ``blur:2,threshold:otsu,...`` specs as the stream demo)
                    and ``analyzers``; returns JSON with the processed
                    grayscale frame (base64) plus blob / keypoint / face /
                    contour / match tables for the browser-side overlays;
* ``POST /frame`` — same query params plus a raw grayscale frame (h*w bytes)
                    as the request body (the page's webcam loop);
                    ``capture=1`` stores the posted frame as the ORB template.

Bad pipeline ops and frame sizes are a 400 with an ``error`` body.  Without a
camera, frames are synthesized webcam-style or read from ``--src`` (a
directory of PGMs); the ORB analyzer then tracks frame 0 as the template.

:class:`Demo` runs on its ``device``: every frame becomes a tensor there, and
the work runs under ``core.host_arrays_to(device)``, which the server's
handler threads would not inherit.  ``main`` serves from the CUDA device and
fails without one.

Usage::

    python examples/live_demo_torch.py [--port 8400] [--size 240x320] [--src dir]

then open http://localhost:8400/.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import grayskull_tpu_torch as gs  # noqa: E402
from grayskull_tpu_torch.core import host_arrays_to  # noqa: E402
from stream_demo_torch import build_pipeline, synth_frames  # noqa: E402

_LOCK = threading.Lock()  # one request on the device at a time


def _rows(*columns) -> list:
    """Host columns side by side as a JSON-ready list of rows."""
    return np.stack([c.cpu().numpy() if isinstance(c, torch.Tensor) else c for c in columns],
                    axis=1).tolist()


class Demo:
    def __init__(self, frames: np.ndarray, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("live_demo_torch: no CUDA device; Demo(frames, device='cpu') "
                               "runs on the CPU")
        self.frames = frames
        self.h, self.w = frames.shape[1:]
        self._dense_cache = {}  # spec -> (dense fn, analyzers)
        self._template_kps = None

    def dense(self, spec: str):
        if spec not in self._dense_cache:
            self._dense_cache[spec] = build_pipeline(spec or "blur:1")
        return self._dense_cache[spec]

    def _tensor(self, raw: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(raw, np.uint8)).to(self.device)

    def frame(self, i: int, spec: str, analyzers: list[str]) -> dict:
        return self.process(self.frames[i % len(self.frames)], spec, analyzers)

    def capture_template(self, raw: np.ndarray) -> int:
        """Store ``raw`` as the ORB tracking template; returns its kp count."""
        with _LOCK, host_arrays_to(self.device):
            self._template_kps = gs.ops.orb_extract(self._tensor(raw), 200, 20)
            return int(self._template_kps.n)

    def process(self, raw: np.ndarray, spec: str, analyzers: list[str]) -> dict:
        fn, spec_analyzers = self.dense(spec)
        with _LOCK, host_arrays_to(self.device):
            frame = self._tensor(raw)
            out_t = fn(frame)
            out = out_t.cpu().numpy()
            resp = {
                "w": self.w, "h": self.h,
                "pixels": base64.b64encode(out.tobytes()).decode(),
            }
            for name in analyzers + [a for a, _ in spec_analyzers]:
                if name == "blobs":
                    table, _, _ = gs.ops.blobs(out_t, 100)
                    n = int(table.n)
                    box = table.box
                    resp["blobs"] = _rows(box.x[:n], box.y[:n], box.w[:n], box.h[:n])
                elif name == "keypoints":
                    kps, _ = gs.ops.fast(frame, 200, 20)
                    n = int(kps.n)
                    resp["keypoints"] = _rows(kps.x[:n], kps.y[:n])
                elif name == "faces":
                    rects = gs.pipelines.detect_faces(frame, step=2)
                    n = int(rects.n)
                    resp["faces"] = _rows(rects.x[:n], rects.y[:n], rects.w[:n], rects.h[:n])
                elif name == "contours":
                    cs = gs.ops.find_contours(out_t, max_contours=16)
                    n = int(cs.n)
                    box = cs.box
                    resp["contours"] = _rows(box.x[:n], box.y[:n], box.w[:n], box.h[:n])
                elif name == "orb":
                    # template = frame 0 (or, for camera streams, the first
                    # posted frame) until the capture button stores one —
                    # like the WASM demo's captureTemplate
                    if self._template_kps is None:
                        tmpl = self.frames[0] if len(self.frames) else raw
                        self._template_kps = gs.ops.orb_extract(self._tensor(tmpl), 200, 20)
                    tk = self._template_kps
                    kps = gs.ops.orb_extract(frame, 200, 20)
                    m = gs.ops.match_orb(tk, kps, 100, 64)
                    n = int(m.n)
                    i1 = m.idx1[:n].long()
                    i2 = m.idx2[:n].long()
                    resp["matches"] = _rows(tk.x[i1], tk.y[i1], kps.x[i2], kps.y[i2])
        return resp


_PAGE = """<!doctype html>
<meta charset="utf-8"><title>grayskull-tpu live demo</title>
<style>
 body{font:14px system-ui;margin:20px;background:#111;color:#ddd}
 canvas{border:1px solid #444;image-rendering:pixelated}
 select,button{margin:2px;padding:4px 8px;background:#222;color:#ddd;border:1px solid #555}
 #chain span{display:inline-block;background:#234;border:1px solid #468;margin:2px;padding:2px 6px;cursor:pointer}
 label{margin-right:10px}
</style>
<h3>grayskull-tpu live demo</h3>
<div>
 <select id="op">
  <option>blur:2</option><option>threshold:otsu</option><option>threshold:128</option>
  <option>adaptive:5:5</option><option>erode</option><option>dilate</option>
  <option>sobel</option><option>sharpen</option><option>emboss</option>
 </select>
 <button onclick="addOp()">add step</button>
 <span id="chain"></span>
</div>
<div>
 <label><input type="checkbox" id="blobs">blobs</label>
 <label><input type="checkbox" id="keypoints">keypoints</label>
 <label><input type="checkbox" id="faces">faces</label>
 <label><input type="checkbox" id="contours">contours</label>
 <label><input type="checkbox" id="orb">orb track</label>
 <button onclick="running=!running;loop()">play/pause</button>
 <span id="fps"></span>
</div>
<div>
 <select id="cams"><option value="">camera…</option></select>
 <button onclick="startCam()">start camera</button>
 <button onclick="stopCam()">stop</button>
 <button onclick="captureTpl()">capture template</button>
 <span id="camstat"></span>
</div>
<canvas id="cv"></canvas>
<script>
let chain = ["blur:2", "threshold:otsu"], i = 0, running = true, busy = false;
let t0 = performance.now(), shown = 0;
// --- webcam capture (the reference frontend's getUserMedia loop,
// grayskull.js:116-169/257-269, retargeted at POST /frame) ---
const CW = __W__, CH = __H__;
let camOn = false, video = null, stream = null;
const cap = document.createElement("canvas"); cap.width = CW; cap.height = CH;
async function listCams(){
  try {
    const tmp = await navigator.mediaDevices.getUserMedia({video: true});
    const devs = await navigator.mediaDevices.enumerateDevices();
    tmp.getTracks().forEach(t => t.stop());
    const sel = document.getElementById("cams");
    sel.innerHTML = "";
    devs.filter(d => d.kind === "videoinput").forEach((d, k) => {
      const o = document.createElement("option");
      o.value = d.deviceId; o.textContent = d.label || `camera ${k+1}`;
      sel.appendChild(o);
    });
  } catch(e){ document.getElementById("camstat").textContent = "no camera: " + e.message; }
}
async function startCam(){
  if (document.getElementById("cams").options[0].value === "") await listCams();
  stopCam();
  const id = document.getElementById("cams").value;
  const c = {video: {width: {ideal: CW}, height: {ideal: CH}, frameRate: {ideal: 30}}};
  if (id) c.video.deviceId = {ideal: id};
  try {
    stream = await navigator.mediaDevices.getUserMedia(c);
    video = document.createElement("video");
    video.muted = true; video.playsInline = true;
    video.srcObject = stream; await video.play();
    camOn = true;
    document.getElementById("camstat").textContent = "camera live";
  } catch(e){ document.getElementById("camstat").textContent = "camera failed: " + e.message; }
}
function stopCam(){
  if (stream) stream.getTracks().forEach(t => t.stop());
  stream = null; camOn = false;
  document.getElementById("camstat").textContent = "";
}
function grabGray(){
  const g2d = cap.getContext("2d");
  g2d.drawImage(video, 0, 0, CW, CH);
  const rgba = g2d.getImageData(0, 0, CW, CH).data;
  // reference luma weights; Uint8Array stores truncate (grayskull.js:33-38)
  const gray = new Uint8Array(CW * CH);
  for (let p = 0; p < gray.length; p++)
    gray[p] = 0.299*rgba[4*p] + 0.587*rgba[4*p+1] + 0.114*rgba[4*p+2];
  return gray;
}
async function captureTpl(){
  if (!camOn) return;
  const r = await fetch("/frame?capture=1", {method: "POST", body: grabGray()});
  const d = await r.json();
  document.getElementById("camstat").textContent =
    d.error ? d.error : `template: ${d.template_kps} keypoints`;
}
function drawChain(){
  document.getElementById("chain").innerHTML = chain.map(
    (c, k) => `<span onclick="chain.splice(${k},1);drawChain()">${c} ×</span>`).join("→");
}
function addOp(){ chain.push(document.getElementById("op").value); drawChain(); }
drawChain();
async function loop(){
  if (!running || busy) return;
  busy = true;
  const an = ["blobs","keypoints","faces","contours","orb"].filter(
      a => document.getElementById(a).checked);
  const q = `pipeline=${chain.join(",")}&analyzers=${an}`;
  const r = (camOn && video && video.readyState >= 2)
    ? await fetch(`/frame?${q}`, {method: "POST", body: grabGray()})
    : await fetch(`/frame?i=${i++}&${q}`);
  const d = await r.json();
  const cv = document.getElementById("cv");
  cv.width = d.w; cv.height = d.h;
  const ctx = cv.getContext("2d");
  const bytes = Uint8Array.from(atob(d.pixels), c => c.charCodeAt(0));
  const img = ctx.createImageData(d.w, d.h);
  for (let p = 0; p < bytes.length; p++){
    img.data[4*p] = img.data[4*p+1] = img.data[4*p+2] = bytes[p]; img.data[4*p+3] = 255;
  }
  ctx.putImageData(img, 0, 0);
  ctx.lineWidth = 1;
  // overlay renderers — same shapes as grayskull.js:349-563
  ctx.strokeStyle = "#4f4";
  for (const [x,y,w,h] of (d.blobs||[])) ctx.strokeRect(x+.5, y+.5, w, h);
  ctx.strokeStyle = "#ff0";
  for (const [x,y,w,h] of (d.contours||[])) ctx.strokeRect(x+.5, y+.5, w, h);
  ctx.strokeStyle = "#f6f";
  for (const [x,y,w,h] of (d.faces||[])) ctx.strokeRect(x+.5, y+.5, w, h);
  ctx.strokeStyle = "#f44";
  for (const [x,y] of (d.keypoints||[])) {
    ctx.beginPath(); ctx.moveTo(x-3,y); ctx.lineTo(x+3,y);
    ctx.moveTo(x,y-3); ctx.lineTo(x,y+3); ctx.stroke();
  }
  ctx.strokeStyle = "#08f";
  for (const [x1,y1,x2,y2] of (d.matches||[])) {
    ctx.beginPath(); ctx.moveTo(x1,y1); ctx.lineTo(x2,y2); ctx.stroke();
  }
  shown++;
  if (shown % 10 == 0){
    const now = performance.now();
    document.getElementById("fps").textContent = (10000/(now-t0)).toFixed(1) + " fps";
    t0 = now;
  }
  busy = false;
  if (running) setTimeout(loop, 0);
}
loop();
</script>
"""


def make_handler(demo: Demo):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                body = (_PAGE.replace("__W__", str(demo.w))
                        .replace("__H__", str(demo.h)).encode())
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif u.path == "/frame":
                q = parse_qs(u.query)
                i = int(q.get("i", ["0"])[0])
                spec = q.get("pipeline", [""])[0]
                analyzers = [a for a in q.get("analyzers", [""])[0].split(",") if a]
                try:
                    self._json(demo.frame(i, spec, analyzers))
                except (Exception, SystemExit) as e:
                    # surface pipeline errors in the UI (build_pipeline raises
                    # SystemExit for unknown ops — keep the server alive)
                    self._json({"error": str(e)}, 400)
            else:
                self.send_error(404)

        def do_POST(self):
            # webcam frames: raw grayscale bytes (demo.h * demo.w) in the body
            u = urlparse(self.path)
            if u.path != "/frame":
                self.send_error(404)
                return
            q = parse_qs(u.query)
            try:
                nbytes = int(self.headers.get("Content-Length", "0"))
                raw = np.frombuffer(self.rfile.read(nbytes), dtype=np.uint8)
                if raw.size != demo.h * demo.w:
                    raise ValueError(
                        f"frame must be {demo.h}x{demo.w}={demo.h * demo.w}"
                        f" bytes, got {raw.size}")
                raw = raw.reshape(demo.h, demo.w)
                if q.get("capture", ["0"])[0] == "1":
                    self._json({"template_kps": demo.capture_template(raw)})
                    return
                spec = q.get("pipeline", [""])[0]
                analyzers = [a for a in q.get("analyzers", [""])[0].split(",") if a]
                self._json(demo.process(raw, spec, analyzers))
            except (Exception, SystemExit) as e:
                self._json({"error": str(e)}, 400)

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--size", default="240x320")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--src", help="directory of PGM frames (else synthetic)")
    args = ap.parse_args(argv)

    h, w = (int(v) for v in args.size.split("x"))
    if args.src:
        paths = sorted(
            os.path.join(args.src, f) for f in os.listdir(args.src) if f.endswith(".pgm")
        )[: args.frames]
        frames = gs.io.read_pgm_batch(paths, pad_to=(h, w))
    else:
        frames = synth_frames(args.frames, h, w)

    demo = Demo(frames)
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(demo))
    print(f"live demo on http://127.0.0.1:{args.port}/  ({len(frames)} frames, {h}x{w})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
