"""Interactive HTTP viewer: renders the current model on demand.

Counterpart of ``frosting_tpu/utils/viewer.py`` with the same routes:

  GET /                         orbit viewer page (vanilla JS, drag to orbit)
  GET /render?az=..&el=..&r=..  PNG render from the orbit camera
  GET /state                    JSON scene stats

`get_model()` returns the current activated Gaussian tensors (means,
scales, quats, opacities, sh), kept on the device; renders run there under
``torch.inference_mode()``, one at a time. Start with `serve(...)`
(blocking) or `start(...)` (thread).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import render
from frosting_tpu_torch.utils.png import encode_png

_PAGE = """<!doctype html><html><body style="margin:0;background:#111">
<img id=v width=100% style="image-rendering:pixelated">
<script>
let az=0, el=0.3, r=3.5, drag=false, lx=0, ly=0, busy=false;
const img=document.getElementById('v');
function refresh(){ if(busy) return; busy=true;
  const i=new Image();
  i.onload=()=>{ img.src=i.src; busy=false; };
  i.src=`/render?az=${az.toFixed(3)}&el=${el.toFixed(3)}&r=${r.toFixed(2)}&t=${Date.now()}`; }
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{ if(!drag) return;
  az+=(e.clientX-lx)*0.01; el=Math.max(-1.4,Math.min(1.4,el+(e.clientY-ly)*0.01));
  lx=e.clientX; ly=e.clientY; refresh(); };
window.onwheel=e=>{ r=Math.max(0.5,r*(1+e.deltaY*0.001)); refresh(); };
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


def _orbit_camera(az, el, radius, target=(0.0, 0.0, 0.0), fov_deg=50.0,
                  device="cuda"):
    eye = [
        target[0] + radius * math.cos(el) * math.cos(az),
        target[1] + radius * math.cos(el) * math.sin(az),
        target[2] + radius * math.sin(el),
    ]
    return look_at_camera(
        eye=eye, target=list(target), up=(0, 0, 1),
        fov_x=math.radians(fov_deg), device=device,
    )


def render_png(model, cam, rcfg) -> bytes:
    """Render `model` from `cam`, clip to [0, 1], quantise to uint8 on the
    device and encode as PNG."""
    with torch.inference_mode():
        img = render(*model, cam, rcfg).image
        img8 = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
        rgb = img8.permute(1, 2, 0).contiguous().cpu().numpy()
    return encode_png(rgb)


def make_handler(get_model, rcfg, target=(0.0, 0.0, 0.0), device="cuda"):
    device = torch.device(device)
    render_lock = threading.Lock()  # one render at a time on the device

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silence request spam
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/render":
                q = parse_qs(url.query)
                try:
                    az = float(q.get("az", ["0"])[0])
                    el = float(q.get("el", ["0.3"])[0])
                    r = float(q.get("r", ["3.5"])[0])
                except ValueError:
                    self._send(400, "text/plain", b"az, el and r must be numbers")
                    return
                cam = _orbit_camera(az, el, r, target, device=device)
                with render_lock:
                    body = render_png(get_model(), cam, rcfg)
                self._send(200, "image/png", body)
            elif url.path == "/state":
                model = get_model()
                self._send(
                    200,
                    "application/json",
                    json.dumps({"n_gaussians": int(model[0].shape[0])}).encode(),
                )
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def _server(get_model, rcfg, port, target, host, device):
    torch.empty(0, device=device)  # raises at once if the device is missing
    return ThreadingHTTPServer(
        (host, port), make_handler(get_model, rcfg, target, device)
    )


def start(get_model, rcfg, port=8008, target=(0.0, 0.0, 0.0),
          host="0.0.0.0", device="cuda"):
    """Run the viewer in a daemon thread; returns the server object
    (port=0 binds a free port: read it from server.server_address).
    Stop it with server.shutdown() and server.server_close()."""
    server = _server(get_model, rcfg, port, target, host, device)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def serve(get_model, rcfg, port=8008, target=(0.0, 0.0, 0.0),
          host="0.0.0.0", device="cuda"):
    """Run the viewer in this thread until interrupted."""
    with _server(get_model, rcfg, port, target, host, device) as server:
        server.serve_forever()
