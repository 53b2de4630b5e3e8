"""Live browser viewer — the ImGui dashboard analog (L5 interactive).

The reference is an *interactive* renderer: a GLFW window with free-camera
controls (RFW/system/src/rfw/app.cpp:3-26, utils/window.h:165-240) plus
the ImGui panel that is its whole observability story — live Mrays/s,
per-stage times, settings listboxes, the probe inspector
(Examples/imgui_app/main.cpp:229-400). A headless service cannot open GLFW, so
the equivalent surface here is a self-contained HTTP viewer:

* the accumulating frame streams as PNG to a browser canvas,
* WASD/QE + arrow keys drive the camera (accumulation resets on move),
* a stats panel shows Mrays/s, per-stage times and ray counts,
* the runtime-settings protocol (intersector, denoise, …) is editable,
* a material editor panel (color/roughness per material → dirty
  MATERIALS bit, the main.cpp:300-330 material panel analog),
* clicking the canvas probes the pixel (instance / primitive / distance —
  the probeTool analog, main.cpp:331-357).

Server state is stdlib-only (http.server + threading); the render loop
stays on the caller's thread, so JAX never runs off-thread.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .utils import image, logger

_PAGE = """<!DOCTYPE html>
<html><head><title>rfw_tpu live</title><style>
body { background:#181818; color:#ddd; font-family:monospace; margin:14px }
#wrap { display:flex; gap:18px }
canvas { image-rendering:pixelated; border:1px solid #444 }
table { font-size:12px } td { padding:1px 8px 1px 0 }
select { background:#222; color:#ddd }
h3 { margin:6px 0 } #probe { color:#9c9 }
</style></head><body>
<h3>rfw_tpu — live render</h3>
<div id="wrap">
 <div><canvas id="cv" width="%W%" height="%H%"></canvas>
  <div>keys: WASD move &middot; QE up/down &middot; arrows look &middot;
   shift fast &middot; click = probe</div>
  <div id="probe"></div></div>
 <div><h3>stats</h3><table id="stats"></table>
  <h3>settings</h3><div id="settings"></div>
  <h3>materials</h3><div id="mats"></div></div>
</div>
<script>
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const img = new Image();
img.onload = () => ctx.drawImage(img, 0, 0);
function refresh() { img.src = '/frame.png?' + Date.now(); }
setInterval(refresh, 400); refresh();
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  const rows = Object.entries(s.stats).map(
    ([k, v]) => `<tr><td>${k}</td><td>${v}</td></tr>`).join('');
  document.getElementById('stats').innerHTML = rows;
  const sel = s.settings.map(o =>
    `<div>${o.name}: <select onchange="setSetting('${o.name}',this.value)">` +
    o.options.map(v => `<option ${v == o.value ? 'selected' : ''}>${v}` +
    `</option>`).join('') + '</select></div>').join('');
  if (document.activeElement.tagName !== 'SELECT')
    document.getElementById('settings').innerHTML = sel;
  if (s.probe) document.getElementById('probe').textContent =
    `probe: instance ${s.probe[0]} prim ${s.probe[1]} ` +
    `dist ${s.probe[2].toFixed(3)}`;
  if (s.materials && !document.activeElement.onchange)
    drawMats(s.materials);
}, 1000);
async function setSetting(name, value) {
  await fetch('/input', {method: 'POST',
    body: JSON.stringify({action: 'set', name, value})});
}
// material editor (imgui_app main.cpp material panel analog)
function hex(c) { return '#' + c.map(v => Math.round(
  Math.min(1, Math.max(0, v)) * 255).toString(16)
  .padStart(2, '0')).join(''); }
function drawMats(list) {
  document.getElementById('mats').innerHTML = list.map(m =>
    `<div>#${m.index} ${m.name || ''} ` +
    `<input type="color" value="${hex(m.color)}" ` +
    `onchange="setMat(${m.index},this.value,null)">` +
    ` rough <input type="number" min="0" max="1" step="0.05" ` +
    `style="width:4em" value="${m.roughness.toFixed(2)}" ` +
    `onchange="setMat(${m.index},null,this.value)"></div>`).join('');
}
async function setMat(index, color, rough) {
  const body = {action: 'material', index};
  if (color) body.color = [1, 3, 5].map(
    i => parseInt(color.substr(i, 2), 16) / 255);
  if (rough !== null) body.roughness = parseFloat(rough);
  await fetch('/input', {method: 'POST', body: JSON.stringify(body)});
}
const held = new Set();
addEventListener('keydown', e => { held.add(e.key); e.preventDefault(); });
addEventListener('keyup', e => held.delete(e.key));
setInterval(() => { if (held.size) fetch('/input', {method: 'POST',
  body: JSON.stringify({action: 'keys', keys: [...held]})}); }, 120);
cv.addEventListener('click', e => {
  const r = cv.getBoundingClientRect();
  fetch('/input', {method: 'POST', body: JSON.stringify({action: 'probe',
    x: Math.floor(e.clientX - r.left), y: Math.floor(e.clientY - r.top)})});
});
</script></body></html>"""


class LiveViewer:
    """Wraps a RenderSystem with an HTTP control surface + render loop."""

    def __init__(self, rs, width: int = 512, height: int = 512,
                 host: str = "127.0.0.1", port: int = 8000,
                 samples_per_frame: int = 1, move_speed: float = 1.0):
        self.rs = rs
        self.width = width
        self.height = height
        self.samples_per_frame = samples_per_frame
        self.move_speed = move_speed
        rs.camera.resize(width, height)
        self._png = b""
        self._stats: dict = {}
        self._probe = None
        self._lock = threading.Lock()
        # Serializes event application (handler threads) with the render
        # loop: a POST /input returns only after its edit has landed in
        # the system of record, so clients (and tests) never race the
        # loop's exit — the round-2 failure mode was queued events
        # dropped when ``run(max_frames=...)`` returned.
        self._rs_lock = threading.RLock()
        self._reset_pending = False
        self._stop = threading.Event()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype="text/html"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    page = (_PAGE.replace("%W%", str(viewer.width))
                            .replace("%H%", str(viewer.height)))
                    self._send(200, page.encode())
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, png or b"", "image/png")
                elif path == "/stats":
                    with viewer._lock:
                        body = json.dumps({
                            "stats": viewer._stats,
                            "probe": viewer._probe,
                            "settings": [
                                {"name": s.name, "value": s.value,
                                 "options": s.options}
                                for s in
                                viewer.rs.get_available_settings()],
                            "materials": [
                                {"index": i, "name": m.name,
                                 "color": [float(c) for c in
                                           np.asarray(m.color)[:3]],
                                 "roughness": float(m.roughness)}
                                for i, m in enumerate(
                                    viewer.rs.materials.materials)],
                        }).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found")

            def do_POST(self):
                if self.path != "/input":
                    self._send(404, b"")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    ev = {}
                viewer._handle_event(ev)
                self._send(200, b"ok", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    # -- input → camera (window.h:165-240 free-camera analog) ---------------

    def _handle_event(self, ev: dict) -> None:
        """Apply ONE input event synchronously (handler thread). Blocks
        on ``_rs_lock`` until the render loop is between frames, so the
        system of record is never mutated mid-frame and a returned POST
        means the edit is visible."""
        with self._rs_lock:
            moved = False
            act = ev.get("action")
            if act == "keys":
                keys = set(ev.get("keys", []))
                sp = self.move_speed * (3.0 if "Shift" in keys else 1.0)
                t = np.zeros(3, np.float32)
                if "w" in keys or "W" in keys:
                    t[2] += sp
                if "s" in keys or "S" in keys:
                    t[2] -= sp
                if "a" in keys or "A" in keys:
                    t[0] -= sp
                if "d" in keys or "D" in keys:
                    t[0] += sp
                if "q" in keys or "Q" in keys:
                    t[1] -= sp
                if "e" in keys or "E" in keys:
                    t[1] += sp
                r = np.zeros(3, np.float32)
                if "ArrowLeft" in keys:
                    r[0] -= 0.05
                if "ArrowRight" in keys:
                    r[0] += 0.05
                if "ArrowUp" in keys:
                    r[1] += 0.05
                if "ArrowDown" in keys:
                    r[1] -= 0.05
                if np.any(t):
                    self.rs.camera.translate_relative(t * 0.25)
                    moved = True
                if np.any(r):
                    self.rs.camera.translate_target(r)
                    moved = True
            elif act == "probe":
                self.rs.set_probe_index((int(ev.get("x", 0)),
                                         int(ev.get("y", 0))))
            elif act == "set":
                try:
                    self.rs.set_setting(str(ev.get("name")),
                                        str(ev.get("value")))
                except Exception as e:   # surface, don't kill the loop
                    logger.warning("setting rejected: %s", e)
            elif act == "material":
                # the ImGui material editor analog (main.cpp:300-330):
                # edit → dirty MATERIALS bit → next synchronize re-uploads
                import dataclasses
                try:
                    i = int(ev.get("index", -1))
                    m = self.rs.get_material(i)
                    kw = {}
                    if ev.get("color") is not None:
                        kw["color"] = np.asarray(ev["color"], np.float32)
                    if ev.get("roughness") is not None:
                        kw["roughness"] = float(ev["roughness"])
                    self.rs.set_material(i, dataclasses.replace(m, **kw))
                    moved = True   # reset accumulation
                except Exception as e:
                    logger.warning("material edit rejected: %s", e)
            self._reset_pending = self._reset_pending or moved

    # -- loop ----------------------------------------------------------------

    def run(self, duration: float | None = None,
            max_frames: int | None = None) -> None:
        """Blocking render loop; Ctrl-C or duration/max_frames to stop."""
        self._thread.start()
        logger.debug("live viewer on http://127.0.0.1:%d", self.port)
        t0 = time.time()
        frames = 0
        spp = 0
        from .render import RenderStatus
        try:
            while not self._stop.is_set():
                # hold _rs_lock for the whole frame: input events apply
                # strictly BETWEEN frames (never torn mid-render)
                with self._rs_lock:
                    if self._reset_pending:
                        self._reset_pending = False
                        spp = 0
                    frame = self.rs.render_tonemapped(
                        samples=self.samples_per_frame,
                        status=(RenderStatus.RESET if spp == 0
                                else RenderStatus.CONVERGE))
                spp += self.samples_per_frame
                buf = io.BytesIO()
                image.save_png(buf, frame)
                st = self.rs.get_render_stats()
                with self._lock:
                    self._png = buf.getvalue()
                    self._probe = list(self.rs.get_probe_results())
                    self._stats = {
                        "Mrays/s": round(st.mrays_per_s(), 3),
                        "render ms": round(st.render_time * 1e3, 1),
                        "primary ms": round(st.primary_time * 1e3, 1),
                        "secondary ms": round(st.secondary_time * 1e3, 1),
                        "deep ms": round(st.deep_time * 1e3, 1),
                        "rays primary": int(st.primary_count),
                        "rays shadow": int(st.shadow_count),
                        "spp": spp,
                    }
                frames += 1
                if max_frames is not None and frames >= max_frames:
                    break
                if duration is not None and time.time() - t0 > duration:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
