"""Live interactive rendering (port of volumetricrenderer_tpu/serve.py): a
loop where keys and the mouse move an orbit camera and the media clock, and
every frame is rendered anew, served over HTTP.

`volumetricrenderer_tpu_torch serve` runs a small stdlib HTTP server whose
index page captures key events and streams freshly rendered frames. Camera
state maps to a sweep plan on a discrete lattice (azimuth, elevation,
distance), so a revisited camera reuses its plan from a cache instead of
paying the plan build again.

Controls (index page):
  A/D   orbit azimuth     W/S   dolly in/out
  Q/E   orbit elevation   R/F   media time scrub
  space play/pause the media clock
  drag  orbit             wheel dolly

State lives server-side (one renderer, many viewers see the same scene);
rendering runs on one thread.

Every plan is built at one set of base dimensions, the largest any camera
of a probe lattice over the reachable states needs (`force_dims`), as the
JAX server builds them. Forcing the dimensions changes the frame (the base
grid resamples the rays), so the port keeps it to return the JAX package's
frames; the warp bands and row windows the JAX server also unified only
kept XLA executables shared and have no counterpart here.

A frame is converted to uint8 RGB over the page background on the device,
copied into its own pinned host buffer with a non-blocking copy, and a CUDA
event is recorded after the copy: `dispatch_frame` returns as soon as that
is enqueued, and `PendingFrame.fetch` waits on that event only. The frame
loop dispatches frame N+1 before it fetches frame N, so N's copy and the
host's work around it overlap N+1's kernels.
"""
from __future__ import annotations

import itertools
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .config import Preset
from .kernels.build import PLAN_CACHE_SIZE
from .models import scene as scene_mod
from .models.scene import build_volume
from .ops.camera import look_at_camera
from .ops.integrate import reference_media_scroll
from .ops.sweep import plan_base_dims, plan_sweep
from .render import prepare_baked_scene, render_image
from .utils.clock import sync
from .utils.metrics import get_logger

__all__ = ["InteractiveRenderer", "PendingFrame", "FrameLoop", "serve",
           "INDEX_HTML", "N_AZ"]

# Orbit state limits: elevation away from the poles keeps a sweep axis
# well-defined; distance keeps the box in front of the camera.
_EL_LIM = 1.25
_DIST_MIN, _DIST_MAX = 1.6, 6.0

# Azimuth moves on an exact periodic lattice: N_AZ steps per full orbit, so
# a/d presses cycle through N_AZ distinct cameras and a full orbit revisits
# cached plans instead of minting new keys forever.
N_AZ = 52
_AZ_STEP = 2 * math.pi / N_AZ  # ~0.1208 rad
_EL_STEP = 0.08
_DOLLY = 1.08
_TIME_STEP = 0.25
# Pointer-drag pixels per orbit lattice step: a drag quantizes onto the
# same azimuth/elevation lattice the keys use, so mouse-reached cameras hit
# the plan cache exactly like key-reached ones.
_DRAG_PX_PER_STEP = 24.0

# The viewer page's background (#111): frames are composited over it on the
# device and shipped as RGB, the pixels the browser shows for the RGBA PNG.
_PAGE_BG = 0x11 / 255.0

# The render loop idles (stops dispatching frames) when no viewer has asked
# for one within this window.
_IDLE_S = 5.0

# Plans kept on the lattice (the oldest is dropped first): as many as the
# kernels' per-plan caches hold, so a cached plan's frame reads nothing back
# from the device.
_PLAN_CACHE_CAP = PLAN_CACHE_SIZE


class PendingFrame:
    """A uint8 frame on its way to the host: its own host buffer and, on a
    CUDA device, the event recorded after the copy into it. fetch() waits on
    that event only and returns the (H, W, 3) array; no later frame writes
    into its buffer."""

    def __init__(self, host: torch.Tensor, event=None):
        self.host, self.event = host, event

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class InteractiveRenderer:
    """Camera/clock state and frame rendering for the live loop.

    The grid is built once on `device` ("cuda" unless the caller asks for
    another; without a GPU the default raises torch's own error). Plans are
    built per new lattice state at the forced base dimensions and cached.
    Attributes read by callers: force_dims, probe_seconds (the force_dims
    probe's wall time), frames_rendered, plan_cache_misses, device."""

    def __init__(self, preset: Preset, probe: int = 6, device="cuda"):
        self.log = get_logger()
        self.preset = preset
        self.cfg = preset.render
        self.light = preset.light
        dev = torch.device(device)
        medium = preset.medium
        if preset.scene:
            volumes = getattr(scene_mod, preset.scene)(preset.volume.size,
                                                       device=dev)
            grid, medium, _ = prepare_baked_scene(volumes, self.cfg, medium)
        else:
            grid = build_volume(preset.volume, device=dev)
        self.grid = sync(grid)
        self.device = grid.device
        self.medium = medium
        self.n_ch = grid.shape[-1] if grid.dim() == 4 else 1

        # --- interaction state (camera + clock) ---
        # World up is +Z: the orbit is in spherical coordinates around the
        # preset's look-at center.
        center = np.asarray(preset.camera.center, np.float64)
        eye = np.asarray(preset.camera.eye, np.float64) - center
        self.dist = float(np.linalg.norm(eye))
        self.dist = min(max(self.dist, _DIST_MIN), _DIST_MAX)
        self._az0 = math.atan2(eye[1], eye[0])  # lattice origin
        self._az_idx = 0                        # integer steps, mod N_AZ
        self.elev = math.atan2(eye[2], math.hypot(eye[0], eye[1]))
        self.elev = min(max(self.elev, -_EL_LIM), _EL_LIM)
        self.media_t = 0.0
        self.playing = True
        self._last_tick = time.perf_counter()
        self.lock = threading.Lock()
        self.frames_rendered = 0

        # --- one set of base dims over the reachable states ---
        t0 = time.perf_counter()
        azs = [2 * math.pi * i / probe for i in range(probe)]
        els = [-_EL_LIM, -0.6, 0.0, 0.6, _EL_LIM]
        dists = [_DIST_MIN, self.dist, _DIST_MAX]
        fh = fw = 128
        for az, el, d in itertools.product(azs, els, dists):
            cam = self._camera_at(az, el, d)
            try:
                hb, wb, _, _ = plan_base_dims(
                    cam, grid.shape[:3], self.cfg,
                    supersample=self.cfg.sweep_supersample,
                    device=self.device)
            except ValueError:
                continue  # a pole-adjacent probe without a sweep axis
            fh, fw = max(fh, hb), max(fw, wb)
        self.force_dims = (fh, fw)
        self.probe_seconds = time.perf_counter() - t0
        self.log.info("serve: base dims %s from %d probe cameras in %.2f s",
                      self.force_dims, len(azs) * len(els) * len(dists),
                      self.probe_seconds)

        # Plan cache on the interaction lattice: key steps mutate the orbit
        # state by fixed increments, so (azim, elev, dist) live on a
        # discrete lattice and revisited states reuse their plan.
        self._plan_cache = {}
        self.plan_cache_misses = 0
        self._drag_px_x = 0.0
        self._drag_px_y = 0.0

    @property
    def azim(self):
        """Azimuth on the exact periodic lattice (wrapped to one orbit)."""
        return self._az0 + (self._az_idx % N_AZ) * _AZ_STEP

    def _plan_cached(self, az, el, d):
        key = (round(az, 6), round(el, 6), round(d, 6))
        plan = self._plan_cache.get(key)
        if plan is None:
            self.plan_cache_misses += 1
            plan = plan_sweep(self._camera_at(az, el, d), self.grid.shape[:3],
                              self.cfg, supersample=self.cfg.sweep_supersample,
                              force_base_dims=self.force_dims,
                              device=self.device)
            if len(self._plan_cache) >= _PLAN_CACHE_CAP:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[key] = plan
        return plan

    def _camera_at(self, az, el, d):
        cc = self.preset.camera
        center = np.asarray(cc.center, np.float32)
        eye = center + d * np.asarray(
            [math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
             math.sin(el)], np.float32)
        return look_at_camera(eye, center, np.asarray(cc.up, np.float32),
                              cc.fov_y_degrees, cc.width, cc.height)

    # -- input: keys ----------------------------------------------------
    def key(self, k: str):
        with self.lock:
            if k == "a":
                self._az_idx = (self._az_idx - 1) % N_AZ
            elif k == "d":
                self._az_idx = (self._az_idx + 1) % N_AZ
            elif k == "q":
                self.elev = max(self.elev - _EL_STEP, -_EL_LIM)
            elif k == "e":
                self.elev = min(self.elev + _EL_STEP, _EL_LIM)
            elif k == "w":
                self.dist = max(self.dist / _DOLLY, _DIST_MIN)
            elif k == "s":
                self.dist = min(self.dist * _DOLLY, _DIST_MAX)
            elif k == "r":
                self.media_t += _TIME_STEP
            elif k == "f":
                self.media_t = max(self.media_t - _TIME_STEP, 0.0)
            elif k == " ":
                self.playing = not self.playing
            return self.state()

    # -- input: mouse (drag orbits, wheel dollies) ----------------------
    def drag(self, dx: float, dy: float):
        """Pointer-drag orbit: horizontal pixels -> azimuth lattice steps,
        vertical -> elevation steps. Deltas accumulate server-side and
        convert to whole lattice steps (residuals kept), so every reachable
        camera stays on the key lattice and plans cache as for key input."""
        with self.lock:
            self._drag_px_x += float(dx)
            self._drag_px_y += float(dy)
            sx = int(self._drag_px_x / _DRAG_PX_PER_STEP)
            sy = int(self._drag_px_y / _DRAG_PX_PER_STEP)
            self._drag_px_x -= sx * _DRAG_PX_PER_STEP
            self._drag_px_y -= sy * _DRAG_PX_PER_STEP
            if sx:
                self._az_idx = (self._az_idx + sx) % N_AZ
            if sy:
                el = self.elev - sy * _EL_STEP  # drag up = look from above
                self.elev = min(max(el, -_EL_LIM), _EL_LIM)
            return self.state()

    def wheel(self, dy: float):
        """Scroll dolly: one notch = one W/S key step on the distance
        lattice."""
        with self.lock:
            if dy < 0:
                self.dist = max(self.dist / _DOLLY, _DIST_MIN)
            elif dy > 0:
                self.dist = min(self.dist * _DOLLY, _DIST_MAX)
            return self.state()

    def state(self):
        return {"azim": round(self.azim, 3), "elev": round(self.elev, 3),
                "dist": round(self.dist, 3), "t": round(self.media_t, 3),
                "playing": self.playing,
                "frames": self.frames_rendered}

    # -- the frame loop body --------------------------------------------
    def dispatch_frame(self) -> PendingFrame:
        """Enqueue one frame for the current interaction state and return
        it pending: uint8 RGB over the page background, computed on the
        device and copied into its own pinned host buffer behind a CUDA
        event (module docstring). On the CPU the pending frame is the
        finished array. Runs under torch.no_grad() here, since grad mode is
        per thread and the frame loop calls from its own."""
        with self.lock:
            now = time.perf_counter()
            if self.playing:
                self.media_t += now - self._last_tick
            self._last_tick = now
            az, el, d, t = self.azim, self.elev, self.dist, self.media_t
        frame = self.present(self._plan_cached(az, el, d), t)
        self.frames_rendered += 1
        if frame.device.type != "cuda":
            return PendingFrame(frame)
        host = torch.empty(frame.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(frame, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(frame.device))
        return PendingFrame(host, event)

    def present(self, plan, t: float) -> torch.Tensor:
        """The device part of a frame: render at `plan` and media time t,
        then uint8 RGB over the page background, left on the device."""
        scroll = None
        if self.medium.combine == "reference":
            scroll = reference_media_scroll(t, n_channels=self.n_ch,
                                            device=self.device)
        with torch.no_grad():
            # The light volume, where the preset shades, is rebuilt from
            # the grid by render_image in every frame.
            img = render_image(self.grid, None, self.cfg, self.medium,
                               self.light, scroll=scroll, plan=plan,
                               backend="sweep")
            a = img[..., 3:4]
            rgb = img[..., :3] * a + _PAGE_BG * (1.0 - a)
            return torch.clamp(rgb * 255.0 + 0.5, 0.0, 255.0).to(
                torch.uint8)

    def render_frame(self) -> np.ndarray:
        """Dispatch + fetch one frame synchronously (tests, one-offs)."""
        return self.dispatch_frame().fetch()


INDEX_HTML = """<!doctype html>
<html><head><title>volumetricrenderer_tpu_torch — live</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;
     display:flex;flex-direction:column;align-items:center}
img{image-rendering:auto;margin-top:8px;max-width:96vw}
#hud{padding:6px}
</style></head><body>
<div id="hud">A/D orbit &nbsp; Q/E elevate &nbsp; W/S dolly &nbsp;
R/F time &nbsp; space pause &nbsp; drag orbit &nbsp; wheel dolly —
<span id="st"></span></div>
<img id="v" src="/frame.png">
<script>
const img = document.getElementById('v'), st = document.getElementById('st');
let frames = 0, t0 = performance.now();
img.onload = () => {            // continuous streaming: re-request on load
  frames++;
  if (frames % 10 === 0) {
    const fps = 10000 / (performance.now() - t0); t0 = performance.now();
    st.textContent = fps.toFixed(1) + ' fps';
  }
  img.src = '/frame.png?' + Date.now();
};
img.onerror = () => setTimeout(() => img.src = '/frame.png?' + Date.now(), 500);
window.addEventListener('keydown', e => {
  const k = e.key === ' ' ? 'space' : e.key.toLowerCase();
  if ('adqwesrf'.includes(k) || k === 'space')
    fetch('/key?k=' + k).catch(()=>{});
});
// mouse: drag orbits, wheel dollies (the reference's Mouse class,
// Core/Mouse.h — relative-mode deltas + scroll). Deltas batch per
// animation frame; the server quantizes them onto the key lattice.
let drag = null, accX = 0, accY = 0, sendQueued = false;
function flushDrag() {
  sendQueued = false;
  if (accX || accY) {
    fetch('/drag?dx=' + accX + '&dy=' + accY).catch(()=>{});
    accX = 0; accY = 0;
  }
}
img.addEventListener('pointerdown', e => {
  drag = {x: e.clientX, y: e.clientY};
  img.setPointerCapture(e.pointerId); e.preventDefault();
});
img.addEventListener('pointermove', e => {
  if (!drag) return;
  accX += e.clientX - drag.x; accY += e.clientY - drag.y;
  drag = {x: e.clientX, y: e.clientY};
  if (!sendQueued) { sendQueued = true; requestAnimationFrame(flushDrag); }
});
img.addEventListener('pointerup', e => { drag = null; flushDrag(); });
img.addEventListener('wheel', e => {
  e.preventDefault();
  fetch('/wheel?dy=' + Math.sign(e.deltaY)).catch(()=>{});
}, {passive: false});
img.style.touchAction = 'none';
</script></body></html>"""


class FrameLoop:
    """Free-running render loop with a latest-frame buffer.

    One thread renders the current interaction state back to back;
    `next_frame` blocks until a frame newer than the one a viewer last got
    exists, so a viewer's PNG encode, transfer and decode overlap the next
    frame's render. The loop idles after _IDLE_S without a frame request.
    A render error is sticky: every waiter gets it until a frame succeeds.
    """

    def __init__(self, renderer):
        self.renderer = renderer
        self.cond = threading.Condition()
        self.seq = 0
        self.img: Optional[np.ndarray] = None
        self._last_want = time.perf_counter()
        self._stop = False
        self._err: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        # Two frames in flight: dispatch frame N+1, then fetch frame N.
        pending = None
        while True:
            with self.cond:
                if self._stop:
                    return
                idle = time.perf_counter() - self._last_want > _IDLE_S
            if idle and pending is None:
                time.sleep(0.05)
                continue
            try:
                cur = None if idle else self.renderer.dispatch_frame()
                if pending is not None:
                    img = pending.fetch()
                    with self.cond:
                        self.seq += 1
                        self.img = img
                        self._err = None  # a fresh frame clears the error
                        self.cond.notify_all()
                pending = cur
            except Exception as e:  # surface in the handler, keep looping
                pending = None
                with self.cond:
                    if self._err is None:
                        get_logger().error("serve: frame failed",
                                           exc_info=True)
                    self._err = e
                    self.cond.notify_all()
                time.sleep(0.5)

    def next_frame(self, after_seq: int, timeout: float = 600.0):
        """Block until a frame with seq > after_seq; return (seq, img)."""
        with self.cond:
            self._last_want = time.perf_counter()
            self.cond.notify_all()
            ok = self.cond.wait_for(
                lambda: self.seq > after_seq or self._err is not None
                or self._stop, timeout)
            if self._err is not None:
                # Sticky until a new frame succeeds: every concurrent
                # waiter fails fast instead of only the first one.
                raise self._err
            if not ok or self._stop:
                raise TimeoutError("no frame rendered in time")
            return self.seq, self.img

    def stop(self):
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        self.thread.join(timeout=30)


def _make_handler(loop: FrameLoop):
    from urllib.parse import parse_qs, urlparse

    from .utils.image import encode_png

    renderer = loop.renderer

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: per-request connections can stall on
        # SYN retransmits; every response carries Content-Length.
        protocol_version = "HTTP/1.1"
        # No Nagle: small keep-alive responses would otherwise wait out the
        # delayed-ACK timer.
        disable_nagle_algorithm = True

        def log_message(self, *a):  # quiet
            pass

        def setup(self):
            super().setup()
            # Per-connection frame cursor: each keep-alive viewer gets every
            # frame at most once, so its fps is render throughput.
            self._served_seq = 0

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(200, "application/json", json.dumps(obj).encode())

        def do_GET(self):
            q = parse_qs(urlparse(self.path).query)
            try:
                if self.path.startswith("/frame.png"):
                    self._served_seq, img = loop.next_frame(
                        self._served_seq)
                    # low compression: encode latency is frame latency
                    self._send(200, "image/png", encode_png(img, level=1))
                elif self.path.startswith("/key"):
                    k = q.get("k", [""])[0]
                    self._json(renderer.key(" " if k == "space" else k))
                elif self.path.startswith("/drag"):
                    self._json(renderer.drag(float(q.get("dx", ["0"])[0]),
                                             float(q.get("dy", ["0"])[0])))
                elif self.path.startswith("/wheel"):
                    self._json(renderer.wheel(float(q.get("dy", ["0"])[0])))
                elif self.path.startswith("/state"):
                    self._json(renderer.state())
                else:
                    self._send(200, "text/html", INDEX_HTML.encode())
            except BrokenPipeError:
                pass

    return Handler


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def serve(preset: Preset, port: int = 8788, frames: Optional[int] = None,
          host: str = "127.0.0.1", device="cuda"):
    """Run the live loop on `device` ("cuda" unless the caller asks for
    another). frames=N: self-drive mode, which sends synthetic key and
    mouse events and fetches N frames through the real HTTP stack, then
    returns a result dict and exits (the headless evidence mode).

    host: bind address. Default loopback: the server exposes camera control
    and rendered frames with no auth, so exposing it to a network is a
    deliberate choice (--host 0.0.0.0).

    The result dict has the JAX server's keys but `n_executables` (it counts
    jit executables, which this port does not have), plus
    `plan_cache_misses` (plans built, one per lattice state first visited)
    and `device` (the torch device and the card's name)."""
    renderer = InteractiveRenderer(preset, device=device)
    loop = FrameLoop(renderer)
    httpd = ThreadingHTTPServer((host, port), _make_handler(loop))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    renderer.log.info("serving live renderer on http://localhost:%d", port)
    if frames is None:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            loop.stop()
            httpd.shutdown()
            httpd.server_close()
        return None

    # --- self-drive evidence mode ---
    # One persistent HTTP/1.1 connection: fresh per-request sockets can
    # stall on SYN retransmits even on loopback.
    import http.client

    keys = "adqwesrf"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def get(path):
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"serve: GET {path} returned {resp.status}")
        return body

    try:
        sizes = []
        # Warm-up: visit every key state once, so first-visit plan builds
        # land here (reported apart), then measure the steady loop: what a
        # user interacting with an already running viewer gets.
        t_first = time.perf_counter()
        get("/frame.png")
        for k in keys:
            get(f"/key?k={k}")
            get("/frame.png")
        # the mouse path (drag orbit + wheel dolly) through the same stack
        st_before = json.loads(get("/state"))
        drag_state = json.loads(get("/drag?dx=48&dy=-24"))
        wheel_state = json.loads(get("/wheel?dy=1"))
        mouse_ok = (drag_state["azim"] != st_before["azim"]
                    and drag_state["elev"] != st_before["elev"]
                    and wheel_state["dist"] != drag_state["dist"])
        get("/frame.png")
        warmup_s = time.perf_counter() - t_first
        t0 = time.perf_counter()
        for i in range(frames):
            get(f"/key?k={keys[i % len(keys)]}")
            sizes.append(len(get("/frame.png")))
        dt = time.perf_counter() - t0
        state = json.loads(get("/state"))
    finally:
        conn.close()
        loop.stop()
        httpd.shutdown()
        httpd.server_close()
    result = {
        "what": "live interactive loop: HTTP key events mutate the orbit "
                "camera and media clock; every frame re-renders on the "
                "device through cached plans",
        "preset": renderer.preset.name,
        "width": renderer.preset.camera.width,
        "height": renderer.preset.camera.height,
        "frames": frames,
        "fps": round(frames / dt, 2),
        "ms_per_frame": round(dt / frames * 1e3, 1),
        "warmup_s": round(warmup_s, 1),
        "plan_cache_misses": renderer.plan_cache_misses,
        "device": _device_name(renderer.device),
        "mouse_drag_wheel_ok": mouse_ok,
        "final_state": state,
        "png_bytes_mean": int(np.mean(sizes)),
    }
    renderer.log.info("self-drive: %.1f fps over %d frames, %d plan(s) "
                      "built", result["fps"], frames,
                      result["plan_cache_misses"])
    return result
