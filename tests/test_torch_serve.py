"""The live loop of the PyTorch port (volumetricrenderer_tpu_torch/serve.py)
against the JAX package's (volumetricrenderer_tpu/serve.py) on the CPU, and
tests/test_serve.py's tests run on the port with device="cpu".

Sizes: tests/test_serve.py's small preset (config2 at 16^3, 64x48, probe=4)
and a small config 4 (16^3, 48x32, LightConfig(shadow_steps=32)). Served
frames are uint8 RGB; the port's are held to the JAX frames within 1 level
(the two float32 pipelines may round a value on either side of a level's
edge).
"""
import dataclasses
import json
import socket
import threading

import jax
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu.serve as jserve
import volumetricrenderer_tpu_torch.serve as tserve
from volumetricrenderer_tpu.config import PRESETS as JPRESETS
from volumetricrenderer_tpu_torch.config import PRESETS as TPRESETS
from volumetricrenderer_tpu_torch.serve import (N_AZ, FrameLoop,
                                                InteractiveRenderer,
                                                PendingFrame, serve)
from volumetricrenderer_tpu_torch.tools import serve_local

SIZES = {"config2": (16, 64, 48), "config4": (16, 48, 32),
         "reference": (8, 32, 24)}


def _small(presets, name, size=None, width=None, height=None):
    s, w, h = SIZES[name]
    p = presets[name]
    return dataclasses.replace(
        p, volume=dataclasses.replace(p.volume, size=size or s),
        camera=dataclasses.replace(p.camera, width=width or w,
                                   height=height or h))


def _small_preset():
    return _small(TPRESETS, "config2")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module", params=["config2", "config4"])
def pair(request):
    """(JAX renderer, port renderer) of one small preset, probe=4."""
    name = request.param
    pair = (jserve.InteractiveRenderer(_small(JPRESETS, name), probe=4),
            InteractiveRenderer(_small(TPRESETS, name), probe=4,
                                device="cpu"))
    for r in pair:
        r.key(" ")  # pause the media clock: state() is then the same
    return pair


def test_force_dims_match_jax(pair):
    jr, tr = pair
    assert tr.force_dims == jr.force_dims


def test_force_dims_match_jax_above_the_floor():
    """At 256x160 the probe lattice needs more than the 128 floor."""
    jr = jserve.InteractiveRenderer(
        _small(JPRESETS, "config2", width=256, height=160), probe=2)
    tr = InteractiveRenderer(
        _small(TPRESETS, "config2", width=256, height=160), probe=2,
        device="cpu")
    assert tr.force_dims == jr.force_dims
    assert min(tr.force_dims) > 128


def test_render_frame_matches_jax_at_three_states(pair):
    jr, tr = pair
    for keys in ("", "dq", "wwe"):
        for r in (jr, tr):
            for k in keys:
                r.key(k)
        assert tr.state() == jr.state()
        want = jr.render_frame().astype(np.int32)
        got = tr.render_frame().astype(np.int32)
        assert got.shape == want.shape == (jr.preset.camera.height,
                                           jr.preset.camera.width, 3)
        assert got.dtype == np.int32 and np.abs(got - want).max() <= 1
        assert want.max() > 0x11  # the cloud is in view over the page


def test_serve_local_walk_matches_jax(pair):
    """tools/serve_local.py's walk (its key string until 4 distinct
    states) visits the same (azimuth, elevation, distance) states on the
    JAX renderer as on the port's, from the same state."""
    jr, tr = pair
    assert tr.state() == jr.state()
    states = serve_local.walk(tr, 4)
    assert serve_local.walk(jr, 4) == states
    assert len({tuple(round(x, 6) for x in s) for s in states}) == 4
    assert tr.state() == jr.state()


def test_key_drag_wheel_sequence_matches_jax():
    # (the state machine does not depend on the probe lattice)
    jr = jserve.InteractiveRenderer(_small(JPRESETS, "config2"), probe=1)
    tr = InteractiveRenderer(_small_preset(), probe=1, device="cpu")
    steps = [("key", "a"), ("key", "w"), ("drag", (30, -10)),
             ("key", "e"), ("wheel", 1), ("drag", (-70, 60)), ("key", "r"),
             ("key", " "), ("key", "s"), ("wheel", -1), ("key", "q"),
             ("key", "f"), ("drag", (500, 0)), ("key", "d")]
    for kind, arg in steps:
        args = arg if isinstance(arg, tuple) else (arg,)
        want = getattr(jr, kind)(*args)
        assert getattr(tr, kind)(*args) == want, (kind, arg)
    for _ in range(40):  # past the elevation limit and around the orbit
        assert tr.key("e") == jr.key("e")
        assert tr.key("d") == jr.key("d")


def test_reference_preset_raises_the_same_value_error():
    jr = jserve.InteractiveRenderer(_small(JPRESETS, "reference"), probe=1)
    tr = InteractiveRenderer(_small(TPRESETS, "reference"), probe=1,
                             device="cpu")
    with pytest.raises(ValueError) as want:
        jr.dispatch_frame()
    with pytest.raises(ValueError) as got:
        tr.dispatch_frame()
    assert str(got.value) == str(want.value)
    assert tr.frames_rendered == 0


# --- tests/test_serve.py on the port ------------------------------------


def _lattice_key(r):
    return round(r.azim, 6), round(r.elev, 6), round(r.dist, 6)


def test_interactive_renderer_state_and_frames():
    r = InteractiveRenderer(_small_preset(), probe=4, device="cpu")
    # uint8 RGB composited over the page background on the device
    f0 = r.render_frame().astype(np.int32)
    assert f0.shape == (48, 64, 3)
    seen = {_lattice_key(r)}
    st0 = dict(r.state())
    r.key("a")
    r.key("w")
    r.key("r")
    st1 = r.state()
    seen.add(_lattice_key(r))
    assert st1["azim"] != st0["azim"]
    assert st1["dist"] < st0["dist"]
    assert st1["t"] > st0["t"]
    f1 = r.render_frame().astype(np.int32)
    # the camera moved: the image must actually change
    assert np.abs(f1 - f0).max() > 0
    # plans are cached on the lattice: one plan per distinct state
    # visited, however often it is rendered
    for k in "adqeadqe":
        r.key(k)
        r.render_frame()
        seen.add(_lattice_key(r))
    assert r.plan_cache_misses == len(seen)
    assert r.frames_rendered == 10 > 2 * len(seen)


def test_serve_selftest_http_roundtrip():
    res = serve(_small_preset(), port=_free_port(), frames=4, device="cpu")
    assert res["frames"] == 4
    assert res["fps"] > 0
    assert res["png_bytes_mean"] > 100
    assert res["final_state"]["frames"] >= 5  # warmup + 4
    assert "n_executables" not in res
    assert res["device"] == "cpu"
    assert 1 <= res["plan_cache_misses"] <= res["final_state"]["frames"]


def test_serve_state_endpoint_is_json():
    port = _free_port()
    res = serve(_small_preset(), port=port, frames=1, device="cpu")
    assert set(res["final_state"]) >= {"azim", "elev", "dist", "t",
                                       "playing"}
    json.dumps(res)  # artifact-serializable


def test_azimuth_lattice_wraps_exactly():
    # azim lives on an exact periodic lattice, so a full orbit revisits
    # cached plans instead of minting new cache keys
    r = InteractiveRenderer(_small_preset(), probe=4, device="cpu")
    az0 = r.azim
    seen = set()
    for _ in range(N_AZ):
        seen.add(round(r.azim, 9))
        r.key("d")
    assert r.azim == pytest.approx(az0, abs=1e-12)  # exact wrap
    assert len(seen) == N_AZ
    # going backwards hits the same lattice points
    for _ in range(3):
        r.key("a")
    assert round(r.azim, 9) in seen


def test_frameloop_error_is_sticky_until_next_frame():
    # a render error fails every concurrent waiter fast, not just the first
    class Boom:
        frames_rendered = 0

        def dispatch_frame(self):
            raise RuntimeError("render broke")

    loop = FrameLoop(Boom())
    try:
        for _ in range(2):  # every waiter sees the sticky error
            with pytest.raises(RuntimeError, match="render broke"):
                loop.next_frame(0, timeout=10)
    finally:
        loop.stop()


def test_mouse_drag_and_wheel_drive_the_lattice():
    """Pointer drag orbits and wheel dollies, quantized onto the same key
    lattice, so plans cache."""
    r = InteractiveRenderer(_small_preset(), probe=4, device="cpu")
    st0 = dict(r.state())
    # sub-step drags accumulate server-side (no state change yet)
    st = r.drag(10, 0)
    assert st["azim"] == st0["azim"]
    st = r.drag(38, -50)  # 48px right = 2 az steps; 50px up = 2 el steps
    assert st["azim"] != st0["azim"]
    assert st["elev"] > st0["elev"]
    # the reached azimuth is on the key lattice (a 'd' then 'a' returns)
    az = r.azim
    r.key("d")
    r.key("a")
    assert r.azim == pytest.approx(az, abs=1e-12)
    st1 = r.wheel(1)
    assert st1["dist"] > st["dist"]
    st2 = r.wheel(-1)
    assert st2["dist"] == pytest.approx(st["dist"], abs=1e-9)


def test_serve_selftest_reports_mouse_ok():
    res = serve(_small_preset(), port=_free_port(), frames=2, device="cpu")
    assert res["mouse_drag_wheel_ok"] is True


# --- the served frame is never overwritten ------------------------------


class _Counting:
    """A fake renderer: frame k is filled with k % 256. shared=True puts
    every pending frame in one buffer, as a renderer that reused one host
    buffer for its copies would."""

    def __init__(self, shared):
        self.shared, self.frames_rendered = shared, 0
        self.buf = torch.zeros((4, 5, 3), dtype=torch.uint8)

    def dispatch_frame(self):
        self.frames_rendered += 1
        host = self.buf if self.shared else torch.empty_like(self.buf)
        host.fill_(self.frames_rendered % 256)
        return PendingFrame(host)


def _served_frames_intact(renderer, n=6):
    """Serve n frames through a FrameLoop; True when each served frame,
    read after the loop has gone on dispatching, still holds what its
    sequence number says it held (frame seq = the seq-th dispatch)."""
    loop = FrameLoop(renderer)
    served = []
    try:
        seq = 0
        for _ in range(n):
            seq, img = loop.next_frame(seq, timeout=30)
            served.append((seq, img))
    finally:
        loop.stop()
    assert not loop.thread.is_alive()
    return all(np.all(img == seq % 256) for seq, img in served)


def test_frameloop_served_frames_are_never_overwritten():
    assert _served_frames_intact(_Counting(shared=False))
    # the check has teeth: a renderer whose pending frames share one buffer
    # fails it (dispatch N+1 writes frame N's buffer before N is fetched)
    assert not _served_frames_intact(_Counting(shared=True))


def test_pending_frames_of_the_renderer_own_their_buffers():
    r = InteractiveRenderer(_small_preset(), probe=4, device="cpu")
    a = r.dispatch_frame()
    r.key("d")
    b = r.dispatch_frame()
    fa, fb = a.fetch(), b.fetch()
    assert not np.shares_memory(fa, fb)
    assert np.abs(fa.astype(np.int32) - fb.astype(np.int32)).max() > 0
    assert _served_frames_intact_real(r)


def _served_frames_intact_real(renderer, n=4):
    """The real renderer through a FrameLoop, the state moving between
    frames: each served frame equals a copy taken when it was served."""
    loop = FrameLoop(renderer)
    served = []
    stop = threading.Event()

    def turn():
        while not stop.is_set():
            renderer.key("d")
            stop.wait(0.01)
    mover = threading.Thread(target=turn, daemon=True)
    mover.start()
    try:
        seq = 0
        for _ in range(n):
            seq, img = loop.next_frame(seq, timeout=60)
            served.append((img, img.copy()))
    finally:
        stop.set()
        mover.join(timeout=10)
        loop.stop()
    assert not mover.is_alive() and not loop.thread.is_alive()
    return all(np.array_equal(img, copy) for img, copy in served)


# --- no fallback that hides the device ----------------------------------


@pytest.mark.parametrize("what", ["renderer", "serve"])
def test_serve_defaults_to_the_gpu(what):
    """InteractiveRenderer and serve build on "cuda" unless asked
    otherwise: with no GPU they fail with torch's own error instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        if what == "renderer":
            InteractiveRenderer(_small_preset(), probe=4)
        else:
            serve(_small_preset(), port=_free_port(), frames=1)


def test_constants_and_page_match_jax():
    assert jax.default_backend() == "cpu"
    assert (tserve.N_AZ, tserve._EL_LIM, tserve._DIST_MIN, tserve._DIST_MAX,
            tserve._EL_STEP, tserve._DOLLY, tserve._TIME_STEP,
            tserve._DRAG_PX_PER_STEP, tserve._PAGE_BG, tserve._IDLE_S) == \
        (jserve.N_AZ, jserve._EL_LIM, jserve._DIST_MIN, jserve._DIST_MAX,
         jserve._EL_STEP, jserve._DOLLY, jserve._TIME_STEP,
         jserve._DRAG_PX_PER_STEP, jserve._PAGE_BG, jserve._IDLE_S)
    # the same page but its title
    assert tserve.INDEX_HTML.split("</title>")[1] == \
        jserve.INDEX_HTML.split("</title>")[1]
