"""`cli animate` and the frame and video writers of the PyTorch port
(volumetricrenderer_tpu_torch/cli.py, utils/image.py, utils/video.py)
against the JAX package's on the CPU.

Animated frames are uint8 PNGs; the port's are held to the JAX frames
within 1 level (the two float32 pipelines may round a value on either side
of a level's edge). The writers are numpy and stdlib code ported by value:
their bytes must equal the JAX functions' on the same frames.
"""
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import cli as jcli
from volumetricrenderer_tpu.config import RenderConfig as JRenderConfig
from volumetricrenderer_tpu.ops.camera import orbit_camera as jorbit
from volumetricrenderer_tpu.utils import image as jimage
from volumetricrenderer_tpu.utils import video as jvideo
from volumetricrenderer_tpu_torch import cli as tcli
from volumetricrenderer_tpu_torch.config import RenderConfig
from volumetricrenderer_tpu_torch.ops.camera import orbit_camera
from volumetricrenderer_tpu_torch.utils import image as timage
from volumetricrenderer_tpu_torch.utils import video as tvideo

torch.set_num_threads(1)

FRAME_KEYS = {"frame", "seconds", "plan_seconds", "fps", "mrays_per_s",
              "ts"}


def read_png(path):
    """Decode the first frame of an 8-bit PNG or APNG written by
    utils/image.py or utils/video.py (one IDAT, filter type 0 on every
    row) to a (H, W, C) uint8 array."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks.setdefault(tag, data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8) \
        .reshape(h, 1 + w * c)
    assert depth == 8 and not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, c)


def _animate_both(out, args):
    """`animate` with the same arguments through both packages (the port on
    the CPU); returns the two output directories."""
    jdir, tdir = out / "jax", out / "torch"
    assert jcli.main(["animate", *args, "--out-dir", str(jdir)]) == 0
    assert tcli.main(["animate", *args, "--out-dir", str(tdir),
                      "--device", "cpu"]) == 0
    return jdir, tdir


def _metrics(d):
    return [json.loads(line) for line in open(d / "metrics.jsonl")]


def _assert_frames_close(jdir, tdir, n):
    for i in range(n):
        want = read_png(jdir / f"frame_{i:05d}.png").astype(np.int32)
        got = read_png(tdir / f"frame_{i:05d}.png").astype(np.int32)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, i
    assert not (tdir / f"frame_{n:05d}.png").exists()


@pytest.fixture(scope="module")
def orbit_config1(tmp_path_factory):
    """config1 at 8^3, 32x24, four orbit frames, with --video, both
    packages."""
    out = tmp_path_factory.mktemp("orbit")
    return _animate_both(out, ["--preset", "config1", "--volume-size", "8",
                               "--width", "32", "--height", "24",
                               "--frames", "4", "--orbit",
                               "--video", "anim.apng"])


def test_animate_orbit_matches_jax(orbit_config1):
    jdir, tdir = orbit_config1
    _assert_frames_close(jdir, tdir, 4)
    # the same base dims on every frame: the JAX plans' and the port's
    jplans, _ = jcli.animation_plans(
        [jorbit(2 * np.pi * i / 4, width=32, height=24) for i in range(4)],
        (8, 8, 8), JRenderConfig(quadrature="sliced"))
    dims = tcli.animation_base_dims(
        [orbit_camera(2 * np.pi * i / 4, width=32, height=24)
         for i in range(4)], (8, 8, 8), RenderConfig(quadrature="sliced"))
    assert {p.base_shape for p in jplans} == {dims}
    assert _metrics(tdir)[-1]["base_dims"] == list(dims)
    # --video: the APNG's first frame is frame 0
    assert np.array_equal(read_png(tdir / "anim.apng"),
                          read_png(tdir / "frame_00000.png"))


def test_animate_metrics_keys(orbit_config1):
    _, tdir = orbit_config1
    lines = _metrics(tdir)
    frames = [m for m in lines if "frame" in m]
    assert [m["frame"] for m in frames] == [0, 1, 2, 3]
    assert all(set(m) == FRAME_KEYS for m in frames)
    assert all(m["seconds"] > 0 and m["fps"] > 0 and m["mrays_per_s"] > 0
               and 0 <= m["plan_seconds"] <= m["seconds"] for m in frames)
    # n_compiles counts jit executables: the port writes the base dims once
    rest = [m for m in lines if "frame" not in m]
    assert len(rest) == 1 and set(rest[0]) == {"base_dims", "ts"}
    assert not any("n_compiles" in m for m in lines)


def test_animate_config4_shadows_matches_jax(tmp_path):
    jdir, tdir = _animate_both(
        tmp_path, ["--preset", "config4", "--volume-size", "16", "--width",
                   "48", "--height", "32", "--frames", "3", "--orbit"])
    _assert_frames_close(jdir, tdir, 3)
    assert len([m for m in _metrics(tdir) if "frame" in m]) == 3


def test_animate_reference_matches_jax(tmp_path):
    """The reference preset (quadrature "fixed") marches per ray in every
    frame, plans nothing and writes no base dims."""
    jdir, tdir = _animate_both(
        tmp_path, ["--preset", "reference", "--volume-size", "8", "--width",
                   "32", "--height", "24", "--frames", "2"])
    _assert_frames_close(jdir, tdir, 2)
    lines = _metrics(tdir)
    assert all("frame" in m for m in lines) and len(lines) == 2


# --- the writers ----------------------------------------------------------


def _seeded_frames(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape", [(9, 7, 4), (6, 5, 3), (5, 4)])
def test_write_apng_is_byte_equal_to_jax(tmp_path, shape):
    frames = _seeded_frames(shape, 3)
    jvideo.write_apng(str(tmp_path / "j.apng"), frames, fps=10)
    tvideo.write_apng(str(tmp_path / "t.apng"), frames, fps=10)
    assert (tmp_path / "t.apng").read_bytes() == \
        (tmp_path / "j.apng").read_bytes()
    # torch tensors give the same file
    tvideo.write_apng(str(tmp_path / "tt.apng"),
                      [torch.from_numpy(f) for f in frames], fps=10)
    assert (tmp_path / "tt.apng").read_bytes() == \
        (tmp_path / "j.apng").read_bytes()


def test_write_gif_is_byte_equal_to_jax(tmp_path):
    """Pillow's GIF where Pillow is installed; APNG bytes under the .gif
    name otherwise, in both packages."""
    frames = _seeded_frames((8, 6, 3), 4, seed=1)
    jvideo.write_gif(str(tmp_path / "j.gif"), frames, fps=10)
    tvideo.write_gif(str(tmp_path / "t.gif"), frames, fps=10)
    data = (tmp_path / "t.gif").read_bytes()
    assert data == (tmp_path / "j.gif").read_bytes()
    try:
        import PIL  # noqa: F401
        assert data[:6] == b"GIF89a"
    except ImportError:
        assert data[:8] == b"\x89PNG\r\n\x1a\n"


def test_write_html_viewer_is_byte_equal_to_jax(tmp_path):
    frames = _seeded_frames((5, 5, 3), 2, seed=2)
    jvideo.write_html_viewer(str(tmp_path / "j.html"), frames, fps=5)
    tvideo.write_html_viewer(str(tmp_path / "t.html"), frames, fps=5)
    html = (tmp_path / "t.html").read_text()
    assert html == (tmp_path / "j.html").read_text()
    assert html.count("data:image/png;base64,") == 2


@pytest.mark.parametrize("ext", ["apng", "gif", "html", "png"])
def test_write_video_dispatch_matches_jax(tmp_path, ext):
    frames = _seeded_frames((4, 6, 4), 2, seed=3)
    jvideo.write_video(str(tmp_path / f"j.{ext}"), frames, fps=12)
    tvideo.write_video(str(tmp_path / f"t.{ext}"), frames, fps=12)
    assert (tmp_path / f"t.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()


def test_norm_frames_refuses_mixed_shapes():
    with pytest.raises(ValueError, match="disagree in shape"):
        tvideo._norm_frames([np.zeros((4, 4, 3)), np.zeros((4, 5, 3))])


@pytest.mark.parametrize("shape,dtype", [((6, 5, 4), np.float32),
                                         ((6, 5, 3), np.uint8),
                                         ((6, 5), np.float32)])
def test_write_ppm_is_byte_equal_to_jax(tmp_path, shape, dtype):
    img = _seeded_frames(shape, 1, seed=4)[0]
    if dtype == np.uint8:
        img = (img * 255).astype(np.uint8)
    jimage.write_ppm(str(tmp_path / "j.ppm"), img)
    timage.write_ppm(str(tmp_path / "t.ppm"), torch.from_numpy(img))
    data = (tmp_path / "t.ppm").read_bytes()
    assert data == (tmp_path / "j.ppm").read_bytes()
    assert data.startswith(b"P6\n5 6\n255\n")


# --- AsyncFrameWriter (tests/test_utils.py's two tests on the port) -------


def test_async_frame_writer(tmp_path):
    """Frames written on worker threads, joined at context exit; content
    identical to the synchronous writer (and to the JAX writer's)."""
    frames = _seeded_frames((8, 8, 4), 5)
    with timage.AsyncFrameWriter(workers=2) as w:
        for i, f in enumerate(frames):
            w.write(str(tmp_path / f"a_{i}.png"), torch.from_numpy(f))
    for i, f in enumerate(frames):
        timage.write_png(str(tmp_path / f"s_{i}.png"), f)
        jimage.write_png(str(tmp_path / f"j_{i}.png"), f)
        a = (tmp_path / f"a_{i}.png").read_bytes()
        s = (tmp_path / f"s_{i}.png").read_bytes()
        assert a == s == (tmp_path / f"j_{i}.png").read_bytes()
        assert len(a) > 0


def test_async_frame_writer_raises_on_failure(tmp_path):
    with pytest.raises(OSError):
        with timage.AsyncFrameWriter() as w:
            w.write(str(tmp_path / "no_such_dir" / "x.png"),
                    np.zeros((4, 4, 3), np.float32))


def test_async_frame_writer_keeps_the_body_error(tmp_path):
    """A failure inside the with-body is the error that propagates; a
    pending write that also failed is logged, not raised over it."""
    with pytest.raises(KeyError):
        with timage.AsyncFrameWriter() as w:
            w.write(str(tmp_path / "no_such_dir" / "x.png"),
                    np.zeros((4, 4, 3), np.float32))
            raise KeyError("render failed")
