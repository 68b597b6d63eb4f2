"""Animation output (port of volumetricrenderer_tpu/utils/video.py): one
file for a whole frame sequence, with no ffmpeg and no network.

Formats:
  * APNG: pure-stdlib animated PNG built from the same chunk writer as
    utils/image.py (acTL/fcTL/fdAT per the PNG spec); plays in every
    browser.
  * GIF: through Pillow when it is installed, palettized; APNG bytes under
    the given name otherwise.
  * HTML viewer: a single self-contained file with base64-embedded PNG
    frames and a JS scrubber/play loop (works from file:// and inside
    Jupyter via IFrame).

Frames may be numpy arrays or torch tensors on any device.
"""
from __future__ import annotations

import base64
import struct
import zlib

import numpy as np

from .image import _host, _png_chunk, to_uint8

__all__ = ["write_apng", "write_gif", "write_html_viewer", "write_video"]


def _norm_frames(frames):
    out = []
    for f in frames:
        a = _host(f)
        if a.dtype != np.uint8:
            a = to_uint8(a)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.shape[2] == 1:
            a = np.repeat(a, 3, axis=2)
        out.append(a)
    shapes = {a.shape for a in out}
    if len(shapes) != 1:
        raise ValueError(f"frames disagree in shape: {shapes}")
    return out


def write_apng(path, frames, fps: float = 24.0):
    """Animated PNG (pure stdlib). frames: iterable of (H, W[,C]) uint8 or
    float images, C in {1, 3, 4}."""
    frames = _norm_frames(frames)
    h, w, c = frames[0].shape
    color_type = {3: 2, 4: 6}[c]
    delay_den = max(int(round(fps)), 1)

    def raw(a):
        return zlib.compress(
            b"".join(b"\x00" + a[row].tobytes() for row in range(h)), 6)

    chunks = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              color_type, 0, 0, 0)),
              _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, a in enumerate(frames):
        chunks.append(_png_chunk(
            b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1,
                                 delay_den, 0, 0)))
        seq += 1
        payload = raw(a)
        if i == 0:
            chunks.append(_png_chunk(b"IDAT", payload))
        else:
            chunks.append(_png_chunk(b"fdAT",
                                     struct.pack(">I", seq) + payload))
            seq += 1
    chunks.append(_png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks))
    return path


def write_gif(path, frames, fps: float = 24.0):
    """GIF via Pillow (palettized). Falls back to APNG when Pillow is
    missing (same call signature; the extension is kept as given)."""
    frames = _norm_frames(frames)
    try:
        from PIL import Image
    except ImportError:
        return write_apng(path, frames, fps)
    imgs = [Image.fromarray(a[:, :, :3]) for a in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return path


def write_html_viewer(path, frames, fps: float = 24.0, title="frames"):
    """Self-contained HTML viewer: frames embedded as base64 PNGs with a
    scrubber + play/pause — the notebook-viewer analogue of the
    reference's ImGui viewport window."""
    from .image import write_png

    import os
    import tempfile

    frames = _norm_frames(frames)
    uris = []
    for a in frames:
        with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as t:
            write_png(t.name, a)
            with open(t.name, "rb") as fh:
                uris.append("data:image/png;base64,"
                            + base64.b64encode(fh.read()).decode())
            os.unlink(t.name)
    html = f"""<!doctype html><meta charset="utf-8"><title>{title}</title>
<style>body{{background:#111;color:#ddd;font:14px sans-serif;
text-align:center}}img{{image-rendering:pixelated;max-width:95vw}}</style>
<h3>{title}</h3><img id=v><br>
<input id=s type=range min=0 max={len(frames) - 1} value=0 style="width:60%">
<button id=p>pause</button><span id=n></span>
<script>
const F={uris!r};let i=0,run=true;
const v=document.getElementById('v'),s=document.getElementById('s'),
n=document.getElementById('n'),p=document.getElementById('p');
function show(k){{i=k;v.src=F[k];s.value=k;n.textContent=` ${{k + 1}}/${{F.length}}`;}}
setInterval(()=>{{if(run)show((i+1)%F.length)}},{int(1000 / fps)});
s.oninput=e=>{{run=false;p.textContent='play';show(+e.target.value)}};
p.onclick=()=>{{run=!run;p.textContent=run?'pause':'play'}};
show(0);
</script>"""
    with open(path, "w") as f:
        f.write(html)
    return path


def write_video(path, frames, fps: float = 24.0):
    """Dispatch by extension: .apng/.png -> APNG, .gif -> GIF,
    .html -> viewer."""
    lower = str(path).lower()
    if lower.endswith(".gif"):
        return write_gif(path, frames, fps)
    if lower.endswith(".html"):
        return write_html_viewer(path, frames, fps)
    return write_apng(path, frames, fps)
