"""Image output (port of volumetricrenderer_tpu/utils/image.py): a
pure-stdlib PNG encoder (zlib deflate, filter 0), an uncompressed PPM
writer, and AsyncFrameWriter, which writes PNGs on worker threads so a
render loop never waits on the disk. Accepts numpy arrays and torch tensors
on any device."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

__all__ = ["to_uint8", "encode_png", "write_png", "write_ppm",
           "AsyncFrameWriter"]


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    """float image in [0,1] (H, W, {1,3,4}) -> uint8, with clamping."""
    arr = _host(img).astype(np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(img, level: int = 6) -> bytes:
    """Encode an image to PNG bytes. img: uint8 or float (H, W) /
    (H, W, C) with C in {1, 3, 4}."""
    arr = _host(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, level))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path, img):
    """Write an image to PNG. img: uint8 or float (H, W) / (H, W, C) with
    C in {1, 3, 4}."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def write_ppm(path, img):
    """Fast uncompressed PPM (P6) writer for high-frame-rate dumps."""
    arr = _host(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 4:
        arr = arr[:, :, :3]
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())
    return path


class AsyncFrameWriter:
    """Pipelined frame output: PNG encodes and writes run on a small thread
    pool so the render loop never blocks on the disk (zlib and file IO
    release the GIL, so threads overlap). Use as a context manager; exit
    joins all pending writes and re-raises the first failure."""

    def __init__(self, workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="frame-writer")
        self._pending = []

    def write(self, path, img):
        """Queue one PNG write. A device tensor is copied to the host here,
        so the queued frame is the one given."""
        arr = _host(img)
        self._pending.append(self._pool.submit(write_png, path, arr))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        errs = [f.exception() for f in self._pending]
        self._pool.shutdown(wait=True)
        self._pending.clear()
        # A failure in the with-body (a render error mid-animation) is the
        # primary error: log the writer's failures and let the body's
        # exception propagate; raise them only on a clean exit.
        for e in errs:
            if e is not None:
                if exc_val is not None:
                    from .metrics import get_logger
                    get_logger().error(
                        "pending frame write also failed: %s: %s",
                        type(e).__name__, e)
                    return False
                raise e
        return False
