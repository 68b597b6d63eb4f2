"""Image output (port of to_uint8 / encode_png / write_png from
volumetricrenderer_tpu/utils/image.py): a pure-stdlib PNG encoder (zlib
deflate, filter 0). Accepts numpy arrays and torch tensors on any device."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

__all__ = ["to_uint8", "encode_png", "write_png"]


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
