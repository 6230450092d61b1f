"""Test/demo asset loading.

The reference keeps its ground-truth assets in ``images/`` (lenna.png,
frame10/11.png, flow10.flo, under_exposure.jpg); we vendor the same set
under ``assets/`` at the repo root so every test is runnable offline.

Images load through cv2 or PIL when either is installed. Without them,
8-bit non-interlaced PNGs (every PNG asset) decode with the numpy+zlib
reader below; other formats then need cv2 or PIL.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS_DIR = os.path.join(_REPO_ROOT, "assets")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def asset_path(name: str) -> str:
    return os.path.join(ASSETS_DIR, name)


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter (PNG spec section 9)."""
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prev
    out = row.astype(np.int32)
    up = prev.astype(np.int32)
    if ftype == 1:
        for i in range(bpp, len(out)):
            out[i] = (out[i] + out[i - bpp]) & 255
        return out.astype(np.uint8)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 255
        elif ftype == 4:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return out.astype(np.uint8)


def decode_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to uint8 [H, W, C] (C = 1-4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs decode without "
            f"cv2 or PIL (depth {depth}, color type {ctype}, interlace {interlace})"
        )
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    return out.reshape(h, w, bpp)


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma in cv2.cvtColor(RGB2GRAY)'s 15-bit fixed point. (cv2's
    imread(GRAYSCALE) converts inside libpng and can differ by a level,
    more on PNGs that carry an sRGB chunk.)"""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


def load_image(name: str) -> np.ndarray:
    """Load an asset as an RGB uint8 array of shape [H, W, 3]."""
    path = asset_path(name) if not os.path.isabs(name) else name
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return bgr[..., ::-1].copy()
    try:
        from PIL import Image
    except ImportError:
        img = decode_png(path)
        if img.shape[-1] < 3:  # gray (+ alpha)
            return np.repeat(img[..., :1], 3, axis=-1)
        return img[..., :3].copy()
    return np.asarray(Image.open(path).convert("RGB"))


def load_gray(name: str) -> np.ndarray:
    """Load an asset as a grayscale uint8 array [H, W] (BT.601, like cv2)."""
    path = asset_path(name) if not os.path.isabs(name) else name
    try:
        import cv2
    except ImportError:
        return _rgb_to_gray(load_image(path))
    g = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if g is None:
        raise FileNotFoundError(path)
    return g
