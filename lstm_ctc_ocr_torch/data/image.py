"""Image loading and eval preprocessing with the standard library and numpy.

Counterpart of ``load_image``/``preprocess_image`` in the JAX package's
``engine/test.py:47-72``, which read with OpenCV. The port does not depend
on OpenCV, Pillow or PyYAML, so it carries:

* a PNG decoder on ``zlib``: 8-bit gray, gray+alpha, RGB and RGBA,
  non-interlaced, all five row filters;
* the grayscale conversion that ``cv2.imread(path, IMREAD_GRAYSCALE)`` does
  for a color PNG — libpng's ``png_set_rgb_to_gray`` with OpenCV's
  (0.299, 0.587) weights, in libpng's 15-bit fixed point with truncation;
* the bilinear resize of ``cv2.resize(img, (w, h))`` (INTER_LINEAR, half-pixel
  centres) on uint8, in OpenCV's fixed point: 11-bit coefficients, a
  horizontal pass into 2048-scaled ints, and the vertical pass's rounding of
  OpenCV's vectorized 8-bit path.

``tests/test_torch_image.py`` holds all three bit-exact to OpenCV on every
tracked val PNG.
"""

from __future__ import annotations

import struct
import zlib
from typing import Callable, Tuple

import numpy as np

_PNG_SIG = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG color type -> samples/pixel


def _chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise IOError('not a PNG file')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IEND':
            return
    raise IOError('truncated PNG')


def _header(ihdr: bytes):
    w, h, depth, ctype, _, _, interlace = struct.unpack('>IIBBBBB', ihdr)
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise IOError('unsupported PNG: bit depth {}, color type {}, '
                      'interlace {}'.format(depth, ctype, interlace))
    return w, h, ctype


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk, without decoding pixels."""
    with open(path, 'rb') as f:
        head = f.read(33)
    if head[:8] != _PNG_SIG or head[12:16] != b'IHDR':
        raise IOError('not a PNG file: {}'.format(path))
    return struct.unpack('>II', head[16:24])


def _unfilter_row(ftype: int, cur: bytearray, prev: bytearray, bpp: int):
    """Undo one row's PNG filter in place (``prev`` is the decoded row above)."""
    n = len(cur)
    if ftype == 0:
        return
    if ftype == 1:                                  # Sub
        for i in range(bpp, n):
            cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
    elif ftype == 2:                                # Up
        up = (np.frombuffer(bytes(cur), np.uint8)
              + np.frombuffer(bytes(prev), np.uint8))
        cur[:] = up.tobytes()
    elif ftype == 3:                                # Average
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:                                # Paeth
        for i in range(bpp):
            cur[i] = (cur[i] + prev[i]) & 0xFF     # a = c = 0: predicts b
        for i in range(bpp, n):
            a = cur[i - bpp]
            b = prev[i]
            c = prev[i - bpp]
            pa = b - c if b > c else c - b
            pb = a - c if a > c else c - a
            pc = a + b - c - c
            if pc < 0:
                pc = -pc
            if pa <= pb and pa <= pc:
                cur[i] = (cur[i] + a) & 0xFF
            elif pb <= pc:
                cur[i] = (cur[i] + b) & 0xFF
            else:
                cur[i] = (cur[i] + c) & 0xFF
    else:
        raise IOError('bad PNG row filter {}'.format(ftype))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 ``[H, W, C]`` with C the file's samples per pixel."""
    ihdr = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            ihdr = body
        elif kind == b'IDAT':
            idat.append(body)
    if ihdr is None or not idat:
        raise IOError('PNG without IHDR/IDAT')
    w, h, ctype = _header(ihdr)
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b''.join(idat))
    if len(raw) != h * (stride + 1):
        raise IOError('PNG data size {} does not match {}x{}x{}'
                      .format(len(raw), w, h, bpp))
    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        row = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        _unfilter_row(raw[y * (stride + 1)], row, prev, bpp)
        out[y * stride:(y + 1) * stride] = row
        prev = row
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)


def to_gray(pixels: np.ndarray) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[H, W]`` uint8 as ``cv2.imread(.., 0)`` gives.

    Color goes through libpng's rgb-to-gray with OpenCV's (0.299, 0.587)
    request, which libpng stores as 15-bit coefficients
    ``floor(0.299e5 * 32768 / 1e5)`` etc. and applies with truncation;
    alpha is dropped."""
    c = pixels.shape[2]
    if c <= 2:
        return pixels[..., 0].copy()
    rgb = pixels[..., :3].astype(np.uint32)
    gray = (rgb[..., 0] * 9797 + rgb[..., 1] * 19234 + rgb[..., 2] * 3737) >> 15
    return gray.astype(np.uint8)


def load_image(path: str) -> np.ndarray:
    """Grayscale uint8 ``[H, W]`` of a PNG file (``cv2.imread(path, 0)``)."""
    with open(path, 'rb') as f:
        data = f.read()
    return to_gray(decode_png(data))


def _linear_taps(src: int, dst: int):
    """Source index pairs and 11-bit weights of OpenCV's INTER_LINEAR."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    low = s < 0
    f[low], s[low] = 0.0, 0
    high = s >= src - 1
    f[high], s[high] = 0.0, src - 1
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` for a uint8 ``[H, W]`` image."""
    src = img.astype(np.int64)
    x0, x1, a0, a1 = _linear_taps(img.shape[1], width)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], height)
    rows = src[:, x0] * a0 + src[:, x1] * a1          # [H, width], x2048
    s0 = (rows[y0] >> 4) * b0[:, None] >> 16
    s1 = (rows[y1] >> 4) * b1[:, None] >> 16
    return np.clip((s0 + s1 + 2) >> 2, 0, 255).astype(np.uint8)


def preprocess_image(img: np.ndarray, *, img_height: int, num_features: int,
                     pool_scale: int, offset_time_step: int,
                     pick: Callable[[int], int]):
    """The eval preprocessing contract: resize to ``img_height`` (new width
    ``int(img_height / h * w)``), right-pad the width to ``pick(w)``, /255,
    width-major features. Returns ([W_pad, num_features] float32,
    time_step = w // pool_scale + offset_time_step)."""
    h, w = img.shape[:2]
    if h != img_height:
        w = int(img_height / h * w)
        img = resize_linear(img, w, img_height)
    out = np.zeros((pick(w), num_features), np.float32)
    out[:w] = (img.astype(np.float32) / 255.0).swapaxes(0, 1).reshape(w, -1)
    return out, w // pool_scale + offset_time_step
